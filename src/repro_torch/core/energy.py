"""Energy estimation models.

1. ``PowerTutorModel`` — the paper's modified PowerTutor model (Table 2,
   HTC Dream) with the published coefficients: the phone's side of every
   offload decision and of the ``ExecutionResult`` energy breakdown.

2. ``GpuEnergyModel`` — the fleet adaptation: the same independent-linear-
   component form (PowerTutor reports <=6.27% error for that assumption),
   with card, HBM, link and host components.  The card's peak is the H100
   SXM's 700 W power limit; the idle floor and the per-GB/s and host
   coefficients are modeled values, not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


# --------------------------------------------------------------------------- #
# Paper model (Table 2) — coefficients in mW
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PowerTutorCoeffs:
    beta_uh: float = 4.32          # per % util at high freq
    beta_ul: float = 3.42          # per % util at low freq
    beta_cpu_on: float = 121.46
    beta_wifi_l: float = 20.0
    beta_wifi_h: float = 710.0
    beta_3g_idle: float = 10.0
    beta_3g_fach: float = 401.0    # CELL_SHARED
    beta_3g_dch: float = 570.0     # CELL_DEDICATED
    beta_br: float = 2.40          # per brightness unit (0-255)
    wifi_transmit: float = 1000.0  # transmit-burst power


@dataclasses.dataclass
class PhoneState:
    cpu_util: float = 0.0          # 0-100
    freq_high: bool = True
    cpu_on: bool = True
    brightness: int = 150
    wifi: str = "off"              # off | low | high | transmit
    cell: str = "off"              # off | idle | fach | dch


class PowerTutorModel:
    def __init__(self, coeffs: PowerTutorCoeffs = PowerTutorCoeffs()):
        self.c = coeffs

    def power_mw(self, st: PhoneState) -> Dict[str, float]:
        """Per-component power (mW) — the paper's independent-sum model."""
        c = self.c
        comps = {}
        if st.cpu_on:
            beta = c.beta_uh if st.freq_high else c.beta_ul
            comps["cpu"] = beta * st.cpu_util + c.beta_cpu_on
        else:
            comps["cpu"] = 0.0
        comps["screen"] = c.beta_br * st.brightness
        comps["wifi"] = {"off": 0.0, "low": c.beta_wifi_l,
                         "high": c.beta_wifi_h,
                         "transmit": c.wifi_transmit}[st.wifi]
        comps["3g"] = {"off": 0.0, "idle": c.beta_3g_idle,
                       "fach": c.beta_3g_fach, "dch": c.beta_3g_dch}[st.cell]
        return comps

    def energy_j(self, st: PhoneState, seconds: float) -> Dict[str, float]:
        return {k: v * 1e-3 * seconds for k, v in self.power_mw(st).items()}

    def local_exec_energy(self, seconds: float) -> Dict[str, float]:
        """Phone computing at 100% util, screen on (paper §7.3)."""
        return self.energy_j(PhoneState(cpu_util=100.0), seconds)

    def offload_energy(self, idle_seconds: float, tx_seconds: float,
                       link: str) -> Dict[str, float]:
        """Phone waiting (screen on, CPU lightly loaded) + radio transfer.
        A link other than WiFi or 3G (the fleet's NVLink) bills no radio."""
        wait = PhoneState(cpu_util=5.0,
                          wifi="low" if link.startswith("wifi") else "off",
                          cell="idle" if link == "3g" else "off")
        e = self.energy_j(wait, idle_seconds)
        tx = PhoneState(cpu_util=10.0,
                        wifi="transmit" if link.startswith("wifi") else "off",
                        cell="dch" if link == "3g" else "off")
        for k, v in self.energy_j(tx, tx_seconds).items():
            e[k] = e.get(k, 0.0) + v
        return e


# --------------------------------------------------------------------------- #
# Fleet adaptation
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GpuCoeffs:
    chip_idle_w: float = 70.0          # modeled: 10% of the limit
    chip_peak_w: float = 700.0         # H100 SXM power limit
    hbm_w_per_gbps: float = 0.05       # W per GB/s streamed (modeled)
    link_w_per_gbps: float = 0.04      # card-to-card traffic (modeled)
    host_w: float = 350.0              # per-host static (modeled)


class GpuEnergyModel:
    """Independent-component linear model for a GPU venue."""

    def __init__(self, coeffs: GpuCoeffs = GpuCoeffs()):
        self.c = coeffs

    def energy_j(self, *, chips: int, seconds: float, util: float,
                 hbm_bytes: float = 0.0, link_bytes: float = 0.0,
                 hosts: int = 1) -> Dict[str, float]:
        c = self.c
        chip_p = c.chip_idle_w + (c.chip_peak_w - c.chip_idle_w) * util
        return {
            "chips": chips * chip_p * seconds,
            "hbm": c.hbm_w_per_gbps * (hbm_bytes / 1e9),
            "link": c.link_w_per_gbps * (link_bytes / 1e9),
            "host": hosts * c.host_w * seconds,
        }

    def total_j(self, **kw) -> float:
        return sum(self.energy_j(**kw).values())

    def busy_j(self, chips: int, seconds: float, util: float = 1.0) -> float:
        """Chips-aware busy energy of one venue dispatch: a clone type's
        chip count scales its bill."""
        return self.total_j(chips=chips, seconds=seconds, util=util)
