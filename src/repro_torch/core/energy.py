"""Fleet energy model for GPU venues.

The independent-linear-component form of the paper's PowerTutor model
(which reports <=6.27% error for that assumption), with card, HBM, link and
host components.  The card's peak is the H100 SXM's 700 W power limit;
the idle floor and the per-GB/s and host coefficients are modeled values,
not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


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
