"""The three ThinkAir profilers (paper §6): device, program, network.

Intent-listener-style updates are modeled as explicit ``observe_*`` hooks;
everything keeps EMA histories exactly as the Execution Controller needs for
its decisions (paper §4.3: first encounter -> environment only; afterwards ->
history + environment).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, Optional, Tuple

_EMA = 0.35


def _ema(old: Optional[float], new: float, alpha: float = _EMA) -> float:
    return new if old is None else (1 - alpha) * old + alpha * new


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class DeviceStatus:
    battery_level: float = 1.0
    cpu_load: float = 0.0
    connectivity: str = "wifi"     # wifi | cell | none
    conn_subtype: str = "wifi-local"


class DeviceProfiler:
    """Tracks environmental device state (paper §6.1, intent-based)."""

    def __init__(self):
        self.status = DeviceStatus()

    def observe(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self.status, k, v)

    def connection_quality(self) -> str:
        """Coarse env signal used for first-encounter decisions (§4.3)."""
        if self.status.connectivity == "none":
            return "none"
        if self.status.conn_subtype in ("wifi-local", "wifi-internet",
                                        "nvlink"):
            return "good"
        return "poor"


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MethodRecord:
    """History for one (method, input-size bucket, venue)."""
    exec_time: Optional[float] = None     # EMA seconds
    energy: Optional[float] = None        # EMA joules (client-side)
    tx_bytes: Optional[float] = None
    rx_bytes: Optional[float] = None
    invocations: int = 0
    flops: Optional[float] = None         # from cost_analysis when available


def size_bucket(n: float) -> int:
    """Log-scale input-size bucketing so history generalizes across inputs."""
    if n <= 0:
        return 0
    return int(round(math.log2(max(n, 1)) * 2))


class ProgramProfiler:
    """Per-method execution history (paper §6.2)."""

    def __init__(self):
        self.records: Dict[Tuple[str, int, str], MethodRecord] = \
            defaultdict(MethodRecord)

    def record(self, method: str, size_key: int, venue: str, *,
               exec_time: float, energy: float = 0.0, tx: float = 0.0,
               rx: float = 0.0, flops: Optional[float] = None) -> None:
        r = self.records[(method, size_key, venue)]
        r.exec_time = _ema(r.exec_time, exec_time)
        r.energy = _ema(r.energy, energy)
        r.tx_bytes = _ema(r.tx_bytes, tx)
        r.rx_bytes = _ema(r.rx_bytes, rx)
        if flops is not None:
            r.flops = flops
        r.invocations += 1

    def lookup(self, method: str, size_key: int,
               venue: str) -> Optional[MethodRecord]:
        r = self.records.get((method, size_key, venue))
        return r if r and r.invocations > 0 else None

    def nearest(self, method: str, size_key: int,
                venue: str) -> Optional[MethodRecord]:
        """Closest size bucket with history (enables BIV interpolation)."""
        best, best_d = None, None
        for (m, s, v), r in self.records.items():
            if m != method or v != venue or r.invocations == 0:
                continue
            d = abs(s - size_key)
            if best_d is None or d < best_d:
                best, best_d = r, d
        return best

    def known(self, method: str) -> bool:
        return any(m == method and r.invocations > 0
                   for (m, _, _), r in self.records.items())


# --------------------------------------------------------------------------- #
class NetworkProfiler:
    """Perceived bandwidth / RTT per link (paper §6.3).

    Combines "intents" (profile switches) with instrumentation (observed
    transfer timings update the perceived bandwidth EMA, which includes
    serialization overhead exactly as the paper prescribes).
    """

    def __init__(self, link_name: str = "wifi-local"):
        from repro_torch.core.venues import LINKS
        self._links = dict(LINKS)
        self.active = link_name
        self.perceived_bw: Dict[str, float] = {}
        self.perceived_rtt: Dict[str, float] = {}
        self.tx_packets = 0
        self.rx_packets = 0

    def switch(self, link_name: str) -> None:     # "intent" hook
        self.active = link_name
        # paper: network state change triggers RTT re-estimation
        self.perceived_rtt.pop(link_name, None)

    def observe_transfer(self, nbytes: int, seconds: float) -> None:
        if seconds <= 0:
            return
        bw = nbytes / seconds
        self.perceived_bw[self.active] = _ema(
            self.perceived_bw.get(self.active), bw)
        self.tx_packets += max(1, nbytes // 1400)

    def observe_rtt(self, seconds: float) -> None:  # app-level ping (§5.1)
        self.perceived_rtt[self.active] = _ema(
            self.perceived_rtt.get(self.active), seconds)

    def bandwidth(self) -> float:
        return self.perceived_bw.get(self.active,
                                     self._links[self.active].bandwidth)

    def rtt(self) -> float:
        return self.perceived_rtt.get(self.active,
                                      self._links[self.active].rtt)

    def transfer_time(self, nbytes: int) -> float:
        return self.rtt() + nbytes / self.bandwidth()
