"""Shared measurement harness for the paper-reproduction benchmarks.

Methodology mirrors §7: each point is the average of ``reps`` runs (the
paper uses 20 with 30 s pauses; the default is lower for CI practicality
— ``REPRO_FULL=1`` restores paper-grade repetitions).  Times are
venue-model scenario seconds (measured wall clock on the controller's
device after a synchronise x venue ratio + modeled transfer and
provisioning); energies come from the paper's PowerTutor coefficients.
Every controller runs on ``device``: the card unless the caller names
another.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.apps.workloads import Device
from repro_torch.core import ExecutionController, Policy

REPS = 5 if os.environ.get("REPRO_FULL") else 2
SCENARIOS = ("phone", "wifi-local", "wifi-internet", "3g")


def controller_for(scenario: str, provision: int = 8,
                   device: Device = None) -> ExecutionController:
    link = "wifi-local" if scenario == "phone" else scenario
    ec = ExecutionController(policy=Policy.EXEC_TIME, link=link,
                             device=device)
    ec.pool.provision("main", provision)
    return ec


def measure(ec: ExecutionController, rm, *args, scenario: str,
            n_clones: int = 1, reps: int = None) -> Dict[str, float]:
    """Average scenario time/energy over reps."""
    reps = reps or REPS
    force = "local" if scenario == "phone" else "remote"
    t = e = overhead = 0.0
    comps: Dict[str, float] = {}
    res = None
    for _ in range(reps):
        res = ec.execute(rm, *args, force=force, n_clones=n_clones)
        t += res.time_s
        e += res.energy_j
        overhead += res.overhead_s
        for k, v in res.energy.items():
            comps[k] = comps.get(k, 0.0) + v
    out = {"time_s": t / reps, "energy_j": e / reps,
           "overhead_s": overhead / reps,
           "tx": res.tx_bytes, "rx": res.rx_bytes,
           "n_clones": res.n_clones}
    out["energy_components"] = {k: v / reps for k, v in comps.items()}
    return out


def find_biv(rm, sizes, link: str, device: Device = None) -> Optional[int]:
    """Boundary input value: smallest size where offloading pays (Table 3)."""
    ec = ExecutionController(policy=Policy.EXEC_TIME, link=link,
                             device=device)
    for n in sizes:
        local = ec.execute(rm, n, force="local")
        remote = ec.execute(rm, n, force="remote")
        if remote.time_s < local.time_s:
            return n
    return None
