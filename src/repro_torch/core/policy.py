"""Offloading policies (paper §4.3): None / ExecutionTime / Energy / Both.

Extended (ADR-004) into a *placement* scorer for the heterogeneous fleet:
``Prediction`` carries a $-cost alongside time and energy, and
``placement_key`` turns a policy into a total order over placement
candidates (clone-type tiers).  ``should_offload`` keeps the paper's exact
offload semantics; the fleet autoscaler ranks with ``placement_key``.
"""
from __future__ import annotations

import dataclasses
import enum


class Policy(enum.Enum):
    NONE = "none"
    EXEC_TIME = "exec_time"
    ENERGY = "energy"
    EXEC_TIME_AND_ENERGY = "exec_time_and_energy"


# Nominal service horizon (s): once placed, a work unit occupies its venue
# for about this long beyond the venue's availability latency.  The
# energy-delay ranking adds it to ``time_s`` so a warm-but-power-hungry
# tier does not degenerate to a free win (0 x anything == 0); rankings on
# fixed rates are otherwise horizon-invariant.
PLACEMENT_HORIZON_S = 60.0


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Predicted cost of one placement choice.

    ``cost_usd`` is the on-demand $ of the choice over the placement
    horizon (0 for the offload path, which compares phone vs cloud where
    the paper bills no per-request price)."""
    time_s: float
    energy_j: float
    cost_usd: float = 0.0


def should_offload(policy: Policy, local: Prediction,
                   remote: Prediction) -> bool:
    """Paper semantics: offload only if the policy's objective(s) improve."""
    if policy is Policy.NONE:
        return False
    if policy is Policy.EXEC_TIME:
        return remote.time_s < local.time_s
    if policy is Policy.ENERGY:
        return remote.energy_j < local.energy_j
    return (remote.time_s < local.time_s
            and remote.energy_j < local.energy_j)


def placement_key(policy: Policy, pred: Prediction) -> tuple:
    """Total order over fleet placement candidates (lower is better).

    The policy names the primary objective; the remaining quantities
    break ties, so the order is always total:

    - ``NONE`` — no offload objective exists, so placement ranks purely
      by $-cost (cheapest adequate tier wins), then time, then energy.
    - ``EXEC_TIME`` — provisioning latency first (a RUNNING tier beats a
      paused one beats a cold boot), then $, then energy.
    - ``ENERGY`` — energy rate first, then $, then time.
    - ``EXEC_TIME_AND_ENERGY`` — the energy-delay product (scale-free
      combination of both objectives) over the horizon-inclusive delay,
      $ tie-break.
    """
    if policy is Policy.NONE:
        return (pred.cost_usd, pred.time_s, pred.energy_j)
    if policy is Policy.EXEC_TIME:
        return (pred.time_s, pred.cost_usd, pred.energy_j)
    if policy is Policy.ENERGY:
        return (pred.energy_j, pred.cost_usd, pred.time_s)
    return ((pred.time_s + PLACEMENT_HORIZON_S) * pred.energy_j,
            pred.cost_usd, pred.time_s)
