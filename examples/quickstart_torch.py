"""Quickstart on the PyTorch port: mark a method @remote, let ThinkAir
place it.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(runs on the card unless --device names another device)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch                                                 # noqa: E402

from repro_torch.core import (ExecutionController, Policy,   # noqa: E402
                              remote, set_default_controller)
from repro_torch.models.context import resolve_device        # noqa: E402


def run(device=None) -> None:
    dev = resolve_device(device)
    # 1. Create a controller (the phone-side Execution Controller) and make
    #    it ambient, like the paper's per-thread controller.
    ec = ExecutionController(policy=Policy.EXEC_TIME_AND_ENERGY,
                             link="wifi-local", device=dev)
    set_default_controller(ec)

    # 2. Annotate offloadable methods (the paper's @Remote + Remoteable
    #    class).
    @remote(size=lambda n: n)
    def heavy_compute(n):
        """Compute-bound: candidate for offloading."""
        x = torch.eye(128, device=dev) * 0.99
        acc = torch.ones((128, 128), device=dev)
        for _ in range(n * 100):
            acc = torch.tanh(acc @ x)
        return acc.sum()

    @remote(size=lambda x: x.numel())
    def light_compute(x):
        """Trivial: offloading would only pay the network tax."""
        return (x + 1).sum()

    try:
        print("policy:", ec.policy.value, "| link:", ec.network.active,
              "| device:", dev)
        print()
        # first encounters: environment-only decision; later: history-driven
        for i in range(3):
            r = ec.execute(heavy_compute.remoteable, 50)
            print(f"heavy_compute run {i}: offloaded={r.offloaded:d} "
                  f"venue={r.venue:8s} time={r.time_s:7.3f}s "
                  f"energy={r.energy_j:6.2f}J")
        for i in range(3):
            r = ec.execute(light_compute.remoteable,
                           torch.ones((8, 8), device=dev))
            print(f"light_compute run {i}: offloaded={r.offloaded:d} "
                  f"venue={r.venue:8s} time={r.time_s:7.3f}s "
                  f"energy={r.energy_j:6.2f}J")
        print()
        print("decisions:", ec.decisions)
        print("clone pool:", ec.pool.stats)
        # switching to a bad link flips the decision (paper §4.3)
        ec.set_link("3g")
        r = ec.execute(light_compute.remoteable,
                       torch.ones((8, 8), device=dev))
        print(f"after 3G switch: light_compute offloaded={r.offloaded}")
    finally:
        set_default_controller(None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
