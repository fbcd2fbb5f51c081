#!/usr/bin/env python3
"""Probe of the venue calibration on the CPU: how load and the calling
thread count move ``host_eff_flops`` and, through it, the parallel
offload test (``tests/test_torch_offload.py::
test_parallelization_reduces_time``).

    PYTHONPATH=src python3 tools/venue_calibration_probe.py \\
        [--threads 8] [--burners 0 32 48]

For each count of background processes (each a loop of 512 x 512
float32 products and tanh on the default torch threads), it calibrates
twice while they run, on ``--threads`` torch threads: as the port did
before (one chain of eight 512 x 512 products timed on the wall clock,
the caller's threads) and as ``venues.host_eff_flops`` does now (one
thread, the thread's CPU clock, best of ``CALIBRATION_REPS``).  Then,
with the background stopped, it runs the test's body (one torch thread,
8 RUNNING clones, best of three k = 1 and k = 4 executions) under each
figure and prints r1, r4 and whether k = 4 wins.
"""
import argparse
import subprocess
import sys
import time

BURN = ("import torch\nx = torch.randn(512, 512)\n"
        "while True:\n    x = torch.tanh(x @ x)\n")


def parent_calibration(torch) -> float:
    n, chain = 512, 8
    x = torch.ones((n, n)) / n
    (x @ x).sum().item()
    t0 = time.perf_counter()
    for _ in range(chain):
        x = x @ x
    return 2 * n ** 3 * chain / max(time.perf_counter() - t0, 1e-9)


def test_body(torch, T, venues, eff: float):
    from repro_torch.core.clones import CloneState
    venues.host_eff_flops = lambda device=None: eff
    ec = T.ExecutionController(policy=T.Policy.EXEC_TIME, link="wifi-local",
                               device="cpu")
    ec.pool.provision("main", 8, state=CloneState.RUNNING)

    def fn(xs):
        acc = torch.zeros(xs.shape[1:])
        for i in range(xs.shape[0] * 250):
            acc = torch.tanh(acc + xs[i % xs.shape[0]])
        return acc.sum()

    rm = T.RemoteableMethod(
        "par", fn, size_fn=lambda xs: xs.numel(),
        split_fn=lambda args, k: T.split_batch(args, k),
        merge_fn=lambda vs: sum(float(v) for v in vs))
    x = torch.ones((8, 128, 128))
    r1, r4 = (min((ec.execute(rm, x, force="remote", n_clones=k)
                   for _ in range(3)), key=lambda r: r.time_s)
              for k in (1, 4))
    return r1, r4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--burners", type=int, nargs="+", default=[0, 32, 48])
    args = ap.parse_args()
    import torch
    from repro_torch import core as T
    from repro_torch.core import venues
    host_eff = venues.host_eff_flops
    for burners in args.burners:
        procs = [subprocess.Popen([sys.executable, "-c", BURN])
                 for _ in range(burners)]
        try:
            time.sleep(2)
            torch.set_num_threads(args.threads)
            venues._eff_flops.cache_clear()
            figures = {"parent": parent_calibration(torch),
                       "now": host_eff("cpu")}
        finally:
            for p in procs:
                p.kill()
                p.wait()
        torch.set_num_threads(1)
        for name, eff in figures.items():
            r1, r4 = test_body(torch, T, venues, eff)
            print(f"burners {burners} threads {args.threads} {name}: "
                  f"host_eff_flops {eff:.4g}; r1 {r1.time_s:.4f} s "
                  f"(overhead {r1.overhead_s:.4f}), r4 {r4.time_s:.4f} s "
                  f"(overhead {r4.overhead_s:.4f}), r1 / r4 "
                  f"{r1.time_s / r4.time_s:.2f}, k = 4 wins: "
                  f"{r4.time_s < r1.time_s}", flush=True)
        venues.host_eff_flops = host_eff


if __name__ == "__main__":
    main()
