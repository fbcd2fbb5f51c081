"""N-queens with multi-clone parallelization on the PyTorch port (paper
§7.4, Figure 12).

    PYTHONPATH=src python examples/offload_nqueens_torch.py [--n 8]
        [--device cpu]
(runs on the card unless --device names another device)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.apps.workloads import nqueens_method      # noqa: E402
from repro_torch.core import ExecutionController, Policy   # noqa: E402
from repro_torch.models.context import resolve_device      # noqa: E402


def run(n: int = 8, device=None) -> None:
    dev = resolve_device(device)
    rm = nqueens_method(n, dev)
    space = n ** n
    ec = ExecutionController(policy=Policy.EXEC_TIME, link="wifi-local",
                             device=dev)
    ec.pool.provision("main", 10)      # paused secondaries, as in the paper

    local = ec.execute(rm, 0, space, force="local")
    print(f"phone:        {local.time_s:9.2f}s  {local.energy_j:8.2f}J  "
          f"solutions={int(local.value)}")
    for k in (1, 2, 4, 8):
        r = ec.execute(rm, 0, space, force="remote", n_clones=k)
        print(f"cloud k={k}:   {r.time_s:9.2f}s  {r.energy_j:8.2f}J  "
              f"solutions={int(r.value)}  overhead={r.overhead_s:.2f}s")
    print()
    print(f"speedup vs phone with 8 clones: "
          f"{local.time_s / r.time_s:,.0f}x")
    print("clone pool stats:", ec.pool.stats)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run(args.n, args.device)


if __name__ == "__main__":
    main()
