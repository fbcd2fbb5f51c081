#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell's files are found by name (see
``cardbench/README.md``).  The run sets up the port (``src/repro_torch``)
with weights drawn from ``--seed``, warms up, offers the cell's traffic
for ``--seconds`` through ``ClientHandler.run`` and drains it, then holds
a sample of the served tokens to the plain reference.  Its last line on
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a profiled stretch), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error.

Exits with 2 and prints no result without a CUDA card (or with fewer than
the cell asks for); with 3 if the run loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _num(x):
    """A JSON number, or null for one that is not finite."""
    if x is None or (isinstance(x, float) and not math.isfinite(x)):
        return None
    return x


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import cells, check, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T0, log=log)
    results = check.checks(run, torch.device("cuda"), log)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": _num(v), "unit": m.unit}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": check.passed(results),
           "attempted": len(run.arrivals),
           "failed": len(run.arrivals) - results["finished"]["value"],
           "metrics": metrics, "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": [list(g) for g in
                                          run.trace.idle_by_host[:10]]}
    out["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                     for k, v in results.items()}
    log(f"setup {run.setup_s:.4f} s; window {run.window_s:.4f} s; "
        f"peak {run.memory_peak_bytes} bytes; metrics "
        + ", ".join(f"{k} {v['value']}" for k, v in metrics.items()))
    for k, v in results.items():
        log(f"{k} {v['value']} limit {v['limit']}")
    # last, after the check and every reader: what any of them loaded
    bad = harness.forbidden_modules()
    if bad:
        log(f"the run loaded forbidden modules: {', '.join(bad)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
