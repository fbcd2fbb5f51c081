#!/usr/bin/env python3
"""Find a cell's knee: serve its traffic at several offered rates, one
window each, in one process on this machine's card.

    python3 cardbench/sweep.py --workload <cell> --rates 8 12 16
        [--seconds 51] [--seed 1]

For each rate (requests per second; for a burst mix, bursts per second)
prints the completed output tokens per second, and the 95th percentile
of the wait for a slot with its median over the first and the last
third of the window's requests: a backlog that grows across the window
shows as a last third far above the first.
It also prints the median time to first token over the first and the
last third, and the 50th, 90th and 95th percentiles of both tails.  The
knee is the highest rate whose backlog does not grow; a cell's traffic
file fixes its rate at about four fifths of it.  Sweep with windows as
long as the cell's runs: a window that ends before requests that live
many seconds have filled the slots shows no backlog where a run has one.  Run one rate a process
where a rate's set-up needs much of the card: the caching allocator
fragments over several windows.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch
    from bench import cells, harness
    from bench.cells import HERE
    from bench.stats import median, percentile
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tpot_reader", HERE / "metrics" / "tpot_p95_ms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tpot_s = mod.tpot_s
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    base = cells.load(args.workload)
    for rate in args.rates:
        cell = copy.deepcopy(base)
        cell.mix["arrivals"]["rate"] = rate
        run = harness.run_cell(cell, args.seed, args.seconds, False,
                               t_start=time.perf_counter(),
                               log=lambda m: print(m, file=sys.stderr))
        rids = sorted(run.due, key=run.due.get)
        waits = [run.slot_admit.get(r, float("inf")) - run.due[r]
                 for r in rids]
        third = max(1, len(rids) // 3)
        toks = sum(len(c.tokens) for c in run.completions.values())
        ttft = [run.completions[r].first_token_t - run.due[r]
                if r in run.completions else float("inf") for r in rids]
        tpot = [tpot_s(run.completions[r]) if r in run.completions
                else float("inf") for r in rids]

        def pct(xs):
            return "/".join(f"{1e3 * percentile(xs, q):.1f}"
                            for q in (50, 90, 95))
        print(f"{args.workload} rate {rate} seed {args.seed}: {len(rids)} "
              f"requests, {toks / run.window_s:.1f} tokens/s over "
              f"{run.window_s:.2f} s; ttft p50/p90/p95 {pct(ttft)} ms, "
              f"median first third {1e3 * median(ttft[:third]):.1f} ms, "
              f"last third {1e3 * median(ttft[-third:]):.1f} ms; tpot "
              f"p50/p90/p95 {pct(tpot)} ms; slot wait p95 "
              f"{1e3 * percentile(waits, 95):.1f} ms, median first third "
              f"{1e3 * median(waits[:third]):.1f} ms, last third "
              f"{1e3 * median(waits[-third:]):.1f} ms; peak "
              f"{run.memory_peak_bytes / 1e9:.2f} GB", flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
