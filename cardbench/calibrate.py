#!/usr/bin/env python3
"""The readings a cell's ``logit_gap`` limit is set from, in one process
on this machine's card: the program's widest gap on each seed, and the
control's on some of them.

    python3 cardbench/calibrate.py --workload <cell> --seeds 11 12 ...
        [--control-seeds 11 12 13] [--seconds 10]

Each seed serves a window of the cell's traffic at its own size and rate
(as ``run.py`` does, untraced) and samples the finished requests as a run
does.  The program's reading is the widest gap of its served tokens below
the float32 reference's best logit.  The control's, on the same prompts
and served tokens, is the widest gap of the tokens that the reference
computed in float8 (``precision="fp8"``, the precision below the
configuration's bfloat16) puts first.  The lower reading of the limit is
the largest of the program's, the upper the smallest of the control's.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    import torch
    from bench import cells, check, harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    dev = torch.device("cuda")
    prog, ctl = [], []
    for seed in args.seeds:
        run = harness.run_cell(cell, seed, args.seconds, False,
                               t_start=time.perf_counter(),
                               log=lambda m: print(m, file=sys.stderr))
        rids = check.sample(run, int(cell.mix["check"]["requests"]))
        ntok = sum(len(run.completions[r].tokens) for r in rids)
        g = check.gaps(run, rids, dev)
        prog.append(max(g))
        line = (f"{args.workload} seed {seed}: {len(run.completions)} of "
                f"{len(run.arrivals)} finished; {ntok} tokens compared; "
                f"program gap {max(g):.6f} {['%.6f' % x for x in g]}")
        if seed in args.control_seeds:
            c = check.gaps(run, rids, dev, control=True)
            ctl.append(max(c))
            line += f"; control gap {max(c):.6f} {['%.6f' % x for x in c]}"
        print(line, flush=True)
        del run
        torch.cuda.empty_cache()
    print(f"{args.workload}: lower reading (largest program gap) "
          f"{max(prog):.6f} over {len(prog)} seeds; upper reading "
          f"(smallest control gap) "
          f"{min(ctl) if ctl else float('nan'):.6f} over {len(ctl)} seeds",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
