"""Benchmark runner: one section per paper table/figure.

    PYTHONPATH=src python -m repro_torch.apps.run [--device cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV lines (plus readable tables to
``--out``, by default ``results/apps_torch/`` at the repository's root,
which git ignores).  Runs on the card unless ``--device`` names another
device (raising where there is none).  Sections:
  Table 3  -> biv_micro          Table 4  -> biv_realistic
  Figs 6-11 -> apps (+ energy breakdowns Figs 8,10) + escalation
  Figs 12-14 -> parallel         §5.3     -> vm_states
  deliverable (g) -> roofline (from dry-run records, if present)
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "results", "apps_torch")


def _section(title, lines, out_dir, out_name):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, out_name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"# --- {title} (full table: {os.path.normpath(path)}) ---",
          flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.apps import applications, biv_tables, parallel_clones
    from repro_torch.launch import roofline
    from repro_torch.models.context import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    all_csv = []
    for title, run, out_name in (
            ("Table 3: micro-benchmark BIVs", biv_tables.run_micro,
             "table3_biv_micro.txt"),
            ("Table 4: realistic-benchmark BIVs", biv_tables.run_realistic,
             "table4_biv_realistic.txt"),
            ("Figures 6-11: applications", applications.run_apps,
             "figs6_11_apps.txt"),
            ("§7.3: image-combiner escalation", applications.run_escalation,
             "escalation.txt"),
            ("Figures 12-14: multi-clone parallelization",
             parallel_clones.run_parallel, "figs12_14_parallel.txt"),
            ("§5.3: VM states", parallel_clones.run_vm_states,
             "vm_states.txt")):
        lines, csv = run(dev)
        _section(title, lines, args.out, out_name)
        all_csv += csv

    # roofline (deliverable g) — reads dry-run records if present
    tbl, tag = "", ""
    for tag in ("opt", "base", ""):
        tbl = roofline.table(tag=tag)
        if tbl.count("\n") > 2:
            break
    if tbl.count("\n") > 2:
        _section(f"Roofline (from dry-run, tag={tag or 'untagged'})",
                 tbl.splitlines(), args.out, "roofline.txt")
        rows = [r for r in tbl.splitlines()[2:] if r and "skip" not in r]
        all_csv.append(("roofline/cells", 0.0, f"n={len(rows)}"))
    else:
        print(f"# roofline skipped: no dry-run records in "
              f"{os.path.normpath(roofline.RESULTS_DIR)}")

    print("name,us_per_call,derived")
    for name, us, derived in all_csv:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
