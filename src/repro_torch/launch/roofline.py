"""Roofline analysis from dry-run records.

Three terms per (arch x shape x mesh), in seconds per step, against one
H100 SXM (the ``hopper-kernels`` guide's table):

    compute    = FLOPs_per_device / peak_FLOP/s          (989e12 bf16)
    memory     = bytes_per_device / HBM_bw               (3.35e12 B/s)
    collective = collective_bytes_per_device / link_bw   (450e9 B/s)

FLOPs and bytes are the dry-run's counts of the traced step
(``launch/dryrun.py``; its k = 1 / k = 2 ``corrected`` numbers where
present).  One link constant stands for every mesh axis: NVLink's 450
GB/s each way, as the reference's single ICI constant did; a 16 x 16 mesh
spans more cards than one NVLink domain, so the collective term is a lower
bound.  MODEL_FLOPS = 6*N*D (train) or 2*N_active*D (serve) gives the
usefulness ratio: how much of the counted compute is algorithmically
necessary.  These are estimates from counting, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun_torch")


def model_flops(rec: Dict) -> float:
    """Algorithmic FLOPs for the whole step (global)."""
    from repro_torch.configs import get_shape
    shape = get_shape(rec["shape"])
    n_active = rec.get("n_active_params")
    kind = rec["kind"]
    if kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch        # decode: 1 token/seq


def analyze(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    corr = rec.get("corrected", {})
    flops = corr.get("flops") or rec["cost_reported"]["flops"]
    nbytes = corr.get("bytes_accessed") or \
        rec["cost_reported"]["bytes_accessed"]
    coll = corr.get("collective_bytes")
    if coll is None:
        coll = rec["collectives_reported"]["total"]
    n_dev = rec["n_devices"]
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": nbytes / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful = (mf / n_dev) / max(flops, 1.0)
    bound_s = max(terms.values())
    achievable_mfu = (mf / n_dev / bound_s) / PEAK_FLOPS if bound_s else 0.0
    return {
        "cell": f"{rec['arch']}/{rec['shape']}/{rec['mesh']}",
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_global": mf,
        "hlo_flops_dev": flops,
        "usefulness": useful,
        "roofline_mfu": achievable_mfu,
        "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
        "fits_hbm": rec["fits_hbm"],
        "compile_s": rec.get("compile_seconds"),
    }


def load_records(results_dir: str = RESULTS_DIR, tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        parts = os.path.basename(path)[:-5].split("__")
        if tag and (len(parts) < 4 or parts[3] != tag):
            continue
        if not tag and len(parts) >= 4:
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table(results_dir: str = RESULTS_DIR, tag: str = "",
          mesh: Optional[str] = None) -> str:
    rows = []
    skips = []
    for rec in load_records(results_dir, tag):
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec.get("status") == "skip":
            skips.append(f"{rec['arch']}/{rec['shape']}/{rec['mesh']}: "
                         f"{rec['reason']}")
            continue
        a = analyze(rec)
        if a:
            rows.append(a)
    rows.sort(key=lambda r: r["cell"])
    hdr = (f"{'cell':42s} {'compute':>9s} {'memory':>9s} {'collect':>9s} "
           f"{'dom':>10s} {'useful':>7s} {'rMFU':>6s} {'GiB/dev':>8s} fits "
           f"{'trace_s':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['cell']:42s} {r['compute_s']:9.4f} {r['memory_s']:9.4f} "
            f"{r['collective_s']:9.4f} {r['dominant']:>10s} "
            f"{r['usefulness']:7.3f} {r['roofline_mfu']:6.3f} "
            f"{r['peak_gib']:8.2f} {'y' if r['fits_hbm'] else 'N':>4s} "
            f"{r['compile_s']:7.2f}")
    if skips:
        lines.append("")
        lines.extend(f"[skip] {s}" for s in skips)
    return "\n".join(lines)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    print(table(args.dir, args.tag, args.mesh))


if __name__ == "__main__":
    main()
