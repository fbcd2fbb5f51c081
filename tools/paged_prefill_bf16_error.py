#!/usr/bin/env python3
"""bfloat16 error of the chunked paged-prefill kernel at deep rows (GPU).

    python3 tools/paged_prefill_bf16_error.py [--seeds 64] [--out FILE]

For head dims 64, 80 and 128, GQA groups 1, 3 and 8, block 16 and chunks
C 8 and 64, each seed draws one batch of four slots at pos0 300, 1000,
3000 and 8000 (every chunk row live), standard-normal q, K and V rounded
to bfloat16, and scattered block tables.  The truth is the plain version
(``ref.paged_prefill_ref``) in float32 on those bfloat16 values, so the
inputs' own rounding is left out.  Per slot it records, relative to the
RMS of the truth over the slot's rows:

- ``kernel``: max |kernel - truth| (the bf16 kernel, ``ops.paged_prefill``);
- ``plain``: max |plain - truth| (the plain version run in bfloat16);
- ``check``: max |kernel - plain| over the RMS of the plain output, the
  quantity ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold to
  0.05 at pos0 3000.

Prints, per (D, C, pos0), the median, 90th and 99th percentiles and the
maximum of each over seeds and groups, and how many ``check`` values
exceed 0.05; with ``--out`` it also writes every value there as JSON.
Times nothing.
"""
import argparse
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402

DIMS = (64, 80, 128)
GROUPS = (1, 3, 8)
CHUNKS = (8, 64)
POS0 = (300, 1000, 3000, 8000)
HKV, BS = 2, 16
SHARE = 0.05


def case(rng, d, g, c, dev):
    """One batch: pools, tables covering each slot's pos0 + C tokens, q;
    every array bfloat16-valued."""
    b = len(POS0)
    spans = [-(-(p + c) // BS) for p in POS0]
    m = max(spans)
    n = sum(spans) + 1
    ids = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    nxt = 0
    for i, sp in enumerate(spans):
        tables[i, :sp] = ids[nxt:nxt + sp]
        nxt += sp

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dev, torch.bfloat16)
    return (draw(b, c, g * HKV, d), draw(n, BS, HKV, d),
            draw(n, BS, HKV, d), torch.from_numpy(tables).to(dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--out", default=None,
                    help="also write every value to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("paged_prefill_bf16_error: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    p0 = torch.tensor(POS0, dtype=torch.int32, device=dev)
    rows = {}
    for d in DIMS:
        for c in CHUNKS:
            nl = torch.full((len(POS0),), c, dtype=torch.int32, device=dev)
            for g in GROUPS:
                rng = np.random.default_rng(1000 * d + 10 * c + g)
                for _ in range(args.seeds):
                    q, kp, vp, tables = case(rng, d, g, c, dev)
                    got = ops.paged_prefill(q, kp, vp, tables, p0, nl).float()
                    plain = ref.paged_prefill_ref(
                        q.transpose(1, 2), kp, vp, tables, p0,
                        nl).transpose(1, 2).float()
                    truth = ref.paged_prefill_ref(
                        q.float().transpose(1, 2), kp.float(), vp.float(),
                        tables, p0, nl).transpose(1, 2)
                    for i, pos in enumerate(POS0):
                        rms = truth[i].pow(2).mean().sqrt()
                        prms = plain[i].pow(2).mean().sqrt()
                        vals = rows.setdefault((d, c, pos), {
                            "kernel": [], "plain": [], "check": []})
                        vals["kernel"].append(float(
                            (got[i] - truth[i]).abs().max() / rms))
                        vals["plain"].append(float(
                            (plain[i] - truth[i]).abs().max() / rms))
                        vals["check"].append(float(
                            (got[i] - plain[i]).abs().max() / prms))
    torch.cuda.synchronize()
    print(f"max abs error over the truth's RMS, {args.seeds} seeds x groups "
          f"{'/'.join(map(str, GROUPS))} per row; median / p90 / p99 / max",
          flush=True)
    summary = {}
    for (d, c, pos), vals in sorted(rows.items()):
        line = [f"D {d:3d} C {c:2d} pos0 {pos:4d}"]
        summary[f"D{d}_C{c}_pos0{pos}"] = entry = {}
        for key in ("kernel", "plain", "check"):
            x = np.asarray(vals[key])
            q = np.percentile(x, [50, 90, 99]).tolist() + [float(x.max())]
            entry[key] = q
            line.append(f"{key} " + " / ".join(f"{v:.4f}" for v in q))
        over = int((np.asarray(vals["check"]) > SHARE).sum())
        entry["check_over_share"] = over
        line.append(f"check > {SHARE}: {over}/{len(vals['check'])}")
        print("  " + " | ".join(line), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "device": smi, "seeds": args.seeds, "summary": summary,
            "values": {f"D{d}_C{c}_pos0{p}": v
                       for (d, c, p), v in rows.items()}}))
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
