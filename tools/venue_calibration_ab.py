#!/usr/bin/env python3
"""The venue calibration on the card: the port's paged serving run
(``chip_smoke.py`` phase 4: full-width smollm-360m in bf16 through the
paged ``ClientHandler`` with its default ``Venue`` executor) under the
calibration before PR 27 (one wall-clock chain of eight 512 x 512
float32 products after one warm product) and under the current one
(``venues.host_eff_flops``: best of ``CALIBRATION_REPS`` chains), in
turns: before, now, now, before.  Each turn prints the calibration, the
phase's wall time, summary and launches (phase 4's own lines).

    python3 tools/venue_calibration_ab.py
"""
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def parent_calibration(torch) -> float:
    n, chain = 512, 8
    x = torch.ones((n, n), dtype=torch.float32, device="cuda") / n
    (x @ x).sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chain):
        x = x @ x
    torch.cuda.synchronize()
    return 2 * n ** 3 * chain / max(time.perf_counter() - t0, 1e-9)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as S
    from repro_torch.configs import get_config
    from repro_torch.core import venues
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    now = venues.host_eff_flops
    cfg = get_config("smollm-360m")
    for turn in ("before", "now", "now", "before"):
        venues._eff_flops.cache_clear()
        eff = parent_calibration(torch) if turn == "before" else now()
        venues.host_eff_flops = lambda device=None, eff=eff: eff
        print(f"== {turn}: host_eff_flops {eff:.4g}", flush=True)
        t0 = time.perf_counter()
        S.paged_serving(torch, cfg)
        print(f"== {turn}: phase 4 {time.perf_counter() - t0:.2f} s",
              flush=True)
    venues.host_eff_flops = now


if __name__ == "__main__":
    main()
