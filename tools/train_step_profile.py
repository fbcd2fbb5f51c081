#!/usr/bin/env python3
"""Where a train step's time goes on the card: one configuration at full
width in bf16 through ``steps.build_train_step`` (impl="torch", AdamW),
a few warm-up steps, then ``torch.profiler`` over ``--steps`` steps.

    python3 tools/train_step_profile.py [--arch smollm-360m] [--batch 8]
        [--seq 256] [--layers N] [--remat full|dots|none] [--steps 2]
        [--trace PATH.json.gz]

Prints the card's name and power limit, the host-clock time per step
(synchronised), the device's busy time (the union of kernel intervals)
and idle share over the profiled window, the kernel launches per step,
and the CUDA kernels and host ops that take the most time; with
``--trace`` also the Chrome trace (gzipped when the path ends in .gz).
Needs a card.
"""
import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def busy_ms(events):
    """Union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the configuration's)")
    ap.add_argument("--remat", default="full",
                    choices=("none", "dots", "full"))
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace to this path")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    from repro_torch.optim import adamw

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device("cuda")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = {"params": params, "opt": adamw.init(params)}
    del params
    step = S.build_train_step(cfg, adamw.OptConfig(),
                              S.make_context("cuda", remat=args.remat))
    pipe = Pipeline(cfg, DataConfig(args.batch, args.seq))
    batches = [{k: v.to(dev) for k, v in pipe.batch(i).items()}
               for i in range(args.warmup + args.steps)]
    for b in batches[:args.warmup]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[args.warmup:]:
            state, m = step(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    n = args.steps
    print(f"{cfg.name} ({model.n_params(cfg)} parameters, "
          f"{cfg.n_layers} layers), batch {args.batch} x {args.seq}, "
          f"remat {args.remat}: {wall / n:.1f} ms per step (host clock, "
          f"profiled); device busy {busy / n:.1f} ms per step, idle share "
          f"{1 - busy / wall:.3f}; {len(kernels) / n:.0f} kernels per step; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; loss "
          f"{float(m['loss']):.4f}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=15), flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=10), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
