"""Figures 12-14: parallelization with N = {1, 2, 4, 8} VM clones, resume
time included in the overhead (paper §7.4), plus the VM-state transition
measurements of §5.3."""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.apps import workloads as W
from repro_torch.apps.harness import controller_for, measure
from repro_torch.apps.workloads import Device
from repro_torch.core import resume_time
from repro_torch.core.clones import BOOT_SECONDS
from repro_torch.models.context import resolve_device

CLONES = (1, 2, 4, 8)


def parallel_apps(device: Device = None):
    """(name, method, args) of Figures 12-14: 8-queens over 8**8, 384
    faces, 256 files of 2048 bytes — sizes chosen so that single-clone
    cloud time is tens of seconds (the paper's tasks run minutes to
    hours; resume overhead must amortize)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    det = W.face_detection_method(dev)
    scan = W.virus_scan_method(dev)
    nq = W.nqueens_method(8, dev)
    imgs = torch.as_tensor(rng.normal(size=(384, 64, 64)).astype(np.float32),
                           device=dev)
    files = torch.as_tensor(rng.integers(0, 256, (256, 2048)).astype(np.int32),
                            device=dev)
    return [("nqueens_8", nq, (0, 8 ** 8)),            # Fig 12
            ("face_detection_384", det, (imgs,)),      # Fig 13
            ("virus_scan", scan, (files,))]            # Fig 14


def run_parallel(device: Device = None
                 ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    lines = [f"{'app':18s} {'clones':>6s} {'time_s':>10s} {'energy_J':>10s} "
             f"{'resume+sync_s':>13s}"]
    csv = []
    for name, rm, args in parallel_apps(device):
        t0 = time.perf_counter()
        t1 = None
        for k in CLONES:
            ec = controller_for("wifi-local", provision=10, device=device)
            m = measure(ec, rm, *args, scenario="wifi-local", n_clones=k,
                        reps=1)
            lines.append(f"{name:18s} {k:>6d} {m['time_s']:>10.3f} "
                         f"{m['energy_j']:>10.3f} {m['overhead_s']:>13.3f}")
            if k == 1:
                t1 = m["time_s"]
            if k == CLONES[-1]:
                csv.append((f"parallel/{name}",
                            (time.perf_counter() - t0) * 1e6,
                            f"speedup_8c={t1 / m['time_s']:.2f}x"))
    return lines, csv


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_vm_states(device: Device = None
                  ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    """§5.3: resume/boot costs — modeled transitions against measured
    analogues.  The reference measures an XLA compile (boot) and an
    executable-cache hit (resume); the port has no compile step, so on the
    card it measures a CUDA-graph capture (boot: warm-up, capture and
    instantiation of the step) against a replay of the captured graph
    (resume), beside a warm eager dispatch.  On the CPU only the first and
    a warm eager call are measured."""
    dev = resolve_device(device)
    lines = ["VM state transitions (paper §5.3 analogues):"]
    csv = []
    # modeled (calibrated to the paper: 300ms resume, 6-7s for 7, 32s boot)
    for k in (1, 2, 4, 7, 8):
        lines.append(f"  resume {k} simultaneous: {resume_time(k):.2f}s "
                     f"(paper: 0.3s @1, 6-7s @7)")
    lines.append(f"  cold boot: {BOOT_SECONDS:.0f}s (paper: 32s)")

    def f(x):
        return torch.tanh(x @ x).sum()

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    x = torch.ones((256, 256), dtype=torch.float32, device=dev)
    first_s = timed(lambda: f(x))
    warm_s = timed(lambda: f(x))
    if dev.type != "cuda":
        lines.append(f"  measured eager: first call={first_s * 1e3:.1f}ms, "
                     f"warm dispatch={warm_s * 1e3:.2f}ms (CUDA-graph "
                     "capture / replay: not measured, no card)")
        csv.append(("vm_states/first_call", first_s * 1e6,
                    f"warm_us={warm_s * 1e6:.0f}"))
        return lines, csv

    graph = torch.cuda.CUDAGraph()

    def capture():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            f(x)                                     # warm-up off the graph
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph):
            f(x)

    capture_s = timed(capture)
    replay_s = timed(graph.replay)
    lines.append(f"  measured CUDA graph: capture(boot)="
                 f"{capture_s * 1e3:.1f}ms, replay(resume)="
                 f"{replay_s * 1e3:.3f}ms, warm eager dispatch="
                 f"{warm_s * 1e3:.3f}ms (first eager call "
                 f"{first_s * 1e3:.1f}ms)")
    lines.append(f"  boot/resume ratio: modeled {BOOT_SECONDS / 0.3:.0f}x, "
                 f"measured {capture_s / max(replay_s, 1e-9):.0f}x")
    csv.append(("vm_states/graph_capture_boot", capture_s * 1e6,
                f"replay_us={replay_s * 1e6:.0f}"))
    return lines, csv
