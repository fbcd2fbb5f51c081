"""Figures 6-11: application benchmarks across the four scenarios, with
per-component energy breakdowns (Figs 8, 10) and the image-combiner
escalation experiment (§7.3)."""
from __future__ import annotations

import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.apps import workloads as W
from repro_torch.apps.harness import SCENARIOS, controller_for, measure
from repro_torch.apps.workloads import Device
from repro_torch.core import ExecutionController, Policy, RemoteableMethod
from repro_torch.core.venues import make_phone
from repro_torch.models.context import resolve_device

PUZZLE = [
    [5, 3, 0, 0, 7, 0, 0, 0, 0], [6, 0, 0, 1, 9, 5, 0, 0, 0],
    [0, 9, 8, 0, 0, 0, 0, 6, 0], [8, 0, 0, 0, 6, 0, 0, 0, 3],
    [4, 0, 0, 8, 0, 3, 0, 0, 1], [7, 0, 0, 0, 2, 0, 0, 0, 6],
    [0, 6, 0, 0, 0, 0, 2, 8, 0], [0, 0, 0, 4, 1, 9, 0, 0, 5],
    [0, 0, 0, 0, 8, 0, 0, 7, 9]]
ESCALATION_SIDES = (256, 1024, 2048, 4096)


def _apps(device: Device = None):
    """(name, method, args) of Figures 6, 7, 9 and 11 at the paper's sizes:
    32 faces of 64 x 64, 64 files of 1024 bytes, 8-queens over 8**8."""
    dev = resolve_device(device)
    det = W.face_detection_method(dev)
    scan = W.virus_scan_method(dev)
    nq = W.nqueens_method(8, dev)
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.normal(size=(32, 64, 64)).astype(np.float32),
                           device=dev)
    files = torch.as_tensor(rng.integers(0, 256, (64, 1024)).astype(np.int32),
                            device=dev)
    puz = torch.as_tensor(PUZZLE, device=dev)
    sud = RemoteableMethod("sudoku", lambda p: W.sudoku(p, device=dev),
                           size_fn=lambda p: p.numel())
    return [
        ("sudoku", sud, (puz,)),                       # Fig 6
        ("nqueens_8", nq, (0, 8 ** 8)),                # Fig 7
        ("face_detection_32", det, (imgs,)),           # Fig 9
        ("virus_scan", scan, (files,)),                # Fig 11
    ]


def run_apps(device: Device = None
             ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    lines = [f"{'app':18s} {'scenario':14s} {'time_s':>10s} "
             f"{'energy_J':>10s} {'overhead_s':>10s}"]
    csv = []
    breakdowns = []
    for name, rm, args in _apps(device):
        t0 = time.perf_counter()
        results = {}
        for scen in SCENARIOS:
            ec = controller_for(scen, device=device)
            m = measure(ec, rm, *args, scenario=scen)
            results[scen] = m
            lines.append(f"{name:18s} {scen:14s} {m['time_s']:>10.3f} "
                         f"{m['energy_j']:>10.3f} {m['overhead_s']:>10.3f}")
            if name in ("nqueens_8", "face_detection_32"):
                comp = " ".join(f"{k}={v:.3f}"
                                for k, v in m["energy_components"].items()
                                if v > 1e-6)
                breakdowns.append(f"  [{name} @ {scen}] {comp}")
        us = (time.perf_counter() - t0) * 1e6
        speedup = results["phone"]["time_s"] / results["wifi-local"]["time_s"]
        esave = results["phone"]["energy_j"] / max(
            results["wifi-local"]["energy_j"], 1e-9)
        csv.append((f"apps/{name}", us,
                    f"speedup_wifi={speedup:.1f}x;energy_save={esave:.1f}x"))
    lines.append("")
    lines.append("Energy breakdown by component (Figures 8, 10):")
    lines.extend(breakdowns)
    return lines, csv


def escalations(device: Device = None) -> Iterator[tuple]:
    """(side, a, b, result) of the image combiner forced remote at each of
    ``ESCALATION_SIDES``: two float32 side x side images from
    ``default_rng(1)``, a fresh EXEC_TIME controller each."""
    dev = resolve_device(device)
    rm = W.image_combiner_method(dev)
    rng = np.random.default_rng(1)
    for side in ESCALATION_SIDES:
        a, b = (torch.as_tensor(rng.normal(size=(side, side))
                                .astype(np.float32), device=dev)
                for _ in range(2))
        ec = ExecutionController(policy=Policy.EXEC_TIME, device=dev)
        yield side, a, b, ec.execute(rm, a, b, force="remote")


def run_escalation(device: Device = None
                   ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    """Image combiner (§7.3): OutOfMemory-driven clone escalation."""
    lines = ["image-combiner escalation (paper §7.3):"]
    csv = []
    t0 = time.perf_counter()
    for side, _, _, res in escalations(device):
        lines.append(f"  {side}x{side}+{side}x{side}: venue={res.venue} "
                     f"escalations={res.escalations} time={res.time_s:.3f}s")
        csv.append((f"escalation/{side}", (time.perf_counter() - t0) * 1e6,
                    f"venue={res.venue};escalations={res.escalations}"))
    # the phone cannot run the big combine at all (paper: OutOfMemoryError)
    side = ESCALATION_SIDES[-1]
    a = torch.empty((side, side), dtype=torch.float32, device="meta")
    need = W.image_combiner_method(device).mem_fn(a, a)
    lines.append(f"  phone heap {make_phone().mem_bytes >> 20}MB vs working "
                 f"set {need >> 20}MB -> phone execution impossible, "
                 f"cloud escalation required")
    return lines, csv
