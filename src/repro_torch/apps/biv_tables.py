"""Tables 3 & 4: boundary input values for micro + realistic benchmarks."""
from __future__ import annotations

import time
from typing import List, Tuple

from repro_torch.apps import workloads as W
from repro_torch.apps.harness import find_biv
from repro_torch.apps.workloads import Device
from repro_torch.core import ExecutionController

MICRO_SIZES = {
    "fibonacci": list(range(6, 26, 2)),
    "hash": [50, 100, 200, 400, 800, 1600],
    "hash2": [1, 2, 4, 8, 16, 32, 64],
    "matrix": [1, 2, 4, 8, 16, 64, 256, 1024, 4096],
    "methcall": [64, 256, 1024, 4096, 16384, 65536],
    "nestedloop": [2, 3, 4, 5, 6, 7, 8, 10, 12],
    "objinst": [64, 256, 1024, 4096, 16384, 65536],
    "sieve": [1, 2, 4, 8, 16, 64, 256, 1024],
}

REALISTIC_SIZES = {
    "binarytrees": [2, 4, 6, 8, 10, 12, 14, 16, 18],
    "knucleotide": [1, 2, 4, 8, 16, 32, 64],
    "mandelbrot": [16, 32, 64, 128, 256, 512, 1024],
    "nbody": [16, 64, 256, 1024, 4096, 16384],
    "spectralnorm": [8, 16, 32, 64, 128, 256, 512, 1024],
}


def _tx_rx(rm, n, device: Device = None) -> Tuple[int, int]:
    ec = ExecutionController(device=device)
    res = ec.execute(rm, n, force="remote")
    return res.tx_bytes, res.rx_bytes


def run_micro(device: Device = None
              ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    methods = W.micro_methods(device)
    lines = [f"{'Benchmark':12s} {'BIV WiFi':>9s} {'BIV 3G':>7s} "
             f"{'Complexity':>14s} {'Tx':>6s} {'Rx':>6s}"]
    csv = []
    for name, rm in methods.items():
        t0 = time.perf_counter()
        sizes = MICRO_SIZES[name]
        b_wifi = find_biv(rm, sizes, "wifi-local", device)
        b_3g = find_biv(rm, sizes, "3g", device)
        tx, rx = _tx_rx(rm, sizes[0], device)
        us = (time.perf_counter() - t0) * 1e6
        lines.append(f"{name:12s} {str(b_wifi):>9s} {str(b_3g):>7s} "
                     f"{W.MICRO_COMPLEXITY[name]:>14s} {tx:>6d} {rx:>6d}")
        csv.append((f"biv_micro/{name}", us,
                    f"biv_wifi={b_wifi};biv_3g={b_3g}"))
    return lines, csv


def run_realistic(device: Device = None
                  ) -> Tuple[List[str], List[Tuple[str, float, str]]]:
    methods = W.realistic_methods(device)
    lines = [f"{'Benchmark':14s} {'BIV':>7s} {'Tx':>6s} {'Rx':>6s}"]
    csv = []
    for name, rm in methods.items():
        t0 = time.perf_counter()
        sizes = REALISTIC_SIZES[name]
        biv = find_biv(rm, sizes, "wifi-local", device)
        tx, rx = _tx_rx(rm, sizes[0], device)
        us = (time.perf_counter() - t0) * 1e6
        lines.append(f"{name:14s} {str(biv):>7s} {tx:>6d} {rx:>6d}")
        csv.append((f"biv_realistic/{name}", us, f"biv={biv}"))
    return lines, csv
