#!/usr/bin/env python3
"""Does a range of ``repro_torch.core.trace.span`` (function scope) show
among the device events of a CUDA trace, as a user-scope
``record_function`` may?  A range mirrored on the card would count as
device busy time in the benchmark's idle share.

    python3 tools/span_device_probe.py

Prints the span's type with no session open and with one, the device and
host event names of three matrix products under both kinds of range, and
for each whether it shows on the device.  Needs a card.
"""
import pathlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.trace import span  # noqa: E402

x = torch.randn(2048, 2048, device="cuda")
print("off:", type(span("model.probe")).__name__)
for _ in range(3):
    x @ x
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    print("on:", type(span("model.probe")).__name__)
    for _ in range(3):
        with record_function("probe.user"):
            with span("model.probe"):
                y = x @ x
    torch.cuda.synchronize()
cuda = torch.autograd.DeviceType.CUDA
ev = p.profiler.kineto_results.events()
dev = sorted({e.name() for e in ev if e.device_type() == cuda})
host = sorted({e.name() for e in ev if e.device_type() != cuda})
print("device events:", dev)
print("host events:", host)
print("span on device:", "model.probe" in dev, "; span on host:",
      "model.probe" in host)
print("record_function on device:", "probe.user" in dev)
