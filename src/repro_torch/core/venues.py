"""Execution venues: the "phone" (local), cloud VMs (the paper's Table 1)
and GPU sub-meshes.

A venue is somewhere a remoteable method can run.  Every venue *executes*
on one device (the card unless the caller names another); venue-relative
time is one real measurement on that device scaled by the venue's
effective-throughput ratio (measured = wall clock after a device
synchronise; modeled = scaled).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.models.context import resolve_device

# ---- hardware constants (NVIDIA H100 SXM, per card: the hopper-kernels
# guide's table, from NVIDIA's data sheet) -----------------------------------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80 * 10 ** 9          # 80 GB
NVLINK_BW = 450e9                 # B/s each way (900 GB/s all to all)


# ---- scenario link profiles (paper §7: Phone / WiFi-Local / WiFi-Internet /
# 3G), plus the fleet's card-to-card link -------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkProfile:
    name: str
    bandwidth: float              # bytes/s
    rtt: float                    # seconds


LINKS = {
    "wifi-local": LinkProfile("wifi-local", 6.75e6, 0.005),     # 54 Mbit
    "wifi-internet": LinkProfile("wifi-internet", 2.5e6, 0.050),
    "wifi-hotspot": LinkProfile("wifi-hotspot", 2.5e6, 0.200),
    "3g": LinkProfile("3g", 0.25e6, 0.100),
    "nvlink": LinkProfile("nvlink", NVLINK_BW, 1e-6),
}


@dataclasses.dataclass
class VenueSpec:
    """Static description of a compute venue."""

    name: str
    chips: int = 1
    eff_flops: float = 1e9        # sustained useful FLOP/s for our workloads
    hbm_bytes: int = HBM_BYTES
    mem_bytes: int = HBM_BYTES    # method working-set budget (OOM escalation)
    power_idle: float = 60.0      # W
    power_peak: float = 200.0     # W at full utilization
    link: LinkProfile = LINKS["wifi-local"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


CALIBRATION_REPS = 5              # timings of the matmul chain; the best kept


@functools.lru_cache(maxsize=None)
def _eff_flops(device: str) -> float:
    """Float32 throughput of ``device`` from a chain of eight 512 x 512
    products, best of ``CALIBRATION_REPS`` timings.  On the CPU the chain
    runs on one torch thread and is timed by that thread's own CPU clock,
    so neither the host's load at that moment nor the first caller's
    thread count sets the figure that every later venue time is scaled
    by; on the card it is wall clock after a device synchronise."""
    dev = torch.device(device)
    cpu = dev.type == "cpu"
    clock = time.thread_time if cpu else time.perf_counter
    n, chain = 512, 8
    x0 = torch.ones((n, n), dtype=torch.float32, device=dev) / n
    threads = torch.get_num_threads()
    if cpu:
        torch.set_num_threads(1)
    try:
        (x0 @ x0).sum().item()
        best = math.inf
        for _ in range(CALIBRATION_REPS):
            x = x0
            _sync(dev)
            t0 = clock()
            for _ in range(chain):
                x = x @ x
            _sync(dev)
            best = min(best, clock() - t0)
    finally:
        if cpu:
            torch.set_num_threads(threads)
    return 2 * n ** 3 * chain / max(best, 1e-9)


def host_eff_flops(device: Optional[Union[str, torch.device]] = None
                   ) -> float:
    """Sustained float32 matmul throughput of ``device`` (the card unless
    another is named; measured once per device and cached: see
    ``_eff_flops``)."""
    return _eff_flops(str(resolve_device(device)))


# ---- venue catalogue --------------------------------------------------------
# "phone": a 2011-era handset (the paper's HTC Dream); its energy comes from
# the PowerTutor model, not from the venue's power figures.
def make_phone() -> VenueSpec:
    return VenueSpec("phone", chips=1, eff_flops=0.05e9,
                     mem_bytes=16 * 2 ** 20,       # 16 MB Dalvik heap cap
                     power_idle=0.0, power_peak=0.0,
                     link=LINKS["wifi-local"])


def make_cloud_vm(name: str, cpus: int, mem_mb: int, heap_mb: int,
                  link: LinkProfile) -> VenueSpec:
    return VenueSpec(name, chips=cpus, eff_flops=1.5e9 * cpus,
                     mem_bytes=heap_mb * 2 ** 20,
                     hbm_bytes=mem_mb * 2 ** 20,
                     power_idle=10.0 * cpus, power_peak=35.0 * cpus,
                     link=link)


def make_gpu_venue(name: str, chips: int, link: LinkProfile,
                   mfu: float = 0.4) -> VenueSpec:
    """H100 sub-mesh venue: ``mfu`` of the bf16 peak per card; power from
    the 700 W card limit with a modeled 10% idle floor."""
    return VenueSpec(name, chips=chips,
                     eff_flops=PEAK_FLOPS_BF16 * mfu * chips,
                     hbm_bytes=HBM_BYTES * chips,
                     mem_bytes=HBM_BYTES * chips,
                     power_idle=70.0 * chips, power_peak=700.0 * chips,
                     link=link)


class Venue:
    """A live venue: executes callables on ``device`` (the card unless
    another is named; raises where there is none) and reports venue-time.
    ``execute`` returns (result, venue_seconds), venue_seconds = measured
    wall clock (after a device synchronise) x (device throughput / venue
    throughput)."""

    def __init__(self, spec: VenueSpec,
                 device: Optional[Union[str, torch.device]] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.healthy = True

    def speed_ratio(self) -> float:
        return host_eff_flops(self.device) / self.spec.eff_flops

    def execute(self, fn: Callable, *args, warm: bool = True, **kwargs):
        """Run fn; returns (result, venue_seconds).

        ``warm=True`` runs once first so one-time costs (kernel builds,
        allocator growth — the clone *boot*, accounted by the ClonePool)
        stay out of the steady-state measurement; a cheap call is timed
        twice and the minimum kept.  The callable must therefore be
        idempotent: every step closure of the serving path is."""
        if warm:
            fn(*args, **kwargs)
            _sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(self.device)
        host_dt = time.perf_counter() - t0
        if host_dt < 1.0:
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.device)
            host_dt = min(host_dt, time.perf_counter() - t1)
        return out, host_dt * self.speed_ratio()

    def estimate_time(self, flops: float) -> float:
        return flops / self.spec.eff_flops

    def fits(self, workset_bytes: int) -> bool:
        return workset_bytes <= self.spec.mem_bytes


def transfer_time(nbytes: int, link: LinkProfile) -> float:
    return link.rtt + nbytes / link.bandwidth


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def pytree_bytes(tree) -> int:
    """Serialized payload size of a nested dict/list of tensors or arrays
    (leaf bytes at each leaf's own dtype + a small per-leaf tax)."""
    leaves = _tree_leaves(tree)
    total = 0
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += math.prod(leaf.shape) * _itemsize(leaf.dtype)
        else:
            total += len(np.asarray(leaf).tobytes())
    return total + 64 * max(len(leaves), 1)   # framing/metadata overhead


def kv_block_bytes(config, block_size: int, *, quantized: bool = False) -> int:
    """Modeled wire size of one paged KV block for ``config``:
    ``block_size * n_attn_layers * 2 * n_kv_heads * head_dim`` elements at
    the model dtype, or int8 plus one float32 scale per (layer, K/V, head)
    when ``quantized``."""
    n_attn = sum(1 for k in config.layer_kinds() if k == "attn")
    per_tok = n_attn * 2 * config.n_kv_heads * config.head_dim
    if quantized:
        return block_size * per_tok + n_attn * 2 * config.n_kv_heads * 4
    itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[config.dtype]
    return block_size * per_tok * itemsize
