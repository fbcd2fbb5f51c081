"""Step analysis: collective bytes, FLOPs, bytes accessed and memory of one
step, per device.

The reference reads these from XLA's compiled HLO (``cost_analysis``,
``memory_analysis`` and the HLO text).  Eager torch compiles nothing, so
:func:`trace` runs the step once, usually on fake tensors (no storage,
no computation) under a fake process group, and records the op stream
that reaches the dispatcher: every op of the local program this rank
would run, with DTensor ops seen as the local ops and collectives they
issue (the recorder defers DTensor calls to DTensor, so what it sees is
the per-device program, not the global one).  The three functions read
that stream, keep the reference's names and return the reference's keys:

- :func:`collective_bytes`: per-device *operand* bytes per collective kind
  (all-gather counts its local input, reduce-scatter its full input, the
  others the tensor itself);
- :func:`cost_metrics`: ``flops`` (matmul, attention and convolution ops,
  by ``torch.utils.flop_counter``'s formulas; elementwise ops count no
  FLOPs) and ``bytes_accessed`` (input plus output bytes of every op,
  counted unfused, which is what eager code does; views and allocations
  move nothing);
- :func:`memory_metrics`: argument, output, temp, alias and peak bytes.
  Peak is the most storage alive at once during the step, arguments
  included; alias counts outputs that are arguments updated in place
  (AdamW's moments, a decode step's KV cache); temp is what makes
  ``peak = argument + output + temp - alias`` hold, as in the reference.

DTensor works out output shapes by running each new op once on global
fake tensors; those runs are not the rank's work and are not recorded.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "all-reduce",
         "allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "broadcast_": "all-reduce"}
_COLL_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# ops that move no bytes
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_unsafe_view", "wait_tensor", "device",
         "_to_copy_meta", "set_", "resize_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}

_local = threading.local()


def _in_propagation() -> bool:
    return getattr(_local, "prop", 0) > 0


class _PropagationGuard:
    """Marks DTensor's output-shape runs (global fake tensors) so the
    recorder skips them."""

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self.cls = ShardingPropagator
        self.orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def wrapped(prop, op_schema):
            _local.prop = getattr(_local, "prop", 0) + 1
            try:
                return self.orig(prop, op_schema)
            finally:
                _local.prop -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        return self

    def __exit__(self, *exc):
        self.cls._propagate_tensor_meta_non_cached = self.orig


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_tensor(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


@dataclasses.dataclass
class OpTrace:
    """What :func:`trace` saw: the step's totals and memory account."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    seconds: float = 0.0


class _Recorder(TorchDispatchMode):
    def __init__(self, rec: OpTrace):
        super().__init__()
        self.rec = rec
        self.live = 0
        self.seen: Dict[int, int] = {}       # id(storage) -> nbytes

    def track(self, t: torch.Tensor, owned: bool = True) -> None:
        """Count a storage as alive until it is freed (``owned``) or for
        the whole trace (an argument the caller holds)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen[key] = n
        self.live += n
        self.rec.peak_bytes = max(self.rec.peak_bytes, self.live)
        if owned:
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented        # DTensor runs the local ops
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ns = func.namespace
        name = func.__name__.split(".")[0]
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        rec = self.rec
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            rec.flops += float(fn(*args, **kwargs, out_val=out))
        if ns in _COLL_NS and name in _KIND:
            kind = _KIND[name]
            src = ins[:1] if ns != "c10d" else _tensors(
                args[1] if name in ("allgather_", "reduce_scatter_")
                else args[0])
            rec.collectives[kind] += sum(_nbytes(t) for t in src)
        if not (func.is_view or name in _FREE or ns in _COLL_NS
                or ns == "prim"):
            rec.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


def trace(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, recording its local op stream.
    Returns (fn's output, :class:`OpTrace`)."""
    rec = OpTrace()
    recorder = _Recorder(rec)
    arg_ts = [_local_tensor(t) for t in _tensors(args) + _tensors(kwargs)]
    for t in arg_ts:
        recorder.track(t, owned=False)
    rec.argument_bytes = recorder.live
    arg_keys = {id(t.untyped_storage()) for t in arg_ts}
    t0 = time.perf_counter()
    with _PropagationGuard(), recorder:
        out = fn(*args, **kwargs)
    rec.seconds = time.perf_counter() - t0
    seen = set()
    for t in (_local_tensor(t) for t in _tensors(out)):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        rec.output_bytes += st.nbytes()
        if id(st) in arg_keys:
            rec.alias_bytes += st.nbytes()
    return out, rec


def collective_bytes(rec: OpTrace) -> Dict[str, int]:
    """Per-device operand bytes per collective kind, and their total."""
    out = dict(rec.collectives)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def cost_metrics(rec: OpTrace) -> Dict[str, float]:
    return {"flops": float(rec.flops),
            "bytes_accessed": float(rec.bytes_accessed)}


def memory_metrics(rec: OpTrace) -> Dict[str, int]:
    temp = (rec.peak_bytes - rec.argument_bytes - rec.output_bytes
            + rec.alias_bytes)
    return {
        "argument_bytes": int(rec.argument_bytes),
        "output_bytes": int(rec.output_bytes),
        "temp_bytes": int(temp),
        "alias_bytes": int(rec.alias_bytes),
        "peak_bytes": int(rec.argument_bytes + rec.output_bytes + temp
                          - rec.alias_bytes),
    }
