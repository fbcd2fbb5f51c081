"""Parameter specs: one tree describing shape, dtype, logical axes and init.

``param_specs(cfg)`` (``models/model.py``) builds a nested dict of
:class:`ParamSpec` leaves with exactly the reference's key paths and shapes;
``init_params`` materializes it with an explicit ``torch.Generator``,
``abstract_params`` gives meta tensors of the same shapes and dtypes (no
allocation: the dry-run path) and ``logical_axes`` the logical sharding
axes that ``repro_torch.distributed.sharding`` reads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis name per dim (or None)
    dtype: torch.dtype = torch.bfloat16
    init: str = "fan_in"               # fan_in | zeros | ones
    fan_in: Optional[int] = None       # override for fan_in init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def map_specs(fn: Callable, tree):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def spec_leaves(tree, prefix: str = ""):
    """``[(path, spec)]`` in sorted key order, paths joined with ``/``."""
    if isinstance(tree, ParamSpec):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += spec_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def init_params(specs, generator: torch.Generator,
                device: torch.device):
    """Materialize real parameters: normal(0, 1/sqrt(fan_in)) drawn in
    float32 from ``generator`` (which must live on ``device``), zeros or
    ones, cast to each spec's dtype.  Draws follow sorted key order."""
    def make(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan = s.fan_in if s.fan_in is not None else (s.shape[0]
                                                     if s.shape else 1)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x / math.sqrt(max(fan, 1))).to(s.dtype)

    out = {}
    for path, s in spec_leaves(specs):
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = make(s)
    return out


def abstract_params(specs):
    """Meta-tensor stand-ins (shape and dtype, no storage)."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


def logical_axes(specs):
    return map_specs(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(specs))


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layer dim to every spec in the tree."""
    def f(s: ParamSpec) -> ParamSpec:
        fan = s.fan_in if s.fan_in is not None else (s.shape[0]
                                                     if s.shape else 1)
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.dtype,
                         s.init, fan)
    return map_specs(f, spec_tree)
