"""Load the reference package's parameters into the port.

Key-path rule: the port keeps the reference's parameter tree unchanged.
Every leaf at path ``embed``, ``final_norm/scale``, ``head``,
``layers/stack/b{i}/{norm1,norm2,attn,rec,tm,cm,ffn}/<name>`` (stacked on
a leading group axis, which the port keeps: layer ``g`` reads ``leaf[g]``) or
``layers/rest/r{i}/...`` maps to the same path in
:func:`repro_torch.models.model.param_specs`, with the same shape, cast to
that spec's dtype.  Inputs are numpy arrays (``np.asarray`` of each JAX
leaf); bfloat16 arrays pass through float32, which is exact.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import param_specs
from repro_torch.models.spec import spec_leaves


def _leaves(tree, prefix: str = ""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def from_jax(tree: Dict, cfg: ModelConfig,
             device: Optional[torch.device] = None) -> Dict:
    """Nested dict of numpy arrays (the reference tree) -> port params.

    Raises ``ValueError`` when the key paths or shapes differ from
    ``param_specs(cfg)``."""
    specs = dict(spec_leaves(param_specs(cfg)))
    got = _leaves(tree)
    if set(got) != set(specs):
        raise ValueError("parameter paths differ: missing "
                         f"{sorted(set(specs) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(specs))}")
    out: Dict = {}
    for path, spec in specs.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {spec.shape}")
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.to(device=device, dtype=spec.dtype)
    return out
