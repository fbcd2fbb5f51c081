"""Production mesh construction (functions: importing this module touches
no process group).

The meshes are ``DeviceMesh``es on the default process group, which the
caller sets up (``torch.distributed.init_process_group`` with its own
address, world size and rank; nothing here discovers a cluster).  The
device type is the card's unless the caller names the CPU.
"""
from __future__ import annotations

from typing import Optional


def _mesh(shape, names, device_type: Optional[str]):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model): a world of
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(device_type: Optional[str] = None):
    """1 x 1 mesh with production axis names (one rank)."""
    return _mesh((1, 1), ("data", "model"), device_type)


def make_mesh(shape, names=("data", "model"),
              device_type: Optional[str] = None):
    """Any mesh over the default process group (``shape`` multiplies to
    its world size)."""
    return _mesh(tuple(shape), tuple(names), device_type)
