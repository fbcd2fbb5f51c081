"""AdamW with global-norm clipping and a warmup + cosine schedule.

Plain functions over nested dicts of tensors, in the reference's
arithmetic order (``src/repro/optim/adamw.py``): the moments ``mu`` and
``nu`` are float32 whatever the parameter dtype; the gradients are scaled
by ``min(1, clip_norm / global_norm)``; the update ``p - lr * (dir + wd *
p)`` (decoupled decay) is computed in float32 and cast back.  Not
``torch.optim.AdamW``, whose schedule, clipping and decay differ.

:func:`update` writes the new moments into ``opt_state``'s tensors in
place (each op the same float32 operation as the reference's, so the
values do not change) and returns new parameter tensors: the old
parameters stay as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.models.layers import f32
from repro_torch.models.model import _tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup to ``peak_lr``,
    then a cosine down to ``min_lr_ratio * peak_lr`` at ``decay_steps``."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.decay_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cosine)


def init(params) -> Dict:
    """Zero float32 moments beside every parameter (DTensors at the
    parameter's placements on a mesh), and step 0 (int32; replicated on a
    mesh)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    leaf = _tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    mesh = getattr(leaf, "device_mesh", None)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor scalar made whole (replicated) on every rank; a plain
    tensor as it is."""
    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (float64 for float64 gradients)."""
    sums = [_whole(torch.sum(torch.square(f32(g))))
            for g in _tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def update(cfg: OptConfig, grads, opt_state: Dict, params):
    """Returns (new_params, new_opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        step_dir = mu / bc1
        step_dir.div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        p32 = p.float()
        step_dir.add_(cfg.weight_decay * p32).mul_(lr)
        return (p32 - step_dir).to(p.dtype)

    new_params = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return new_params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                        "step": step}, {"lr": lr, "grad_norm": gnorm}
