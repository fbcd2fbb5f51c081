"""Step functions: train / prefill / decode, plus their sharding trees.

These are the units the dry-run traces and the ThinkAir training and
serving layers execute.  The train step differentiates the plain path
(``impl="torch"``), as the reference's differentiates its XLA path: no
hand-written kernel has a backward pass (``kernels/ops.py``).  On a mesh
(``make_context(mesh=...)``) the state, caches and inputs are DTensors at
the placements of :func:`state_shardings`, :func:`cache_shardings` and
``sharding.input_shardings``; the same step functions run on them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import model
from repro_torch.models.context import RunContext, resolve_device
from repro_torch.optim import adamw


def make_context(device: Optional[Union[str, torch.device]] = None,
                 mesh=None, **kw) -> RunContext:
    """The training context on ``device`` (the card unless another is
    named): the plain path, full recomputation and capacity factor 1.25,
    the reference's ``RunContext()`` defaults.  With ``mesh`` the device
    is the mesh's and the batch shards over its (pod, data) axes."""
    kw = {"impl": "torch", "remat": "full", "moe_capacity_factor": 1.25,
          **kw}
    if mesh is None:
        return RunContext(resolve_device(device), **kw)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return RunContext(dev, mesh=mesh, dp_axes=shd.batch_axes(mesh), **kw)


# --------------------------------------------------------------------------- #
# Step functions
# --------------------------------------------------------------------------- #
def _split_rows(x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``k``: rows of the batch dim; on a mesh each
    rank's own rows (a DTensor of the same placements)."""
    mesh = getattr(x, "device_mesh", None)
    if mesh is None:
        n = x.shape[0] // k
        return x[i * n:(i + 1) * n]
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    n = loc.shape[0] // k
    return DTensor.from_local(loc[i * n:(i + 1) * n], mesh, x.placements,
                              run_check=False)


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                     ctx: RunContext):
    """``train_step(state, batch) -> (new_state, metrics)`` with state
    ``{"params", "opt"}``.  With ``ctx.microbatches`` k > 1 the batch is
    split in k along its first axis (on a mesh: each rank's rows) and the
    gradients are accumulated in float32, the loss terms averaged.  The
    step owns ``state``: AdamW updates its moments in place; the
    parameters come back as new tensors.  metrics: loss, aux, total, lr,
    grad_norm (0-d tensors; replicated DTensors on a mesh)."""
    k = max(1, ctx.microbatches)

    def value_and_grad(params: Dict, batch: Dict):
        live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = model.forward(cfg, live, batch, ctx, "train")
            leaves = model._tree_leaves(live)
            grads = torch.autograd.grad(total, leaves,
                                        materialize_grads=True)
        if ctx.mesh is not None:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return (total.detach(), {n: m.detach() for n, m in metrics.items()},
                model.tree_unflatten(params, grads))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if k == 1:
            total, metrics, grads = value_and_grad(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % (k * ctx.dp_size):
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{k} microbatches")
            grads = model.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            zero = model._zero(model._tree_leaves(params)[0], ctx)
            total = zero
            metrics = {"loss": zero, "aux": zero}
            for i in range(k):
                mb = {name: _split_rows(x, k, i)
                      for name, x in batch.items()}
                total_i, metrics_i, g = value_and_grad(params, mb)
                model.tree_map(lambda a, b: a.add_(b.float()), grads, g)
                metrics = {name: metrics[name] + metrics_i[name] / k
                           for name in metrics}
                total = total + total_i / k
            grads = model.tree_map(lambda g: g / k, grads)
        new_params, new_opt, om = adamw.update(opt_cfg, grads, state["opt"],
                                               params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["total"] = total
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, ctx: RunContext,
                       cache_capacity: int = 0):
    def prefill_step(params: Dict, batch: Dict):
        return model.forward(cfg, params, batch, ctx, "prefill",
                             cache_capacity=cache_capacity)

    return prefill_step


def build_decode_step(cfg: ModelConfig, ctx: RunContext):
    def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, pos):
        return model.decode_step(cfg, params, cache, tokens, pos, ctx)

    return decode_step


# --------------------------------------------------------------------------- #
# Abstract state + shardings
# --------------------------------------------------------------------------- #
def abstract_state(cfg: ModelConfig) -> Dict:
    """Meta tensors of ``{"params", "opt"}`` (float32 moments, int32
    step)."""
    params = model.init_abstract(cfg)

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"params": params,
            "opt": {"mu": model.tree_map(f32, params),
                    "nu": model.tree_map(f32, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def state_logical_axes(cfg: ModelConfig) -> Dict:
    axes = model.param_logical_axes(cfg)
    return {"params": axes,
            "opt": {"mu": axes, "nu": axes, "step": ()}}


def state_shardings(cfg: ModelConfig, mesh, profile: str = "tp"):
    """DTensor placements of every state leaf (the port's
    ``tree_shardings``)."""
    return shd.tree_placements(abstract_state(cfg), state_logical_axes(cfg),
                               mesh, shd.rules_for(profile))


def param_shardings(cfg: ModelConfig, mesh, profile: str = "tp"):
    return shd.tree_placements(model.init_abstract(cfg),
                               model.param_logical_axes(cfg), mesh,
                               shd.rules_for(profile))


def cache_shardings(cfg: ModelConfig, mesh, batch: int, capacity: int,
                    profile: str = "tp"):
    ab = model.abstract_cache(cfg, batch, capacity)
    return shd.tree_placements(ab, model.cache_logical_axes(cfg), mesh,
                               shd.rules_for(profile))


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))
