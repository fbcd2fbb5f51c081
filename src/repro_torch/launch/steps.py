"""Step functions: train / prefill / decode on one device.

These are the units the ThinkAir training and serving layers execute.
The train step differentiates the plain path (``impl="torch"``), as the
reference's differentiates its XLA path: no hand-written kernel has a
backward pass (``kernels/ops.py``).  Abstract state and shardings wait for
the port's mesh (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.models.context import RunContext, resolve_device
from repro_torch.optim import adamw


def make_context(device: Optional[Union[str, torch.device]] = None,
                 **kw) -> RunContext:
    """The training context on ``device`` (the card unless another is
    named): the plain path, full recomputation and capacity factor 1.25,
    the reference's ``RunContext()`` defaults."""
    kw = {"impl": "torch", "remat": "full", "moe_capacity_factor": 1.25,
          **kw}
    return RunContext(resolve_device(device), **kw)


# --------------------------------------------------------------------------- #
# Step functions
# --------------------------------------------------------------------------- #
def build_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                     ctx: RunContext):
    """``train_step(state, batch) -> (new_state, metrics)`` with state
    ``{"params", "opt"}``.  With ``ctx.microbatches`` k > 1 the batch is
    split in k along its first axis and the gradients are accumulated in
    float32, the loss terms averaged.  The step owns ``state``: AdamW
    updates its moments in place; the parameters come back as new
    tensors.  metrics: loss, aux, total, lr, grad_norm (0-d tensors)."""
    k = max(1, ctx.microbatches)

    def value_and_grad(params: Dict, batch: Dict):
        live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            total, metrics = model.forward(cfg, live, batch, ctx, "train")
            grads = torch.autograd.grad(total, model._tree_leaves(live),
                                        materialize_grads=True)
        return (total.detach(), {n: m.detach() for n, m in metrics.items()},
                model.tree_unflatten(params, grads))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if k == 1:
            total, metrics, grads = value_and_grad(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % k:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{k} microbatches")
            grads = model.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            zero = torch.zeros((), dtype=torch.float32,
                               device=model._tree_leaves(params)[0].device)
            total = zero
            metrics = {"loss": zero, "aux": zero}
            for i in range(k):
                mb = {name: x[i * (n // k):(i + 1) * (n // k)]
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
