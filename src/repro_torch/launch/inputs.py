"""Meta-tensor stand-ins for every model input (the dry-run's inputs).

``input_specs(cfg, shape)`` returns the abstract inputs of the step
function of that (arch x shape) cell: shapes and dtypes, never allocated.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import model


def _drop_targets(batch_abs: Dict) -> Dict:
    return {k: v for k, v in batch_abs.items()
            if k not in ("targets", "loss_mask")}


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.window, seq_len) if cfg.window else seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract inputs for the cell's step function.

    train   -> {"batch": {...}}
    prefill -> {"batch": {...}} (no targets)
    decode  -> {"cache": ..., "tokens": (B, 1), "pos": scalar}
    """
    pipe = Pipeline(cfg, DataConfig(shape.global_batch, shape.seq_len))
    batch_abs = pipe.abstract_batch()
    if shape.kind == "train":
        return {"batch": batch_abs}
    if shape.kind == "prefill":
        return {"batch": _drop_targets(batch_abs)}
    cap = cache_capacity(cfg, shape.seq_len)
    meta = torch.device("meta")
    return {
        "cache": model.abstract_cache(cfg, shape.global_batch, cap),
        "tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                              device=meta),
        "pos": torch.empty((), dtype=torch.int32, device=meta),
    }
