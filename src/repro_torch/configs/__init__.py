"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    applicability,
)

from repro_torch.configs import (  # noqa: E402
    hubert_xlarge,
    mixtral_8x7b,
    olmoe_1b_7b,
    paligemma_3b,
    phi3_mini_3_8b,
    qwen2_5_3b,
    recurrentgemma_2b,
    rwkv6_7b,
    smollm_360m,
    stablelm_1_6b,
)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        recurrentgemma_2b,
        hubert_xlarge,
        smollm_360m,
        stablelm_1_6b,
        qwen2_5_3b,
        phi3_mini_3_8b,
        olmoe_1b_7b,
        mixtral_8x7b,
        rwkv6_7b,
        paligemma_3b,
    )
}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests.

    Preserves structure (GQA ratio, pattern, gating, MoE routing, frontend)
    while shrinking every capacity dimension.
    """
    q_per_kv = cfg.q_per_kv
    n_heads = min(cfg.n_heads, 2 * q_per_kv)
    n_heads = max(n_heads - n_heads % q_per_kv, q_per_kv)
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=max(len(cfg.block_pattern), 2),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, n_heads // q_per_kv),
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        window=min(cfg.window, 8) if cfg.window else None,
        n_patches=4,
        conv1d_width=cfg.conv1d_width,
        dtype="float32",
    )
    if cfg.family == "ssm":
        # rwkv heads span d_model exactly: d_model = n_heads * head_dim
        updates["n_heads"] = 4
        updates["n_kv_heads"] = 4
        updates["head_dim"] = 16
    return dataclasses.replace(cfg, **updates)


def draft_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced-cost draft config for cross-tier speculative decoding.

    The draft model shares the target's tokenizer/vocab (acceptance
    compares token ids directly) and its structural family, but shrinks
    every capacity dimension well below even the smoke config: the point
    is a per-step cost an order of magnitude under the target's, so the
    cheap fleet tier can propose K tokens for one large-tier
    verification (docs/architecture.md ADR-008).  ``head_dim`` is kept
    at the smoke size so rope tables and the paged block geometry stay
    shared with the target pool's block tables.
    """
    base = reduced_config(cfg)
    updates = dict(
        name=cfg.name + "-draft",
        n_layers=2,
        d_model=32,
        d_ff=48,
        n_experts=min(base.n_experts, 2),
        top_k=min(base.top_k, 1),
    )
    if cfg.family == "ssm":
        updates["n_heads"] = 2
        updates["n_kv_heads"] = 2
        updates["d_model"] = 32
    else:
        q_per_kv = base.q_per_kv
        updates["n_heads"] = q_per_kv
        updates["n_kv_heads"] = 1
    return dataclasses.replace(base, **updates)


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "applicability",
    "get_config",
    "get_shape",
    "list_archs",
    "reduced_config",
    "draft_config",
]
