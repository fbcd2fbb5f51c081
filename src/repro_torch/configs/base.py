"""Model / shape configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; every assigned
input shape as a ``ShapeConfig``.  The (arch x shape) grid is resolved by
``applicability`` which encodes the skip rules from DESIGN.md
(section "Arch-applicability").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified configuration covering dense / MoE / SSM / hybrid / audio / VLM."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    window: Optional[int] = None     # sliding-window size (None = full attention)
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    encoder_only: bool = False

    # --- mlp ---
    mlp_act: str = "silu"            # silu | gelu
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain 2-layer MLP

    # --- mixture of experts ---
    n_experts: int = 0
    top_k: int = 0

    # --- layer pattern (tiled to n_layers); entries: attn | rglru | rwkv ---
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- recurrent blocks ---
    conv1d_width: int = 4            # temporal conv in RG-LRU block

    # --- norms / embeddings ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d) embedding scale

    # --- modality frontend stub ---
    frontend: Optional[str] = None   # None | audio | vision
    n_patches: int = 256             # VLM image-prefix length

    # --- numerics / long-context eligibility ---
    dtype: str = "bfloat16"
    sub_quadratic: bool = False      # eligible for long_500k decode

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer block kind, pattern tiled/truncated to n_layers."""
        pat = self.block_pattern
        reps = -(-self.n_layers // len(pat))
        return tuple((pat * reps)[: self.n_layers])

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape.  ``kind`` selects which step fn is lowered."""

    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicability(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason).  Encodes DESIGN.md skip rules."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k quadratic decode skipped"
    return True, "ok"
