"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=14336 (per expert)
vocab=32000, MoE 8e top-2, SWA window 4096 [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    n_experts=8,
    top_k=2,
    window=4096,                       # sliding-window attention, rolling cache
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    sub_quadratic=True,                # SWA => O(window) decode cache
)
