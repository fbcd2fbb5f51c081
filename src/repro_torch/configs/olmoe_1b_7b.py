"""olmoe-1b-7b [moe] — 64 experts, top-8 routing.

16L d_model=2048 16H (kv=16, head_dim=128) d_ff=1024 (per expert)
vocab=50304, MoE 64e top-8 [arXiv:2409.02060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                         # per-expert hidden width
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    sub_quadratic=False,
)
