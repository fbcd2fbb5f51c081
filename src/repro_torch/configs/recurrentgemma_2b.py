"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (GQA kv=1, head_dim=256) d_ff=7680 vocab=256000
[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    window=2048,                       # local attention window
    block_pattern=("rglru", "rglru", "attn"),
    mlp_act="gelu",                    # GeGLU as in gemma
    mlp_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    final_softcap=30.0,
    rope_theta=10_000.0,
    sub_quadratic=True,                # O(1) LRU state + windowed attention
)
