"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2, head_dim=128) d_ff=11008 vocab=151936
[hf:Qwen/Qwen2.5-3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=False,
)
