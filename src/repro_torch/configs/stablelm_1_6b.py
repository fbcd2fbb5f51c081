"""stablelm-1.6b [dense].

24L d_model=2048 32H (kv=32, head_dim=64) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="layernorm",             # stablelm-2 uses LayerNorm
    sub_quadratic=False,
)
