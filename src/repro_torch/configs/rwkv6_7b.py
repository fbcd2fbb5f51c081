"""rwkv6-7b [ssm] — "Finch": attention-free, data-dependent decay.

32L d_model=4096 (attn-free; 64 wkv heads of dim 64) d_ff=14336 vocab=65536
[arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                        # wkv heads (head_dim 64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14_336,
    vocab_size=65_536,
    block_pattern=("rwkv",),
    mlp_act="relu",                    # channel-mix uses relu^2
    mlp_gated=False,
    norm_type="layernorm",
    sub_quadratic=True,                # O(1) recurrent state
)
