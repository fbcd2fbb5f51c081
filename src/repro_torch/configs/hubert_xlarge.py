"""hubert-xlarge [audio] — encoder-only transformer backbone.

48L d_model=1280 16H (kv=16, head_dim=80) d_ff=5120 vocab=504
[arXiv:2106.07447].  The audio frontend (CNN feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings (batch, seq, d_model).
Deviation noted in DESIGN.md: rotary positions replace the conv positional
embedding of the original (frontend-stub assignment).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,                    # masked-prediction codebook
    causal=False,
    encoder_only=True,
    mlp_act="gelu",
    mlp_gated=False,
    norm_type="layernorm",
    frontend="audio",
    sub_quadratic=False,
)
