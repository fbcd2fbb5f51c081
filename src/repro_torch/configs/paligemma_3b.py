"""paligemma-3b [vlm] — SigLIP frontend (STUB) + gemma decoder backbone.

18L d_model=2048 8H (GQA kv=1, head_dim=256) d_ff=16384 vocab=257216
[arXiv:2407.07726].  The SigLIP vision tower is a STUB per assignment:
``input_specs()`` provides precomputed patch embeddings (batch, 256, d_model);
the image prefix uses bidirectional (prefix-LM) attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    mlp_act="gelu",                    # GeGLU
    mlp_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    frontend="vision",
    n_patches=256,
    sub_quadratic=False,
)
