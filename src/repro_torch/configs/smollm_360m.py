"""smollm-360m [dense] — llama-architecture small LM.

32L d_model=960 15H (GQA kv=5, head_dim=64) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-360M]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    mlp_act="silu",
    mlp_gated=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=False,
)
