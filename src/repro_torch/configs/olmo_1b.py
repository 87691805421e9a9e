"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm.  [arXiv:2402.00838; hf]
"""
from .base import ModelConfig, dense_stages, lm_shapes

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    stages=dense_stages(16),
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    activation="silu",
    attn_shard="kv",
    tie_embeddings=True,
    shapes=lm_shapes(long_ok=False),
    source="arXiv:2402.00838; hf",
)
