"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm + GQA.  [hf:Qwen/Qwen3-14B; hf]
"""
from .base import ModelConfig, dense_stages, lm_shapes

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    stages=dense_stages(40),
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="silu",
    attn_shard="kv",
    tie_embeddings=False,
    shapes=lm_shapes(long_ok=False),
    source="hf:Qwen/Qwen3-14B; hf",
)
