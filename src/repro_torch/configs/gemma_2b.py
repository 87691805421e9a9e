"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, MQA.  [arXiv:2403.08295; hf]
"""
from .base import ModelConfig, dense_stages, lm_shapes

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    stages=dense_stages(18),
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="gelu",
    embed_scale=True,
    attn_shard="group",       # MQA: TP shards q-head groups, KV replicated
    tie_embeddings=True,
    shapes=lm_shapes(long_ok=False),
    source="arXiv:2403.08295; hf",
)
