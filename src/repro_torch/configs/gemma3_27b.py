"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.

5:1 local:global interleave (sliding window 1024), 128k context, qk-norm.
62 = 10 full (LLLLLG) periods + 2 trailing local layers.
[hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ModelConfig, Stage, lm_shapes

_PERIOD = (
    ("attn_local", "mlp"),
    ("attn_local", "mlp"),
    ("attn_local", "mlp"),
    ("attn_local", "mlp"),
    ("attn_local", "mlp"),
    ("attn", "mlp"),
)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    stages=(
        Stage(period=_PERIOD, n_periods=10),
        Stage(period=(("attn_local", "mlp"), ("attn_local", "mlp")), n_periods=1),
    ),
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    window=1024,
    rope_theta=1_000_000.0,
    activation="gelu",
    embed_scale=True,
    attn_shard="kv",
    tie_embeddings=True,
    # 52/62 layers are window-bounded; global layers SP-shard their KV.
    shapes=lm_shapes(long_ok=True),
    source="hf:google/gemma-3-1b-pt; unverified",
)
