"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (input_mode =
"embeddings").  [arXiv:2306.05284; hf]
"""
from .base import ModelConfig, dense_stages, lm_shapes

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    stages=dense_stages(48),
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    attn_shard="kv",
    tie_embeddings=False,
    input_mode="embeddings",
    shapes=lm_shapes(long_ok=False),
    source="arXiv:2306.05284; hf",
)
