"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

M-RoPE (3-D position ids), dynamic resolution; the vision frontend is a
STUB — ``input_specs()`` provides precomputed patch embeddings.
[arXiv:2409.12191; hf]
"""
from .base import ModelConfig, dense_stages, lm_shapes

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    stages=dense_stages(28),
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope_sections=(16, 24, 24),     # head_dim/2 = 64 split over (t, h, w)
    activation="silu",
    attn_shard="group",              # kv=2: TP shards the 6 q-head groups
    tie_embeddings=True,
    input_mode="embeddings",
    shapes=lm_shapes(long_ok=False),
    source="arXiv:2409.12191; hf",
)
