"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936.

MoE 128 experts top-8 (fine-grained, d_ff=768 per expert), qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ModelConfig, Stage, lm_shapes

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    stages=(Stage(period=(("attn", "moe"),), n_periods=48),),
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    activation="silu",
    attn_shard="kv",                 # kv=4 over 16-way TP: padded; see §Perf
    tie_embeddings=False,
    shapes=lm_shapes(long_ok=False),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
