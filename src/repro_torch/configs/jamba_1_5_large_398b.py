"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.

Mamba+attention 1:7 interleave (1 attn per 8-layer period), MoE every other
layer.  72 = 9 periods of 8.  [arXiv:2403.19887; hf]
"""
from .base import ModelConfig, Stage, lm_shapes

_PERIOD = (
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("attn", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    stages=(Stage(period=_PERIOD, n_periods=9),),
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    activation="silu",
    attn_shard="kv",
    tie_embeddings=False,
    opt_state_dtype="bf16",          # 398B: see DESIGN.md memory policy
    # SSM-dominated; only 9 attention layers hold KV -> long_500k runs.
    shapes=lm_shapes(long_ok=True),
    source="arXiv:2403.19887; hf",
)
