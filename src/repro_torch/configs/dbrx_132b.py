"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]
"""
from .base import ModelConfig, Stage, lm_shapes

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    stages=(Stage(period=(("attn", "moe"),), n_periods=40),),
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    moe_d_ff=10752,
    activation="silu",
    attn_shard="kv",
    tie_embeddings=False,
    opt_state_dtype="bf16",          # 132B: fp32 m/v would not fit one pod
    shapes=lm_shapes(long_ok=False),
    source="hf:databricks/dbrx-base; unverified",
)
