"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM periods); no separate FFN (d_ff=0,
blocks carry their own projections).  [arXiv:2405.04517; unverified]
"""
from .base import ModelConfig, Stage, lm_shapes

_PERIOD = (
    ("mlstm",),
    ("mlstm",),
    ("mlstm",),
    ("mlstm",),
    ("mlstm",),
    ("mlstm",),
    ("mlstm",),
    ("slstm",),
)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    stages=(Stage(period=_PERIOD, n_periods=6),),
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    activation="silu",
    attn_shard="kv",
    tie_embeddings=True,
    # Pure recurrent state (O(1) per token): long_500k runs.
    shapes=lm_shapes(long_ok=True),
    source="arXiv:2405.04517; unverified",
)
