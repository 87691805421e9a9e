"""Architecture configuration schema.

Every assigned architecture is a :class:`ModelConfig`: a stack of *stages*,
each stage a repeated *period* of layers, each layer a tuple of sublayer
kinds.  Examples:

* dense transformer:   stages = [ (("attn","mlp"),) × 1 period, n_periods=L ]
* gemma3 5:1 pattern:  period = 5×("attn_local","mlp") + 1×("attn","mlp")
* jamba 1:7 + MoE:     period of 8 mamba/attn layers with alternating moe
* xlstm:               period = 7×("mlstm",) + 1×("slstm",)

``shapes`` lists the assigned (shape-name → ShapeCfg) cells incl. skip flags.
Reduced smoke variants come from :meth:`ModelConfig.tiny`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

Layer = Tuple[str, ...]           # e.g. ("attn", "mlp")
Period = Tuple[Layer, ...]

VALID_SUBLAYERS = {"attn", "attn_local", "mlp", "moe", "mamba", "mlstm", "slstm"}


@dataclasses.dataclass(frozen=True)
class Stage:
    period: Period
    n_periods: int

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"
    skip: bool = False
    skip_reason: str = ""


def lm_shapes(*, long_ok: bool, long_reason: str = "pure full attention") -> Tuple[ShapeCfg, ...]:
    return (
        ShapeCfg("train_4k", 4096, 256, "train"),
        ShapeCfg("prefill_32k", 32768, 32, "prefill"),
        ShapeCfg("decode_32k", 32768, 128, "decode"),
        ShapeCfg(
            "long_500k", 524288, 1, "decode",
            skip=not long_ok,
            skip_reason="" if long_ok else f"long_500k needs sub-quadratic attention; {long_reason}",
        ),
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                                  # dense | moe | hybrid | ssm | audio | vlm
    stages: Tuple[Stage, ...]
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qk_norm: bool = False
    window: Optional[int] = None                 # sliding window for attn_local
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # port-only options (jamba), each off by default; kept out of the repr,
    # which stays the JAX package's
    rope: bool = dataclasses.field(default=True, repr=False)   # False: no positional encoding
    attn_shard: str = "kv"                       # "kv" | "group": which head axis TP shards
    # mlp / norm
    activation: str = "silu"                     # silu (SwiGLU) | gelu (GeGLU)
    norm: str = "rms"                            # rms | nonparametric
    embed_scale: bool = False                    # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # port-only: False keeps the top-k weights as the softmax gave them;
    # dropless: no assignment ever skips its expert; experts_held: the
    # experts this chip holds, a range [lo, hi) of the router's n_experts
    # ids (expert parallelism's share), None for all of them
    moe_renormalize: bool = dataclasses.field(default=True, repr=False)
    moe_dropless: bool = dataclasses.field(default=False, repr=False)
    experts_held: Optional[Tuple[int, int]] = dataclasses.field(default=None, repr=False)
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # port-only: RMSNorm dt, B and C after x_proj (jamba)
    mamba_inner_norm: bool = dataclasses.field(default=False, repr=False)
    # input frontend: "tokens" or "embeddings" (audio/vlm stub frontends)
    input_mode: str = "tokens"
    # dtypes
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # optimizer-state policy (see DESIGN.md): "fp32" | "bf16"
    opt_state_dtype: str = "fp32"
    # assigned shapes
    shapes: Tuple[ShapeCfg, ...] = ()
    source: str = ""

    # ------------------------------------------------------------- derived
    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_held_experts(self) -> int:
        """The experts whose weights this chip holds."""
        if self.experts_held is None:
            return self.n_experts
        lo, hi = self.experts_held
        return hi - lo

    def sublayer_kinds(self) -> set:
        kinds = set()
        for st in self.stages:
            for layer in st.period:
                kinds.update(layer)
        return kinds

    def has_attention(self) -> bool:
        return bool(self.sublayer_kinds() & {"attn", "attn_local"})

    def shape(self, name: str) -> ShapeCfg:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(name)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide"
        for st in self.stages:
            for layer in st.period:
                for sub in layer:
                    assert sub in VALID_SUBLAYERS, sub
        if self.is_moe:
            assert "moe" in self.sublayer_kinds()
        if self.experts_held is not None:
            lo, hi = self.experts_held
            assert 0 <= lo < hi <= self.n_experts, f"experts_held {self.experts_held}"
        assert self.attn_shard in ("kv", "group")

    # --------------------------------------------------------------- param count
    def param_count(self) -> int:
        """Exact parameter count from the config (used for MODEL_FLOPS)."""
        d, Hd = self.d_model, self.head_dim
        H, KVH = self.n_heads, self.n_kv_heads
        n = self.vocab_size * d                      # embeddings (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        counts = {
            "attn": d * H * Hd + 2 * d * KVH * Hd + H * Hd * d
            + (2 * Hd if self.qk_norm else 0) + d,
            "attn_local": d * H * Hd + 2 * d * KVH * Hd + H * Hd * d
            + (2 * Hd if self.qk_norm else 0) + d,
            "mlp": 3 * d * self.d_ff + d,
            "moe": d * self.n_experts
            + 3 * self.n_held_experts * d * self.moe_d_ff + d,
            "mamba": 0,
            "mlstm": 0,
            "slstm": 0,
        }
        di = self.mamba_expand * d
        dr = max(1, d // 16)
        ds = self.mamba_d_state
        counts["mamba"] = (
            d * 2 * di + self.mamba_d_conv * di + di
            + di * (dr + 2 * ds) + dr * di + di + di * ds + di + di * d + d
            + ((dr + 2 * ds) if self.mamba_inner_norm else 0)
        )
        counts["mlstm"] = 3 * d * H * (d // H) + d * H * 2 + H * 2 + H * (d // H) * d + (d // H) + d
        counts["slstm"] = d * 4 * d + d * 4 * d + 4 * d + d * d + d
        for st in self.stages:
            for layer in st.period:
                for sub in layer:
                    n += counts[sub] * st.n_periods
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        moe_total = 0
        for st in self.stages:
            for layer in st.period:
                for sub in layer:
                    if sub == "moe":
                        moe_total += st.n_periods
        dense_equiv = self.param_count() - moe_total * (
            3 * self.n_held_experts * self.d_model * self.moe_d_ff
        )
        return dense_equiv + moe_total * 3 * self.top_k * self.d_model * self.moe_d_ff

    # ---------------------------------------------------------------- tiny
    def tiny(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        small_stages = tuple(
            Stage(period=s.period, n_periods=min(s.n_periods, 1)) for s in self.stages[:2]
        )
        kv = min(self.n_kv_heads, 2)
        heads = kv * min(self.group, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-tiny",
            stages=small_stages,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            mrope_sections=(4, 2, 2) if self.mrope_sections else None,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window=min(self.window, 32) if self.window else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            capacity_factor=4.0,     # drop-free at smoke scale: decode≡prefill
            mamba_d_state=8,
            dtype="float32",
            param_dtype="float32",
            shapes=(
                ShapeCfg("train_tiny", 32, 2, "train"),
                ShapeCfg("prefill_tiny", 32, 2, "prefill"),
                ShapeCfg("decode_tiny", 64, 2, "decode"),
            ),
        )


def dense_stages(n_layers: int) -> Tuple[Stage, ...]:
    return (Stage(period=(("attn", "mlp"),), n_periods=n_layers),)
