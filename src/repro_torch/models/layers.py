"""Dense model building blocks, ported from the JAX package's
``models/layers.py``.

Plain functions on tensors, with the JAX package's layouts so the two
packages compare like with like:

* activations ``(B, S, D)``; attention heads grouped under their kv head
  for GQA: q is ``(B, S, KVH, G, Hd)``.
* compute dtype from the config (bf16 for the full-size models, float32
  for the tiny ones), params stored in ``cfg.param_dtype``, norms, RoPE,
  attention statistics and softmax in float32.

Only the dense subset is here: norms, 1-D RoPE, GQA attention projections,
chunked causal attention and the GLU MLP.  There is one device, so the
reference's sharding constraints have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]

__all__ = [
    "AttnSpec",
    "apply_norm",
    "apply_rope",
    "attn_init",
    "attn_output",
    "attn_project_qkv",
    "chunked_causal_attention",
    "glu_mlp",
    "glu_mlp_init",
    "make_norm",
    "nonparametric_ln",
    "rms_norm",
    "rope_freqs",
]


def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float, dtype, device) -> torch.Tensor:
    """Standard normals times ``scale`` in float32, stored as ``dtype``."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(params: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def nonparametric_ln(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style LayerNorm without learnable scale/bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(kind: str, dim: int, dtype, device) -> Params:
    if kind == "rms":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(params, x)
    if kind == "nonparametric":
        return nonparametric_ln(x)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Rotary position embeddings (1-D)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, Hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # (Hd/2,)
    angles = positions[..., None].float() * freqs                  # (..., S, Hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


def attn_init(gen: torch.Generator, spec: AttnSpec, dtype, device) -> Params:
    d, H, KVH, Hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    scale = 1.0 / math.sqrt(d)
    params = {
        "wq": _normal(gen, (d, KVH, spec.group, Hd), scale, dtype, device),
        "wk": _normal(gen, (d, KVH, Hd), scale, dtype, device),
        "wv": _normal(gen, (d, KVH, Hd), scale, dtype, device),
        "wo": _normal(gen, (KVH, spec.group, Hd, d), 1.0 / math.sqrt(H * Hd), dtype, device),
    }
    if spec.qk_norm:
        params["q_norm"] = make_norm("rms", Hd, dtype, device)
        params["k_norm"] = make_norm("rms", Hd, dtype, device)
    return params


def attn_project_qkv(
    params: Params,
    spec: AttnSpec,
    x: torch.Tensor,                  # (B, S, D)
    positions: torch.Tensor,          # (B, S)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,KVH,G,Hd), k (B,S,KVH,Hd), v (B,S,KVH,Hd), with RoPE
    and optional qk-norm applied."""
    B, S, d = x.shape
    KVH, G, Hd = spec.n_kv_heads, spec.group, spec.head_dim
    q = (x @ params["wq"].reshape(d, -1)).reshape(B, S, KVH, G, Hd)
    k = (x @ params["wk"].reshape(d, -1)).reshape(B, S, KVH, Hd)
    v = (x @ params["wv"].reshape(d, -1)).reshape(B, S, KVH, Hd)
    if spec.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    q = apply_rope(q, positions[:, :, None, None], theta=spec.rope_theta)
    k = apply_rope(k, positions[:, :, None], theta=spec.rope_theta)
    return q, k, v


def attn_output(params: Params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx: (B, S, KVH, G, Hd) -> (B, S, D)."""
    B, S = ctx.shape[:2]
    wo = params["wo"]
    return ctx.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def chunked_causal_attention(
    q: torch.Tensor,                  # (B, S, KVH, G, Hd)
    k: torch.Tensor,                  # (B, S, KVH, Hd)
    v: torch.Tensor,                  # (B, S, KVH, Hd)
    *,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style causal attention: O(chunk·S) memory, float32 statistics.

    The chunking and the online-softmax update of the reference
    (``layers.py:188``).  Key chunks after a query chunk are skipped: the
    reference computes them fully masked, which leaves its running
    statistics bit-identical (alpha is exactly 1, every p exactly 0)."""
    B, S, KVH, G, Hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Hd)
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qc = q.reshape(B, n_chunks, chunk, KVH, G, Hd)
    kc = k.reshape(B, n_chunks, chunk, KVH, Hd)
    vc = v.reshape(B, n_chunks, chunk, KVH, Hd)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    base = torch.arange(chunk, device=q.device)
    outs = []
    for i in range(n_chunks):
        q_i = qc[:, i].float() * scale                              # (B,c,KVH,G,Hd)
        m = torch.full((B, KVH, G, chunk), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KVH, G, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KVH, G, chunk, Hd), dtype=torch.float32, device=q.device)
        q_pos = i * chunk + base
        for j in range(i + 1):
            s = torch.einsum("bqkgh,bpkh->bkgqp", q_i, kc[:, j].float())
            kv_pos = j * chunk + base
            mask = (q_pos[:, None] >= kv_pos[None, :]) & (kv_pos < S)[None, :]
            s = torch.where(mask, s, neg)
            m_next = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_next[..., None])
            alpha = torch.exp(m - m_next)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqp,bpkh->bkgqh", p, vc[:, j].float())
            m = m_next
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(acc / l[..., None])                             # (B,KVH,G,c,Hd)
    out = torch.cat(outs, dim=3)[:, :, :, :S]                      # (B,KVH,G,S,Hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)                  # (B,S,KVH,G,Hd)


# --------------------------------------------------------------------------
# MLPs (GLU family)
# --------------------------------------------------------------------------
def glu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device) -> Params:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": _normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w_up": _normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w_down": _normal(gen, (d_ff, d_model), s_out, dtype, device),
    }


def glu_mlp(params: Params, x: torch.Tensor, *, activation: str = "silu") -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if activation == "silu":       # SwiGLU
        act = torch.nn.functional.silu(gate)
    elif activation == "gelu":     # GeGLU (gemma)
        act = torch.nn.functional.gelu(gate, approximate="tanh")
    else:
        raise ValueError(activation)
    return (act * up) @ params["w_down"]
