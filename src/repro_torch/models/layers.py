"""Model building blocks of every architecture, ported from the JAX
package's ``models/layers.py``.

Plain functions on tensors, with the JAX package's layouts so the two
packages compare like with like:

* activations ``(B, S, D)``; attention heads grouped under their kv head
  for GQA: q is ``(B, S, KVH, G, Hd)``.
* compute dtype from the config (bf16 for the full-size models, float32
  for the tiny ones), params stored in ``cfg.param_dtype``, norms, RoPE,
  attention statistics, softmax, routers and recurrent states in float32.

Norms, RoPE and M-RoPE, GQA attention projections, chunked causal
attention (optionally sliding-window), the GLU MLP, the capacity-bounded
top-k MoE, mamba's selective SSM and the xLSTM blocks (mLSTM, sLSTM).

Port-only options, each off by default (the JAX package has none of
them), for Jamba's published block: attention without positional
encoding (``AttnSpec.rope``), RMSNorms on mamba's dt, B and C after
``x_proj`` (``MambaSpec.inner_norm``), top-k weights left as the softmax
gave them (``MoESpec.renormalize``), a dropless MoE (``MoESpec.dropless``)
and an MoE layer that holds a share of the router's experts
(``MoESpec.held``), as expert parallelism gives each chip.

Sharded compute follows the reference: every activation constraint of
its layers is a ``constrain`` here at the same place with the same
logical axes (a checked identity: one process computes the whole
tensor, ``dist/sharding.py``), and under an activation-sharding context
with a mesh ``moe_apply`` runs the expert-parallel MoE
(``_moe_apply_shard_map``) over a logical mesh: the reference's
``shard_map`` program run as bulk-synchronous stages, every rank in
turn, meeting in ``dist/collectives.py``.  One deliberate difference,
exact up to float rounding: mamba's chunk recurrence is a doubling scan
(``_linear_scan``) where the reference calls ``lax.associative_scan``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..dist.sharding import constrain, current_act_ctx
from ..kernels.moe_decode import moe_decode

Params = Dict[str, Any]

__all__ = [
    "AttnSpec",
    "MambaSpec",
    "MoESpec",
    "XLSTMSpec",
    "apply_mrope",
    "apply_norm",
    "apply_rope",
    "attn_init",
    "attn_output",
    "attn_project_qkv",
    "chunked_causal_attention",
    "glu_mlp",
    "glu_mlp_init",
    "make_norm",
    "mamba_apply",
    "mamba_init",
    "mamba_init_state",
    "mlstm_apply",
    "mlstm_init",
    "mlstm_init_state",
    "moe_apply",
    "moe_init",
    "nonparametric_ln",
    "rms_norm",
    "rope_freqs",
    "slstm_apply",
    "slstm_init",
    "slstm_init_state",
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
# Rotary position embeddings (RoPE / M-RoPE)
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


def apply_mrope(
    x: torch.Tensor,
    positions_3d: torch.Tensor,       # (..., S, 3) — (t, h, w) position ids
    sections: Tuple[int, int, int],   # head_dim/2 split across (t, h, w)
    *,
    theta: float = 10000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: frequency bands split across 3 axes.

    For pure text all three position ids are equal, reducing to 1-D RoPE."""
    head_dim = x.shape[-1]
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not split head_dim {head_dim}")
    freqs = rope_freqs(head_dim, theta, device=x.device)          # (Hd/2,)
    # band assignment: first sections[0] freqs use t, next use h, rest use w
    band = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                      for i, s in enumerate(sections)])            # (Hd/2,)
    angles = positions_3d.float()[..., band] * freqs               # (..., S, Hd/2)
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
    window: Optional[int] = None          # sliding-window size; None = global
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    rope: bool = True                     # False: no positional encoding

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
    positions: torch.Tensor,          # (B, S) or (B, S, 3) for M-RoPE
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,KVH,G,Hd), k (B,S,KVH,Hd), v (B,S,KVH,Hd), with
    optional qk-norm and RoPE (unless ``spec.rope`` is False) applied."""
    B, S, d = x.shape
    KVH, G, Hd = spec.n_kv_heads, spec.group, spec.head_dim
    q = (x @ params["wq"].reshape(d, -1)).reshape(B, S, KVH, G, Hd)
    k = (x @ params["wk"].reshape(d, -1)).reshape(B, S, KVH, Hd)
    v = (x @ params["wv"].reshape(d, -1)).reshape(B, S, KVH, Hd)
    if spec.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    if spec.rope and spec.mrope_sections is not None:
        q = apply_mrope(q, positions[:, :, None, None, :], spec.mrope_sections,
                        theta=spec.rope_theta)
        k = apply_mrope(k, positions[:, :, None, :], spec.mrope_sections,
                        theta=spec.rope_theta)
    elif spec.rope:
        q = apply_rope(q, positions[:, :, None, None], theta=spec.rope_theta)
        k = apply_rope(k, positions[:, :, None], theta=spec.rope_theta)
    if S > 1:  # full-sequence mode: pin batch/head sharding
        q = constrain(q, ("dp", None, "kv", "group", None))
        k = constrain(k, ("dp", None, "kv", None))
        v = constrain(v, ("dp", None, "kv", None))
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
    window: Optional[int] = None,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style causal attention: O(chunk·S) memory, float32 statistics.

    The chunking and the online-softmax update of the reference
    (``layers.py:188``); ``window`` enables sliding-window masking (local
    attention), with the reference's window-limited kv range: query chunk
    i visits kv chunks ``[i - ceil(window/chunk), i]``.  Key chunks after a
    query chunk are skipped: the reference computes them fully masked,
    which leaves its running statistics bit-identical (alpha is exactly 1,
    every p exactly 0).  So are the clamped duplicates it visits before
    chunk 0: their garbage statistics are wiped exactly (alpha 0) by the
    first chunk that holds a valid key."""
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
    base = torch.arange(chunk, device=q.device)
    if window is not None and window < n_chunks * chunk:
        n_kv_steps = min(-(-window // chunk) + 1, n_chunks)
    else:
        n_kv_steps = n_chunks
    outs = []
    for i in range(n_chunks):
        q_i = qc[:, i].float() * scale                              # (B,c,KVH,G,Hd)
        m = torch.full((B, KVH, G, chunk), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KVH, G, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KVH, G, chunk, Hd), dtype=torch.float32, device=q.device)
        q_pos = i * chunk + base
        for j in range(max(0, i - n_kv_steps + 1), i + 1):
            s = torch.einsum("bqkgh,bpkh->bkgqp", q_i, kc[:, j].float())
            s = constrain(s, ("dp", "kv", "group", None, None))
            kv_pos = j * chunk + base
            mask = (q_pos[:, None] >= kv_pos[None, :]) & (kv_pos < S)[None, :]
            if window is not None:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            s = s.masked_fill(~mask, -1e30)
            m_next = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_next[..., None])
            alpha = torch.exp(m - m_next)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqp,bpkh->bkgqh", p, vc[:, j].float())
            acc = constrain(acc, ("dp", "kv", "group", None, None))
            m = m_next
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(acc / l[..., None])                             # (B,KVH,G,c,Hd)
    out = torch.cat(outs, dim=3)[:, :, :, :S]                      # (B,KVH,G,S,Hd)
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)                   # (B,S,KVH,G,Hd)
    return constrain(out, ("dp", None, "kv", "group", None))


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
    h = constrain(act * up, ("dp", None, "model"))
    return h @ params["w_down"]


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-bounded top-k, dispatch within a batch row)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    renormalize: bool = True               # top-k weights rescaled to sum to 1
    dropless: bool = False                 # no assignment skips its expert
    held: Optional[Tuple[int, int]] = None  # router ids [lo, hi) held here; None: all

    @property
    def held_range(self) -> Tuple[int, int]:
        return self.held if self.held is not None else (0, self.n_experts)

    def capacity(self, tokens_per_group: int) -> int:
        """Slots per expert and group of a capacity-bounded layer (a
        dropless layer has none: ``moe_apply`` never routes it to slots)."""
        c = int(math.ceil(tokens_per_group * self.top_k / self.n_experts * self.capacity_factor))
        return max(8, -(-c // 8) * 8)  # round up to 8 for tile alignment


def moe_init(gen: torch.Generator, spec: MoESpec, dtype, device) -> Params:
    """The router over all ``n_experts`` and the FFNs of the held ones."""
    s_in = 1.0 / math.sqrt(spec.d_model)
    s_out = 1.0 / math.sqrt(spec.d_ff)
    E, d, f = spec.n_experts, spec.d_model, spec.d_ff
    lo, hi = spec.held_range
    return {
        "router": _normal(gen, (d, E), s_in, torch.float32, device),
        "w_gate": _normal(gen, (hi - lo, d, f), s_in, dtype, device),
        "w_up": _normal(gen, (hi - lo, d, f), s_in, dtype, device),
        "w_down": _normal(gen, (hi - lo, f, d), s_out, dtype, device),
    }


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)``, the same int64 values, without its range
    check on the CPU, which reads the ids' min and max back to the host (on
    the card the scatter checks them): a step of ours makes no host read
    that a CUDA graph could not capture, on either device."""
    out = torch.zeros(ids.shape + (n,), dtype=torch.int64, device=ids.device)
    return out.scatter_(-1, ids.long().unsqueeze(-1), 1)


def _moe_gates(params: Params, spec: MoESpec, x: torch.Tensor, aux: bool = True):
    """The router's softmax over all ``n_experts`` and its top k: gate
    values and expert ids (B, T, K), renormalized unless
    ``spec.renormalize`` is False, and the per-row aux loss (B,), None
    where ``aux`` is False."""
    E, K = spec.n_experts, spec.top_k
    logits = x.float() @ params["router"]                          # (B,T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)           # (B,T,K)
    if spec.renormalize:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if not aux:
        return gate_vals, expert_ids, None
    # Switch-style load-balance aux
    density = _one_hot(expert_ids[..., 0], E).float().mean(dim=1)
    aux = (density * probs.mean(dim=1)).sum(dim=-1) * E            # (B,)
    return gate_vals, expert_ids, aux


def _moe_route(params: Params, spec: MoESpec, x: torch.Tensor):
    """Router + capacity positions for each batch row's token group.

    x (B, T, D).  Returns gate values (B, T, K), the flat (token-major)
    expert ids and capacity slots (B, T*K), the keep mask (B, T*K), the
    per-row aux loss (B,) and the capacity C; slot C is the drop slot."""
    B, T, _ = x.shape
    E, K = spec.n_experts, spec.top_k
    C = spec.capacity(T)
    gate_vals, expert_ids, aux = _moe_gates(params, spec, x)
    # position within each expert's capacity, in token-major (t, k) order
    sel = _one_hot(expert_ids.reshape(B, T * K), E)                     # (B,T*K,E)
    pos = ((sel.cumsum(dim=1) - sel) * sel).sum(dim=-1)            # (B,T*K)
    flat_e = expert_ids.reshape(B, T * K)
    keep = pos < C
    flat_p = torch.where(keep, pos, torch.full_like(pos, C))
    return gate_vals, flat_e, flat_p, keep, aux, C


def _moe_dispatch(x: torch.Tensor, flat_e, flat_p, E: int, C: int) -> torch.Tensor:
    """(B,T,D) tokens -> (B,E,C,D) capacity slots (scatter within a row);
    dropped assignments land in slot C, which is cut off."""
    B, T, D = x.shape
    K = flat_e.shape[1] // T
    rows = torch.arange(B, device=x.device)[:, None]
    token_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((B, E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[rows, flat_e, flat_p] = x[:, token_idx]
    return buf[:, :, :C]


def _moe_combine(h, flat_e, flat_p, gate_vals, keep, T: int) -> torch.Tensor:
    """(B,E',C,D) expert outputs -> (B,T,D) weighted combine (gather within
    a row).  ``flat_e`` indexes h's expert axis."""
    B, _, C, D = h.shape
    K = flat_e.shape[1] // T
    rows = torch.arange(B, device=h.device)[:, None]
    safe_p = flat_p.clamp_max(C - 1)
    picked = h[rows, flat_e, safe_p].reshape(B, T, K, D)
    w = (gate_vals * keep.reshape(B, T, K).to(gate_vals.dtype)).to(picked.dtype)
    return torch.einsum("btkd,btk->btd", picked, w)


def _held_only(flat_e, flat_p, keep, held: Tuple[int, int], C: int):
    """Routes onto the held experts ``[lo, hi)``: ids made local, and an
    assignment to an absent expert dropped (slot C, keep False), so that
    it adds nothing."""
    lo, hi = held
    here = (flat_e >= lo) & (flat_e < hi)
    keep = keep & here
    return (torch.where(here, flat_e - lo, torch.zeros_like(flat_e)),
            torch.where(keep, flat_p, torch.full_like(flat_p, C)), keep)


def _glu_act(gate: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return torch.nn.functional.silu(gate)
    return torch.nn.functional.gelu(gate, approximate="tanh")


def _moe_expert_ffn(dispatched, w_gate, w_up, w_down, activation: str) -> torch.Tensor:
    """(B,E',C,D) slots through E' experts' GLU FFNs (weights (E',D,F) and
    (E',F,D)) -> (B,E',C,D); one batched product per weight, all rows of an
    expert together."""
    B, E, C, D = dispatched.shape
    xs = dispatched.transpose(0, 1).reshape(E, B * C, D)
    h_gate = torch.bmm(xs, w_gate)
    h_up = torch.bmm(xs, w_up)
    act = _glu_act(h_gate, activation)
    out = torch.bmm(act * h_up, w_down)                            # (E',B*C,D)
    return out.reshape(E, B, C, D).transpose(0, 1)


def _moe_apply_gather(params: Params, spec: MoESpec, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless MoE over many tokens a row (a prefill or a training
    pass): each held expert's FFN runs over just the tokens routed to it,
    gathered, and its gate-weighted output is added back in float32.
    Finding an expert's tokens reads their count to the host, so a decode
    step (one token a row, captured in a CUDA graph) never comes here."""
    B, T, D = x.shape
    K = spec.top_k
    lo, hi = spec.held_range
    gate_vals, expert_ids, aux = _moe_gates(params, spec, x)
    xf = x.reshape(B * T, D)
    ids = expert_ids.reshape(B * T, K)
    gates = gate_vals.reshape(B * T, K)
    out = torch.zeros((B * T, D), dtype=torch.float32, device=x.device)
    for e in range(lo, hi):
        tok, k = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        h = _glu_act(xe @ params["w_gate"][e - lo], spec.activation) * (xe @ params["w_up"][e - lo])
        y = h @ params["w_down"][e - lo]
        out.index_add_(0, tok, y.float() * gates[tok, k][:, None])
    return out.to(x.dtype).reshape(B, T, D), aux.mean()


def _moe_apply_decode(params: Params, spec: MoESpec, x: torch.Tensor,
                      ids_out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, None]:
    """The dropless MoE of a decode step (one token a row): the router's
    top k, then ``kernels.moe_decode``, which reads only the routed held
    experts' weights (the kernel on the card, its plain version on the
    CPU).  ``ids_out`` (B, K) int32, where given, receives the routed ids.
    No aux loss: nothing trains on a decode step, and its ten small
    kernels a layer would lengthen every step."""
    B, _, D = x.shape
    gate_vals, expert_ids, _ = _moe_gates(params, spec, x, aux=False)
    ids = expert_ids.reshape(B, spec.top_k).to(torch.int32)
    if ids_out is not None:
        ids_out.copy_(ids)
    out = moe_decode(x.reshape(B, D), ids, gate_vals.reshape(B, spec.top_k), params["w_gate"],
                     params["w_up"], params["w_down"], held=spec.held_range,
                     activation=spec.activation)
    return out.reshape(B, 1, D), None


def moe_apply(params: Params, spec: MoESpec, x: torch.Tensor,
              ids_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k MoE, capacity-bounded unless dropless; returns (out (B,S,D),
    aux_loss (), None for a dropless decode step).

    Two paths, chosen as the reference chooses (``layers.py:432``):

    * **local**: a capacity-bounded layer takes each batch row as one
      token group, dispatched into per-expert capacity slots, run through
      every held expert's FFN (empty slots give exact zeros) and combined
      with its gate weights.  A dropless layer gathers each expert's
      tokens over more than one token a row (:func:`_moe_apply_gather`)
      and runs a decode step's one token a row through the routed experts
      alone (:func:`_moe_apply_decode`, which writes the routed ids into
      ``ids_out`` where given);
    * **expert-parallel**, when an activation-sharding context with a mesh
      and a model axis is installed: :func:`_moe_apply_shard_map`, which
      takes every expert and a capacity.

    Held experts (``spec.held``): the router keeps its ``n_experts``
    outputs and takes the top k over all of them; an assignment to an
    expert this chip does not hold adds nothing."""
    ctx = current_act_ctx()
    if ctx is not None and ctx.get("mesh") is not None and ctx.get("model"):
        if spec.held is not None or spec.dropless:
            raise ValueError("the expert-parallel MoE takes every expert and a capacity")
        return _moe_apply_shard_map(params, spec, x, ctx)
    T = x.shape[1]
    if spec.dropless:
        if T == 1:
            return _moe_apply_decode(params, spec, x, ids_out)
        return _moe_apply_gather(params, spec, x)
    gate_vals, flat_e, flat_p, keep, aux, C = _moe_route(params, spec, x)
    lo, hi = spec.held_range
    if spec.held is not None:
        flat_e, flat_p, keep = _held_only(flat_e, flat_p, keep, (lo, hi), C)
    dispatched = _moe_dispatch(x, flat_e, flat_p, hi - lo, C)
    h = _moe_expert_ffn(dispatched, params["w_gate"], params["w_up"], params["w_down"],
                        spec.activation)
    out = _moe_combine(h, flat_e, flat_p, gate_vals, keep, T)
    return out.to(x.dtype), aux.mean()


def _rank_blocks(value: Any, sharding) -> Dict[int, torch.Tensor]:
    """Each rank's block of ``value`` under ``sharding``: views of a tensor
    (``addressable_devices_indices_map``; a dimension the spec does not
    divide raises), or a ``ShardedTensor``'s own blocks when it is laid out
    so.  Nothing is copied unless a rank's device differs."""
    from ..dist.placement import ShardedTensor

    if isinstance(value, ShardedTensor):
        pad = lambda spec: tuple(spec) + (None,) * (value.ndim - len(spec))
        if value.sharding.mesh is not sharding.mesh or pad(value.sharding.spec) != pad(sharding.spec):
            raise ValueError(f"{value} is not laid out as {sharding}")
        return {sh.rank: sh.data for sh in value.addressable_shards}
    imap = sharding.addressable_devices_indices_map(value.shape)
    return {r: value[idx].to(sharding.mesh.device_of(r)) for r, idx in imap.items()}


def _moe_apply_shard_map(params: Params, spec: MoESpec, x: torch.Tensor, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert parallelism over the context's logical mesh (the
    reference's ``shard_map`` program, ``layers.py:452``): every rank's
    output block from :func:`_moe_ep_ranks`, assembled by ``x``'s spec from
    the first rank holding each block (with sequence parallelism off the
    replicas along "model" compute the same rows), and ``aux`` as the
    ``pmean`` over "model", then over each data-parallel axis."""
    from ..dist import collectives as col

    x_sharding, outs, auxes = _moe_ep_ranks(params, spec, x, ctx)
    out = x.new_empty(x.shape)
    placed = set()
    for r, index in x_sharding.addressable_devices_indices_map(x.shape).items():
        key = tuple((s.start, s.stop) for s in index)
        if key not in placed:
            placed.add(key)
            out[index] = outs[r].to(out.device, out.dtype)
    mesh = x_sharding.mesh
    aux = col.pmean(auxes, mesh, ctx["model"])
    for ax in tuple(ctx["dp"]) if ctx["dp"] else ():
        aux = col.pmean(aux, mesh, ax)
    return out, aux[0]


def _moe_ep_ranks(params: Params, spec: MoESpec, x: torch.Tensor, ctx):
    """The reference's per-device ``local_fn`` for every rank of the
    context's mesh.  It meets the other devices inside its body, so here it
    runs as bulk-synchronous stages, each stage for every rank before the
    next: (1) each rank's blocks of ``x`` and of the weights (views, no
    copy); (2) the weights all-gathered over the FSDP axis ("data" when the
    mesh has it); (3) routing and dispatch of the rank's flat local tokens
    as one group (capacity per shard); (4) the ``all_to_all`` over "model"
    to the experts' owners; (5) the FFN of the rank's ``E/ep`` experts;
    (6) the reverse ``all_to_all``; (7) the combine.  A dimension that does
    not split over its axes raises, as ``shard_map`` does; nothing falls
    back to the local path.  Returns (``x``'s sharding, {rank: output block
    (Bl, Sl, D)}, {rank: the shard's aux loss})."""
    from ..dist import collectives as col
    from ..dist.placement import NamedSharding, PartitionSpec as P

    mesh = ctx["mesh"]
    model_axis = ctx["model"]
    dp_axes = tuple(ctx["dp"]) if ctx["dp"] else ()
    sp = ctx.get("seq_parallel")
    fsdp_axis = "data" if "data" in mesh.axis_names else None
    E = spec.n_experts
    ep = mesh.shape[model_axis]
    assert E % ep == 0, f"experts {E} must divide EP degree {ep}"

    x_sharding = NamedSharding(mesh, P(dp_axes or None, model_axis if sp else None, None))
    w_in = NamedSharding(mesh, P(model_axis, fsdp_axis, None))       # (E, D, F)
    w_out = NamedSharding(mesh, P(model_axis, None, fsdp_axis))      # (E, F, D)
    xs = _rank_blocks(x, x_sharding)
    router = _rank_blocks(params["router"], NamedSharding(mesh, P(fsdp_axis, None)))
    wg = _rank_blocks(params["w_gate"], w_in)
    wu = _rank_blocks(params["w_up"], w_in)
    wd = _rank_blocks(params["w_down"], w_out)
    if fsdp_axis:
        router = col.all_gather(router, mesh, fsdp_axis, dim=0)
        wg = col.all_gather(wg, mesh, fsdp_axis, dim=1)
        wu = col.all_gather(wu, mesh, fsdp_axis, dim=1)
        wd = col.all_gather(wd, mesh, fsdp_axis, dim=2)

    routes, dispatched = {}, {}
    for r, xl in xs.items():
        Bl, Sl, D = xl.shape
        x_flat = xl.reshape(1, Bl * Sl, D)
        gate_vals, flat_e, flat_p, keep, aux, C = _moe_route({"router": router[r]}, spec, x_flat)
        routes[r] = (gate_vals, flat_e, flat_p, keep, aux[0])
        dispatched[r] = _moe_dispatch(x_flat, flat_e, flat_p, E, C)[0]         # (E, C, D)
    # EP all-to-all: capacity slots travel to their expert's owner rank
    routed = col.all_to_all(dispatched, mesh, model_axis, split_axis=0, concat_axis=1)
    del dispatched                                                 # (E/ep, C*ep, D)
    h = {r: _moe_expert_ffn(t[None], wg[r], wu[r], wd[r], spec.activation)[0]
         for r, t in routed.items()}
    del routed, wg, wu, wd
    back = col.all_to_all(h, mesh, model_axis, split_axis=1, concat_axis=0)   # (E, C, D)
    del h
    outs = {}
    for r, (gate_vals, flat_e, flat_p, keep, _) in routes.items():
        Bl, Sl, D = xs[r].shape
        outs[r] = _moe_combine(back[r][None], flat_e, flat_p, gate_vals, keep,
                               Bl * Sl).reshape(Bl, Sl, D)
    return x_sharding, outs, {r: route[4] for r, route in routes.items()}


# --------------------------------------------------------------------------
# Mamba (S6 selective SSM) — chunked linear recurrence
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    inner_norm: bool = False               # RMSNorm dt, B and C after x_proj

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)


def mamba_init(gen: torch.Generator, spec: MambaSpec, dtype, device) -> Params:
    d, di, ds, dr = spec.d_model, spec.d_inner, spec.d_state, spec.dt_rank
    s = 1.0 / math.sqrt(d)
    si = 1.0 / math.sqrt(di)
    u = torch.rand((di,), generator=gen, device=device, dtype=torch.float32)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    params = {
        "w_in": _normal(gen, (d, 2 * di), s, dtype, device),
        "conv_w": _normal(gen, (spec.d_conv, di), 0.5, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_x_dbc": _normal(gen, (di, dr + 2 * ds), si, dtype, device),
        "w_dt": _normal(gen, (dr, di), 1.0 / math.sqrt(dr), dtype, device),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device))
        .expand(di, ds).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": _normal(gen, (di, d), si, dtype, device),
    }
    if spec.inner_norm:
        params["dt_norm"] = make_norm("rms", dr, dtype, device)
        params["b_norm"] = make_norm("rms", ds, dtype, device)
        params["c_norm"] = make_norm("rms", ds, dtype, device)
    return params


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the recurrence h_t = a_t h_{t-1} + b_t along axis
    1: returns (prod_{s<=t} a_s, h_t from h_{-1} = 0).

    A Hillis–Steele doubling scan of the reference's ``combine`` (its
    ``lax.associative_scan``, ``layers.py:593``): log2(L) passes, each
    combining every element with the one ``d`` steps before it.  The
    value at t depends only on elements <= t, so padding past the end
    changes nothing before it; the products group differently from the
    reference's tree, so results agree up to float rounding."""
    L = a.shape[1]
    d = 1
    while d < L:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _mamba_inner(params: Params, spec: MambaSpec, xz: torch.Tensor, conv_state, ssm_state,
                 *, chunk: int = 256):
    """Core selective scan. xz: (B, S, 2*d_inner).  Returns (y, conv_state,
    ssm_state).  A sequence shorter than ``chunk`` (a decode step) is one
    chunk of its own length."""
    B, S, _ = xz.shape
    di, ds = spec.d_inner, spec.d_state
    xz = constrain(xz, ("dp", None, "model"))
    x, z = xz.chunk(2, dim=-1)                                     # (B,S,di)

    # causal depthwise conv with carried state (d_conv-1 trailing inputs)
    dc = spec.d_conv
    x_pad = torch.cat([conv_state.to(x.dtype), x], dim=1)          # (B, S+dc-1, di)
    new_conv_state = x_pad[:, x_pad.shape[1] - (dc - 1):]
    conv_w = params["conv_w"].float()
    xc = sum(x_pad[:, i : i + S].float() * conv_w[i] for i in range(dc))
    xc = torch.nn.functional.silu(xc + params["conv_b"].float())   # (B,S,di)

    dbc = (xc.to(x.dtype) @ params["w_x_dbc"]).float()
    dt_in, Bmat, Cmat = torch.split(dbc, [spec.dt_rank, ds, ds], dim=-1)
    if spec.inner_norm:
        dt_in = rms_norm(params["dt_norm"], dt_in)
        Bmat = rms_norm(params["b_norm"], Bmat)
        Cmat = rms_norm(params["c_norm"], Cmat)
    dt = torch.nn.functional.softplus(
        (dt_in.to(x.dtype) @ params["w_dt"]).float() + params["dt_bias"]
    )                                                              # (B,S,di)
    A = -torch.exp(params["A_log"])                                # (di,ds)

    # chunked linear recurrence h_t = a_t h_{t-1} + bx_t; padded steps have
    # dt = 0, so a = 1 and bx = 0 and the state passes through unchanged
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bmat = torch.nn.functional.pad(Bmat, (0, 0, 0, pad))
        Cmat = torch.nn.functional.pad(Cmat, (0, 0, 0, pad))
        xc = torch.nn.functional.pad(xc, (0, 0, 0, pad))
    h = ssm_state                                                  # (B,di,ds)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        dt_k, B_k, C_k, xc_k = dt[:, sl], Bmat[:, sl], Cmat[:, sl], xc[:, sl]
        a_c = torch.exp(dt_k[..., None] * A)                       # (B,chunk,di,ds)
        bx_c = (dt_k * xc_k)[..., None] * B_k[:, :, None, :]
        a_sc, b_sc = _linear_scan(a_c, bx_c)
        hs = a_sc * h[:, None] + b_sc                              # (B,chunk,di,ds)
        ys.append((hs * C_k[:, :, None, :]).sum(dim=-1))           # readout folded in
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]                                # (B,S,di)
    y = constrain(y, ("dp", None, "model"))
    y = y + params["D"] * xc[:, :S]
    y = y * torch.nn.functional.silu(z.float())
    return y.to(xz.dtype), new_conv_state, h


MAMBA_PIECE = 4096        # positions a mamba call computes at once; a multiple of its chunk


def mamba_apply(params: Params, spec: MambaSpec, x: torch.Tensor, state=None, *, chunk: int = 256):
    """x: (B,S,D) -> (y, new_state).  state = (conv_state, ssm_state).

    A sequence longer than ``MAMBA_PIECE`` positions (a long prefill) runs
    piece by piece, each from the states the one before left, so the
    float32 activations are a piece's, not the whole sequence's.  The
    states carry over exactly; the result agrees with one call's to
    float32 rounding (the projections multiply a piece's rows at a time)."""
    if state is None:
        state = mamba_init_state(spec, x.shape[0], x.dtype, x.device)
    piece = MAMBA_PIECE
    if piece % chunk:
        raise ValueError(f"MAMBA_PIECE {piece} is not a multiple of chunk {chunk}")
    conv_state, ssm_state = state
    ys = []
    for p0 in range(0, x.shape[1], piece):
        xz = x[:, p0:p0 + piece] @ params["w_in"]
        y, conv_state, ssm_state = _mamba_inner(params, spec, xz, conv_state, ssm_state,
                                                chunk=chunk)
        ys.append(y @ params["w_out"])
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), (conv_state, ssm_state)


def mamba_init_state(spec: MambaSpec, batch: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    conv = torch.zeros((batch, spec.d_conv - 1, spec.d_inner), dtype=dtype, device=device)
    ssm = torch.zeros((batch, spec.d_inner, spec.d_state), dtype=torch.float32, device=device)
    return conv, ssm


# --------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory, chunkwise) and sLSTM (scalar, loop)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    d_model: int
    n_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def mlstm_init(gen: torch.Generator, spec: XLSTMSpec, dtype, device) -> Params:
    d, H, Hd = spec.d_model, spec.n_heads, spec.head_dim
    s = 1.0 / math.sqrt(d)
    b_if = torch.zeros((H, 2), dtype=torch.float32, device=device)
    b_if[:, 1] = 3.0
    return {
        "wq": _normal(gen, (d, H, Hd), s, dtype, device),
        "wk": _normal(gen, (d, H, Hd), s, dtype, device),
        "wv": _normal(gen, (d, H, Hd), s, dtype, device),
        "w_if": _normal(gen, (d, H, 2), s, torch.float32, device),
        "b_if": b_if,
        "wo": _normal(gen, (H, Hd, d), 1.0 / math.sqrt(d), dtype, device),
        "out_norm": make_norm("rms", Hd, dtype, device),
    }


def mlstm_apply(params: Params, spec: XLSTMSpec, x: torch.Tensor, state=None, *, chunk: int = 128):
    """Chunkwise mLSTM (matrix memory C, normalizer n, max-stabilizer m).

    Within a chunk: quadratic (attention-like) path with a log-space decay
    matrix.  Across chunks: recurrent (C, n, m) carry — O(1) state per
    head.  A sequence shorter than ``chunk`` (a decode step) is one chunk
    of its own length; padded steps have log input gate -1e30 and log
    forget gate 0, so they add nothing to the state.
    x: (B,S,D) -> (y, new_state)."""
    B, S, D = x.shape
    H, Hd = spec.n_heads, spec.head_dim
    if state is None:
        state = mlstm_init_state(spec, B, x.device)
    C_prev, n_prev, m_prev = state                            # (B,H,Hd,Hd),(B,H,Hd),(B,H)

    def heads(w):
        return (x @ w.reshape(D, -1)).reshape(B, S, H, -1).float()

    q = heads(params["wq"]) / math.sqrt(Hd)
    k = heads(params["wk"])
    v = heads(params["wv"])
    q = constrain(q, ("dp", None, "model", None))
    k = constrain(k, ("dp", None, "model", None))
    v = constrain(v, ("dp", None, "model", None))
    if_ = (x.float() @ params["w_if"].reshape(D, -1)).reshape(B, S, H, 2) + params["b_if"]
    log_i = -torch.nn.functional.softplus(-if_[..., 0])       # (B,S,H)
    log_f = -torch.nn.functional.softplus(-if_[..., 1])

    L = min(chunk, S)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        log_i = torch.nn.functional.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = torch.nn.functional.pad(log_f, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        q_c, k_c, v_c, li_c, lf_c = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], log_f[:, sl]
        b_dec = lf_c.cumsum(dim=1)                            # (B,L,H) decay from chunk start
        # intra-chunk log weights: D[t,s] = sum_{s<r<=t} f_r + i_s
        log_D = b_dec[:, :, None, :] - b_dec[:, None, :, :] + li_c[:, None, :, :]  # (B,t,s,H)
        log_D = log_D.masked_fill(~tri[None, :, :, None], -math.inf)
        # stabilizer: m_t = max(m_prev + cumf, max_s log_D[t,s])
        m_inter = m_prev[:, None, :] + b_dec                  # (B,L,H)
        m_t = torch.maximum(m_inter, log_D.amax(dim=2)).clamp_min(-1e30)

        # inter-chunk contribution: q_t · C_prev, scaled exp(m_prev + cumf - m_t)
        w_inter = torch.exp(m_inter - m_t)
        y_inter = torch.einsum("blhe,bhef->blhf", q_c, C_prev) * w_inter[..., None]
        n_inter = torch.einsum("blhe,bhe->blh", q_c, n_prev) * w_inter

        # intra-chunk: scores q_t·k_s with weight exp(log_D - m_t)
        sw = torch.einsum("blhe,bshe->blsh", q_c, k_c) * torch.exp(log_D - m_t[:, :, None, :])
        y_intra = torch.einsum("blsh,bshf->blhf", sw, v_c)
        n_intra = sw.sum(dim=2)                               # (B,L,H)

        denom = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_t))
        ys.append((y_inter + y_intra) / denom[..., None])     # (B,L,H,Hd)

        # state update to end of chunk
        f_total = b_dec[:, -1]                                # (B,H)
        tail = li_c + (f_total[:, None] - b_dec)              # i_s + f_{s+1..L}
        m_next = torch.maximum(m_prev + f_total, tail.amax(dim=1))
        w_kv = torch.exp(tail - m_next[:, None])              # (B,L,H)
        carry = torch.exp(m_prev + f_total - m_next)
        C_prev = C_prev * carry[..., None, None] + torch.einsum(
            "blhe,blhf->bhef", k_c * w_kv[..., None], v_c)
        n_prev = n_prev * carry[..., None] + torch.einsum("blhe,blh->bhe", k_c, w_kv)
        C_prev = constrain(C_prev, ("dp", "model", None, None))
        m_prev = m_next
    y = torch.cat(ys, dim=1)[:, :S]
    y = rms_norm(params["out_norm"], y.to(x.dtype))
    out = y.reshape(B, S, -1) @ params["wo"].reshape(H * Hd, D)
    return out, (C_prev, n_prev, m_prev)


def mlstm_init_state(spec: XLSTMSpec, batch: int, device):
    H, Hd = spec.n_heads, spec.head_dim
    return (
        torch.zeros((batch, H, Hd, Hd), dtype=torch.float32, device=device),
        torch.zeros((batch, H, Hd), dtype=torch.float32, device=device),
        torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
    )


def slstm_init(gen: torch.Generator, spec: XLSTMSpec, dtype, device) -> Params:
    d = spec.d_model
    s = 1.0 / math.sqrt(d)
    b_gates = torch.zeros((4 * d,), dtype=torch.float32, device=device)
    b_gates[2 * d : 3 * d] = 3.0
    return {
        "w_gates": _normal(gen, (d, 4 * d), s, dtype, device),
        "r_gates": _normal(gen, (d, 4 * d), s * 0.5, dtype, device),
        "b_gates": b_gates,
        "w_out": _normal(gen, (d, d), s, dtype, device),
    }


def slstm_apply(params: Params, spec: XLSTMSpec, x: torch.Tensor, state=None):
    """sLSTM with exponential gating + (c, n, m, h) stabilized state.

    A sequential loop over time (scalar state), as in the paper.
    x: (B,S,D) -> (y, new_state)."""
    B, S, D = x.shape
    if state is None:
        state = slstm_init_state(spec, B, x.device)
    c, n, m, h = state
    wx = (x @ params["w_gates"]).float()                     # (B,S,4D)
    wx = constrain(wx, ("dp", None, "model"))
    hs = []
    for t in range(S):
        rec = (h.to(x.dtype) @ params["r_gates"]).float()
        g = wx[:, t] + rec + params["b_gates"]
        zi, ii, fi, oi = g.chunk(4, dim=-1)
        z = torch.tanh(zi)
        o = torch.sigmoid(oi)
        log_f = -torch.nn.functional.softplus(-fi)
        m_new = torch.maximum(log_f + m, ii)
        i_g = torch.exp(ii - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        m = m_new
        h = o * c / n.abs().clamp_min(1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,D)
    return y @ params["w_out"], (c, n, m, h)


def slstm_init_state(spec: XLSTMSpec, batch: int, device):
    D = spec.d_model
    z = torch.zeros((batch, D), dtype=torch.float32, device=device)
    return (z, z.clone(), torch.full((batch, D), -1e30, dtype=torch.float32, device=device),
            z.clone())
