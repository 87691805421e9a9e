"""Pattern-based model builder for every architecture, ported from the JAX
package's ``models/model.py``.

A model is a stack of *stages*; each stage repeats a *period* of layers
``n_periods`` times, with its params stacked over periods (the JAX
package's ``lax.scan`` layout; here a Python loop over the stacked
params).  A layer is a tuple of sublayers, each pre-normed + residual:

    attn / attn_local   GQA attention (qk-norm, RoPE / M-RoPE or none, sliding window)
    mlp                 GLU MLP (SwiGLU / GeGLU)
    moe                 top-k mixture of experts: capacity-bounded or dropless,
                        all the router's experts or a held share of them
    mamba               S6 selective SSM (chunked doubling scan; optional
                        dt/B/C RMSNorms)
    mlstm / slstm       xLSTM blocks

Three modes share one code path:

    train    — ``forward`` / ``loss_fn``: the whole sequence, no cache,
               each period rematerialized in the backward pass
    prefill  — as train, but K/V and recurrent states written to the cache
    decode   — one token per sequence, reading and writing the cache

A cache is either *dense* (``init_cache``: per sublayer, tensors stacked
over periods, ``(N_periods, B, ...)``: K/V of ``max_seq`` positions, an
``attn_local`` ring buffer of ``window`` positions, or a recurrent state)
or *paged* (built by ``serve.Engine``: the page pool's stacked ``(N_periods,
P, psz, KVH, Hd)`` K/V tensors plus a page table, and the sessions'
recurrent states).  Cache writes are in place, where the JAX package
rebinds donated arrays: K/V into the pool or dense cache, and a recurrent
sublayer's new state into its period's slot of the stacked entry, which
must therefore belong to this call alone (the engine builds it afresh for
every step).  Paged decode reads global layers' K/V through the
``paged_attention`` kernel and local layers' through a masked gather
(``_paged_window_fix``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.deltacr import resolve_device
from ..dist.sharding import constrain
from ..kernels import ops as kops
from . import layers as L

Params = Dict[str, Any]
Cache = Dict[str, Any]

__all__ = ["Model", "Params", "Cache", "RECURRENT_KINDS"]

RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


# --------------------------------------------------------------------------
# Sublayer dispatch
# --------------------------------------------------------------------------
def _attn_spec(cfg: ModelConfig, kind: str) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm,
        window=cfg.window if kind == "attn_local" else None,
        rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
        rope=cfg.rope,
    )


def _moe_spec(cfg: ModelConfig) -> L.MoESpec:
    return L.MoESpec(
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        activation=cfg.activation,
        renormalize=cfg.moe_renormalize,
        dropless=cfg.moe_dropless,
        held=cfg.experts_held,
    )


def _mamba_spec(cfg: ModelConfig) -> L.MambaSpec:
    return L.MambaSpec(
        d_model=cfg.d_model,
        d_state=cfg.mamba_d_state,
        d_conv=cfg.mamba_d_conv,
        expand=cfg.mamba_expand,
        inner_norm=cfg.mamba_inner_norm,
    )


def _xlstm_spec(cfg: ModelConfig) -> L.XLSTMSpec:
    return L.XLSTMSpec(d_model=cfg.d_model, n_heads=cfg.n_heads)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _unbind(tree: Any, n: int) -> list:
    """The ``n`` periods of a tree of tensors stacked over periods: one
    ``unbind(0)`` per leaf.  Under autograd its backward stacks the
    periods' gradients once, where indexing each period (``t[r]``) would
    materialize a zero tensor the size of the whole stack per period."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(n)]
    return tree.unbind(0)


def _stack_into(dst: Any, src: Any, r: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, r)
        else:
            dst[k][r].copy_(v)


def _empty_stacked(tree: Any, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _empty_stacked(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)


def _init_sublayer(kind: str, gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dtype = _dtype(cfg.param_dtype)
    params: Params = {"norm": L.make_norm(cfg.norm, cfg.d_model, dtype, device)}
    if kind in ("attn", "attn_local"):
        params["body"] = L.attn_init(gen, _attn_spec(cfg, kind), dtype, device)
    elif kind == "mlp":
        params["body"] = L.glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif kind == "moe":
        params["body"] = L.moe_init(gen, _moe_spec(cfg), dtype, device)
    elif kind == "mamba":
        params["body"] = L.mamba_init(gen, _mamba_spec(cfg), dtype, device)
    elif kind == "mlstm":
        params["body"] = L.mlstm_init(gen, _xlstm_spec(cfg), dtype, device)
    elif kind == "slstm":
        params["body"] = L.slstm_init(gen, _xlstm_spec(cfg), dtype, device)
    else:
        raise ValueError(kind)
    return params


def init_cache_entry(
    kind: str, cfg: ModelConfig, batch: int, max_seq: int, device
) -> Optional[Dict[str, torch.Tensor]]:
    """One sublayer's cache for ``batch`` sequences (fresh tensors), or
    None for a stateless sublayer (mlp, moe)."""
    dtype = _dtype(cfg.dtype)
    KVH, Hd = cfg.n_kv_heads, cfg.head_dim
    if kind in ("attn", "attn_local"):
        W = max_seq if kind == "attn" else min(cfg.window or max_seq, max_seq)
        return {
            "k": torch.zeros((batch, W, KVH, Hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, W, KVH, Hd), dtype=dtype, device=device),
        }
    if kind == "mamba":
        conv, ssm = L.mamba_init_state(_mamba_spec(cfg), batch, dtype, device)
        return {"conv": conv, "ssm": ssm}
    if kind == "mlstm":
        C, n, m = L.mlstm_init_state(_xlstm_spec(cfg), batch, device)
        return {"C": C, "n": n, "m": m}
    if kind == "slstm":
        c, n, m, h = L.slstm_init_state(_xlstm_spec(cfg), batch, device)
        return {"c": c, "n": n, "m": m, "h": h}
    return None


def stacked_cache_entry(kind: str, cfg: ModelConfig, n_periods: int, batch: int,
                        max_seq: int, device) -> Optional[Dict[str, torch.Tensor]]:
    """``init_cache_entry`` repeated over ``n_periods`` periods:
    ``(N, batch, ...)`` tensors of their own (written in place)."""
    entry = init_cache_entry(kind, cfg, batch, max_seq, device)
    if entry is None:
        return None
    return {k: v.unsqueeze(0).repeat((n_periods,) + (1,) * v.dim()) for k, v in entry.items()}


def _positions_for(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """pos (B,S) -> RoPE positions; M-RoPE text mode replicates over axes."""
    if cfg.mrope_sections is not None:
        return torch.stack([pos, pos, pos], dim=-1)
    return pos


# --------------------------------------------------------------------------
# Attention over caches (decode path)
# --------------------------------------------------------------------------
def _masked_softmax_attend(q, k, v, mask, scale, eq_s: str, eq_o: str, s_axes=None):
    """float32 scores of ``q * scale`` against ``k`` (constrained to the
    logical ``s_axes`` when given), masked to -1e30, softmax over the key
    axis, values; in q's dtype."""
    s = torch.einsum(eq_s, q.float() * scale, k.float())
    if s_axes is not None:
        s = constrain(s, s_axes)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq_o, p, v.float()).to(q.dtype)


def _decode_attend_full(q, cache_k, cache_v, lens, scale):
    """q (B,1,KVH,G,Hd); cache (B,S,KVH,Hd); lens (B,) incl. current token."""
    S = cache_k.shape[1]
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]      # (B,S)
    # decode caches are sequence-sharded; heads stay unsharded here
    return _masked_softmax_attend(q, cache_k, cache_v, mask[:, None, None, None, :], scale,
                                  "bqkgh,bskh->bkgqs", "bkgqs,bskh->bqkgh",
                                  s_axes=("dp", None, None, None, "seq"))


def _decode_attend_ring(q, cache_k, cache_v, lens, scale):
    """Ring-buffer attention: slot j valid iff it holds a position in
    (len-window, len), i.e. iff it was written."""
    W = cache_k.shape[1]
    filled = torch.clamp(lens[:, None], max=W)                             # slots written
    mask = torch.arange(W, device=q.device)[None, :] < filled
    return _masked_softmax_attend(q, cache_k, cache_v, mask[:, None, None, None, :], scale,
                                  "bqkgh,bskh->bkgqs", "bkgqs,bskh->bqkgh")


def _paged_window_fix(q, pk, pv, table, lens, window, scale):
    """Sliding-window attention over the paged pool (mask-based): the pool
    keeps the whole history, so the window is enforced by the mask.
    q (B,KVH,G,Hd); lens (B,) incl. the current token."""
    k = pk[table.long()]                                                  # (B,maxp,psz,KVH,Hd)
    v = pv[table.long()]
    B, maxp, psz = k.shape[:3]
    S = maxp * psz
    k = k.reshape(B, S, k.shape[3], k.shape[4])
    v = v.reshape(B, S, v.shape[3], v.shape[4])
    posn = torch.arange(S, device=q.device)[None, :]
    mask = (posn < lens[:, None]) & (posn >= (lens - window)[:, None])
    return _masked_softmax_attend(q, k, v, mask[:, None, None, :], scale,
                                  "bkgh,bskh->bkgs", "bkgs,bskh->bkgh")


def _full_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b, 0], in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)


def _ring_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache[b, pos[b] % W] = new[b, 0], in place."""
    _full_write(cache, new, pos % cache.shape[1])


def _apply_attn_paged(
    body: Params,
    spec: L.AttnSpec,
    q: torch.Tensor,                  # (B,S,KVH,G,Hd)
    k: torch.Tensor,                  # (B,S,KVH,Hd)
    v: torch.Tensor,
    mode: str,
    cache: Dict[str, torch.Tensor],   # {"pk": (P,psz,KVH,Hd), "pv": ..., "table": (B,maxp)}
    lens: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Attention through the CoW page pool (serving runtime data plane).

    The engine guarantees that, before this step, every session's write
    target pages are exclusively owned (CoW privatization happens
    host-side via ``kernels.page_copy_stacked``); writes here are plain
    in-place scatters into the pool."""
    pk, pv, table = cache["pk"], cache["pv"], cache["table"]
    psz = pk.shape[1]
    B, S = k.shape[0], k.shape[1]
    if mode == "decode":
        assert lens is not None and S == 1
        page = table.gather(1, (lens // psz)[:, None].long())[:, 0].long()
        slot = (lens % psz).long()
        pk[page, slot] = k[:, 0].to(pk.dtype)
        pv[page, slot] = v[:, 0].to(pv.dtype)
        if spec.window is not None:
            ctx = _paged_window_fix(q[:, 0], pk, pv, table, lens + 1, spec.window, scale)
        else:
            ctx = kops.paged_attention(q[:, 0].contiguous(), pk, pv, table, lens + 1, scale=scale)
        ctx = ctx[:, None]                                            # (B,1,KVH,G,Hd)
    else:  # prefill: compute causally, then scatter K/V into the pages
        ctx = L.chunked_causal_attention(q, k, v, window=spec.window, scale=scale)
        n_pages = -(-S // psz)
        pad = n_pages * psz - S
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kp = k.reshape(B, n_pages, psz, k.shape[2], k.shape[3])
        vp = v.reshape(B, n_pages, psz, v.shape[2], v.shape[3])
        pages = table[:, :n_pages].long()
        pk[pages] = kp.to(pk.dtype)
        pv[pages] = vp.to(pv.dtype)
    return L.attn_output(body, ctx)


def _apply_attn(kind, params, cfg, h, pos, mode, cache, lens) -> torch.Tensor:
    spec = _attn_spec(cfg, kind)
    q, k, v = L.attn_project_qkv(params["body"], spec, h, _positions_for(cfg, pos))
    scale = 1.0 / math.sqrt(spec.head_dim)
    if cache is not None and "pk" in cache:
        return _apply_attn_paged(params["body"], spec, q, k, v, mode, cache, lens, scale)
    if mode == "decode":
        assert cache is not None and lens is not None
        if kind == "attn_local":
            _ring_write(cache["k"], k, lens)
            _ring_write(cache["v"], v, lens)
            ctx = _decode_attend_ring(q, cache["k"], cache["v"], lens + 1, scale)
        else:
            _full_write(cache["k"], k, lens)
            _full_write(cache["v"], v, lens)
            ctx = _decode_attend_full(q, cache["k"], cache["v"], lens + 1, scale)
    else:
        ctx = L.chunked_causal_attention(q, k, v, window=spec.window, scale=scale)
        if mode == "prefill":
            assert cache is not None
            S = k.shape[1]
            if kind == "attn_local":
                W = cache["k"].shape[1]
                take = min(W, S)
                idx = torch.arange(S - take, S, device=k.device) % W
                cache["k"][:, idx] = k[:, S - take:].to(cache["k"].dtype)
                cache["v"][:, idx] = v[:, S - take:].to(cache["v"].dtype)
            else:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
    return L.attn_output(params["body"], ctx)


def _apply_sublayer(
    kind: str,
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                  # (B,S,D)
    pos: torch.Tensor,                # (B,S) absolute positions
    mode: str,                        # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]],
    lens: Optional[torch.Tensor],     # (B,) tokens already in cache (decode)
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Optional[torch.Tensor]]:
    """Returns (residual delta, new recurrent state or None, aux loss or
    None).  Attention caches are updated in place; a recurrent state is
    returned as new tensors, never written through ``cache``."""
    h = L.apply_norm(cfg.norm, params["norm"], x)
    if kind in ("attn", "attn_local"):
        return _apply_attn(kind, params, cfg, h, pos, mode, cache, lens), None, None
    if kind == "mlp":
        return L.glu_mlp(params["body"], h, activation=cfg.activation), None, None
    if kind == "moe":
        # a decode program's dropless MoE sublayer has a (B, K) buffer for
        # the step's routed ids
        ids_out = cache["ids"] if cache is not None else None
        out, aux = L.moe_apply(params["body"], _moe_spec(cfg), h, ids_out)
        return out, None, aux
    if kind == "mamba":
        state = (cache["conv"], cache["ssm"]) if cache is not None else None
        out, (conv, ssm) = L.mamba_apply(params["body"], _mamba_spec(cfg), h, state)
        return out, {"conv": conv, "ssm": ssm}, None
    if kind == "mlstm":
        state = (cache["C"], cache["n"], cache["m"]) if cache is not None else None
        out, (C, n, m) = L.mlstm_apply(params["body"], _xlstm_spec(cfg), h, state)
        return out, {"C": C, "n": n, "m": m}, None
    if kind == "slstm":
        state = (cache["c"], cache["n"], cache["m"], cache["h"]) if cache is not None else None
        out, (c, n, m, hh) = L.slstm_apply(params["body"], _xlstm_spec(cfg), h, state)
        return out, {"c": c, "n": n, "m": m, "h": hh}, None
    raise ValueError(kind)


def _apply_period(cfg: ModelConfig, period, period_params: Params, x: torch.Tensor,
                  pos: torch.Tensor, mode: str, period_cache: Dict[str, Any],
                  lens: Optional[torch.Tensor]):
    """One period's sublayers over ``x``.  Returns (x, {tag: new recurrent
    state} (empty in train mode), summed aux loss or None)."""
    aux = None
    states: Dict[str, Any] = {}
    for li, layer in enumerate(period):
        for si, kind in enumerate(layer):
            tag = f"l{li}_s{si}_{kind}"
            delta, state, aux_d = _apply_sublayer(
                kind, period_params[tag], cfg, x, pos, mode, period_cache.get(tag), lens
            )
            x = x + delta.to(x.dtype)
            if x.shape[1] > 1:
                x = constrain(x, ("dp", "sp", None))
            if aux_d is not None:
                aux = aux_d if aux is None else aux + aux_d
            if state is not None and mode != "train":
                states[tag] = state
    return x, states, aux


def _chunk_loss(hc: torch.Tensor, yc: torch.Tensor, head: torch.Tensor):
    """Summed next-token NLL and target count of one loss chunk: hidden
    (B, c, D), labels (B, c) (-1: no target), float32 head (V, D)."""
    logits = constrain(hc.float() @ head.T, ("dp", None, "model"))  # (B,c,V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yc.clamp_min(0).long()[..., None])[..., 0]
    valid = (yc >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------
class Model:
    """One architecture config with its weights on one device.

    ``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to run on the CPU.  ``params`` is the JAX package's
    params tree as tensors (see ``core.convert.params_from_numpy``), or
    ``init(generator)`` draws random ones."""

    def __init__(self, cfg: ModelConfig, *, device: Any = None, params: Optional[Params] = None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)
        self.params: Optional[Params] = params
        # sqrt(d_model) rounded to the activation dtype, as a Python float:
        # the product is the reference's (a 0-d tensor of that dtype) bit
        # for bit, and the step uploads no scalar tensor (a CUDA graph
        # cannot capture that copy)
        self._embed_scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=self.dtype))

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> Params:
        """``draw(generator)``, bound as the model's weights."""
        self.params = self.draw(generator)
        return self.params

    def draw(self, generator: torch.Generator) -> Params:
        """Random weights from the distributions of the JAX package's
        ``Model.init``, drawn from ``generator`` on the model's device (the
        numbers differ from JAX's); the model's own weights stay as they
        were.  Stacked leaves are filled one period at a time, so the peak
        is the weights plus one period's draw."""
        return self._draw(generator, self.device)

    def param_shapes(self) -> Params:
        """The params tree as ``meta`` tensors: every leaf's shape and
        dtype, with no memory allocated and nothing drawn."""
        return self._draw(torch.Generator(), torch.device("meta"))

    def _draw(self, generator: torch.Generator, dev: torch.device) -> Params:
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        d = cfg.d_model
        params: Params = {
            "embed": L._normal(generator, (cfg.vocab_size, d), 1.0 / math.sqrt(d), dtype, dev),
            "final_norm": L.make_norm(cfg.norm, d, dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L._normal(
                generator, (cfg.vocab_size, d), 1.0 / math.sqrt(d), dtype, dev
            )
        for i, stage in enumerate(cfg.stages):
            stacked = None
            for r in range(stage.n_periods):
                period = {
                    f"l{li}_s{si}_{kind}": _init_sublayer(kind, generator, cfg, dev)
                    for li, layer in enumerate(stage.period)
                    for si, kind in enumerate(layer)
                }
                if stacked is None:
                    stacked = _empty_stacked(period, stage.n_periods)
                _stack_into(stacked, period, r)
                del period
            params[f"stage{i}"] = stacked
        return params

    # ------------------------------------------------------------ embedding
    def _embed(self, params: Params, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S), or precomputed embeddings (B, S, D) for an
        ``input_mode="embeddings"`` config."""
        if self.cfg.input_mode == "embeddings" and inputs.dim() == 3:
            x = inputs.to(self.dtype)
        else:
            x = params["embed"][inputs.long()].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * self._embed_scale
        if x.shape[1] > 1:
            x = constrain(x, ("dp", "sp", None))
        return x

    def _head(self, params: Params) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["lm_head"]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self._head(self.params).float().T

    def _run_stages(self, params, x, pos, mode, cache, lens, remat: bool = False):
        """Every stage's periods over ``x``; a recurrent sublayer's new state
        goes into its period's slot of the cache's stacked entry.  With
        ``remat`` each period runs under ``torch.utils.checkpoint``: the
        backward pass recomputes its activations from its input (the JAX
        package's ``jax.checkpoint`` on the scan body).  Returns (normed
        hidden, summed aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, stage in enumerate(cfg.stages):
            periods = _unbind(params[f"stage{i}"], stage.n_periods)
            stage_cache = cache[f"stage{i}"] if cache is not None else None
            caches = (_unbind(stage_cache, stage.n_periods) if stage_cache is not None
                      else [{}] * stage.n_periods)
            for r, (period_params, period_cache) in enumerate(zip(periods, caches)):
                if remat:
                    x, states, aux_d = checkpoint(
                        _apply_period, cfg, stage.period, period_params, x, pos, mode,
                        period_cache, lens, use_reentrant=False, preserve_rng_state=False,
                    )
                else:
                    x, states, aux_d = _apply_period(
                        cfg, stage.period, period_params, x, pos, mode, period_cache, lens
                    )
                if aux_d is not None:
                    aux = aux + aux_d
                if stage_cache is not None:
                    for tag, state in states.items():
                        for k, v in state.items():
                            stage_cache[tag][k][r].copy_(v)
        return L.apply_norm(cfg.norm, params["final_norm"], x), aux

    # ----------------------------------------------------------------- full
    def forward(self, inputs: torch.Tensor, *, pos_offset: Optional[torch.Tensor] = None,
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cache-free full-sequence pass over the model's weights:
        ``inputs`` (B, S) ids or (B, S, D) embeddings.  Returns (normed
        hidden (B, S, D), aux loss ()), as the JAX package's ``forward``
        does.  It follows the caller's grad mode; ``remat`` matters only
        where a backward pass will run."""
        return self._forward(self.params, inputs, pos_offset, remat)

    def _forward(self, params, inputs, pos_offset, remat):
        x = self._embed(params, inputs)
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if pos_offset is not None:
            pos = pos + pos_offset.to(pos.device, torch.int32)[:, None]
        remat = remat and torch.is_grad_enabled()
        return self._run_stages(params, x, pos, "train", None, None, remat=remat)

    def loss_fn(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        *,
        loss_chunk: int = 1024,
        aux_weight: float = 0.01,
        remat: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``params`` (the JAX package's
        ``loss_fn``, ``model.py:483``): ``batch`` holds ``tokens`` (or
        ``embeds``) and ``labels`` (B, S), a label of -1 being no target.
        The sequence is cut into chunks of ``loss_chunk`` positions (the
        last padded with -1 labels), each chunk's float32 logits reduced by
        ``logsumexp`` and, with ``remat``, recomputed in the backward pass
        rather than kept.  Returns (CE + ``aux_weight`` × MoE aux loss,
        {"ce", "aux", "tokens"}).  The gold logit is a gather where the
        reference takes a one-hot dot: equal bit for bit, as the dot only
        adds exact zeros."""
        inputs = batch["tokens"] if "tokens" in batch else batch["embeds"]
        labels = batch["labels"]
        hidden, aux = self._forward(params, inputs, None, remat)
        S = labels.shape[1]
        head = self._head(params).float()
        n_chunks = -(-S // loss_chunk)
        pad = n_chunks * loss_chunk - S
        if pad:
            hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        remat = remat and torch.is_grad_enabled()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(n_chunks):
            sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
            if remat:
                nll, valid = checkpoint(_chunk_loss, hidden[:, sl], labels[:, sl], head,
                                        use_reentrant=False, preserve_rng_state=False)
            else:
                nll, valid = _chunk_loss(hidden[:, sl], labels[:, sl], head)
            total = total + nll
            count = count + valid
        ce = total / torch.clamp(count, min=1.0)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "tokens": count}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A dense cache: per sublayer with state, ``(N_periods, B, ...)``
        tensors: K/V of ``max_seq`` positions, a ring of ``min(window,
        max_seq)`` positions for ``attn_local``, or a recurrent state."""
        cfg = self.cfg
        cache: Cache = {"lens": torch.zeros((batch,), dtype=torch.int32, device=self.device)}
        for i, stage in enumerate(cfg.stages):
            entries = {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    e = stacked_cache_entry(kind, cfg, stage.n_periods, batch, max_seq,
                                            self.device)
                    if e is not None:
                        entries[f"l{li}_s{si}_{kind}"] = e
            cache[f"stage{i}"] = entries
        return cache

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt ``inputs`` (B, S) ids or (B, S, D) embeddings
        through the model, filling the cache.  Returns (last-position logits
        (B, V) float32, cache)."""
        x = self._embed(self.params, inputs)
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        x, _ = self._run_stages(self.params, x, pos, "prefill", cache, None)
        logits = self._logits(x[:, -1:])[:, 0]
        out = dict(cache)
        out["lens"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, out

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, inputs: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: ``inputs`` (B,) ids or (B, 1, D)
        embeddings.  Returns (logits (B, V) float32, cache with lengths
        advanced)."""
        lens = cache["lens"]
        x = self._embed(self.params, inputs[:, None] if inputs.dim() == 1 else inputs)
        x, _ = self._run_stages(self.params, x, lens[:, None], "decode", cache, lens)
        logits = self._logits(x)[:, 0]
        out = dict(cache)
        out["lens"] = lens + 1
        return logits, out

    # -------------------------------------------------------------- helpers
    def param_count(self) -> int:
        """Parameters of the config (of ``param_shapes()`` when the model
        has no weights bound)."""
        def count(t: Any) -> int:
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()

        return count(self.params if self.params is not None else self.param_shapes())
