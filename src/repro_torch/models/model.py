"""Pattern-based model for the dense architectures, ported from the JAX
package's ``models/model.py``.

A model is a stack of *stages*; each stage repeats a *period* of layers
``n_periods`` times, with its params stacked over periods (the JAX
package's ``lax.scan`` layout; here a Python loop over the stacked
params).  A layer is a tuple of sublayers, each pre-normed + residual:

    attn    GQA attention (qk-norm, 1-D RoPE)
    mlp     GLU MLP (SwiGLU / GeGLU)

Two modes share one code path:

    prefill  — chunked causal attention over the prompt, K/V written to the
               cache
    decode   — one token per sequence, reading and writing the cache

A cache is either *dense* (``init_cache``: ``(N_periods, B, max_seq, KVH,
Hd)`` K/V tensors per attention sublayer) or *paged* (built by
``serve.Engine``: the page pool's stacked ``(N_periods, P, psz, KVH, Hd)``
K/V tensors plus a page table).  Cache writes are in place, where the JAX
package rebinds donated arrays.  Paged decode reads K/V through the
``paged_attention`` kernel.

Not ported in this package yet: training (``forward``/``loss_fn``), the
sliding-window ``attn_local`` layers with their ring buffer and paged
window fix, M-RoPE, and the moe/mamba/mlstm/slstm sublayers.  A config
that uses one raises ``ValueError(kind)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.deltacr import resolve_device
from ..kernels import ops as kops
from . import layers as L

Params = Dict[str, Any]
Cache = Dict[str, Any]

__all__ = ["Model", "Params", "Cache"]


def _attn_spec(cfg: ModelConfig) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
    )


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _index(tree: Any, r: int) -> Any:
    """Period ``r`` of a tree of tensors stacked over periods."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


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
    if kind == "attn":
        params["body"] = L.attn_init(gen, _attn_spec(cfg), dtype, device)
    elif kind == "mlp":
        params["body"] = L.glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    else:
        raise ValueError(kind)
    return params


# --------------------------------------------------------------------------
# Attention over caches (decode path)
# --------------------------------------------------------------------------
def _decode_attend_full(q, cache_k, cache_v, lens, scale):
    """q (B,1,KVH,G,Hd); cache (B,S,KVH,Hd); lens (B,) incl. current token."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float() * scale, cache_k.float())
    S = cache_k.shape[1]
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]      # (B,S)
    s = torch.where(mask[:, None, None, None, :], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, cache_v.float())
    return out.to(q.dtype)


def _full_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b, 0], in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)


def _apply_attn_paged(
    body: Params,
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
        ctx = kops.paged_attention(q[:, 0].contiguous(), pk, pv, table, lens + 1, scale=scale)
        ctx = ctx[:, None]                                            # (B,1,KVH,G,Hd)
    else:  # prefill: compute causally, then scatter K/V into the pages
        ctx = L.chunked_causal_attention(q, k, v, scale=scale)
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


def _apply_sublayer(
    kind: str,
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                  # (B,S,D)
    pos: torch.Tensor,                # (B,S) absolute positions
    mode: str,                        # prefill | decode
    cache: Optional[Dict[str, torch.Tensor]],
    lens: Optional[torch.Tensor],     # (B,) tokens already in cache (decode)
) -> torch.Tensor:
    """Returns the residual delta; cache entries are updated in place."""
    h = L.apply_norm(cfg.norm, params["norm"], x)
    if kind == "attn":
        spec = _attn_spec(cfg)
        q, k, v = L.attn_project_qkv(params["body"], spec, h, pos)
        scale = 1.0 / math.sqrt(spec.head_dim)
        if cache is not None and "pk" in cache:
            return _apply_attn_paged(params["body"], q, k, v, mode, cache, lens, scale)
        assert cache is not None
        if mode == "decode":
            assert lens is not None
            _full_write(cache["k"], k, lens)
            _full_write(cache["v"], v, lens)
            ctx = _decode_attend_full(q, cache["k"], cache["v"], lens + 1, scale)
        else:
            ctx = L.chunked_causal_attention(q, k, v, scale=scale)
            S = k.shape[1]
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        return L.attn_output(params["body"], ctx)
    if kind == "mlp":
        return L.glu_mlp(params["body"], h, activation=cfg.activation)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------
class Model:
    """One dense architecture config with its weights on one device.

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

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> Params:
        """Random weights from the distributions of the JAX package's
        ``Model.init``, drawn from ``generator`` on the model's device (the
        numbers differ from JAX's).  Stacked leaves are filled one period at
        a time, so the peak is the weights plus one period's draw."""
        cfg, dev = self.cfg, self.device
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
        self.params = params
        return params

    # ------------------------------------------------------------ embedding
    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.params["embed"][inputs.long()].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype, device=x.device)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.params["embed"] if self.cfg.tie_embeddings else self.params["lm_head"]
        return x.float() @ head.float().T

    def _run_stages(self, x, pos, mode, cache, lens):
        cfg = self.cfg
        for i, stage in enumerate(cfg.stages):
            stage_params = self.params[f"stage{i}"]
            stage_cache = cache[f"stage{i}"]
            for r in range(stage.n_periods):
                period_params = _index(stage_params, r)
                period_cache = _index(stage_cache, r)
                for li, layer in enumerate(stage.period):
                    for si, kind in enumerate(layer):
                        tag = f"l{li}_s{si}_{kind}"
                        delta = _apply_sublayer(
                            kind, period_params[tag], cfg, x, pos, mode,
                            period_cache.get(tag), lens,
                        )
                        x = x + delta.to(x.dtype)
        return L.apply_norm(cfg.norm, self.params["final_norm"], x)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A dense cache: zeroed ``(N_periods, B, max_seq, KVH, Hd)`` K/V per
        attention sublayer."""
        cfg = self.cfg
        cache: Cache = {"lens": torch.zeros((batch,), dtype=torch.int32, device=self.device)}
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        for i, stage in enumerate(cfg.stages):
            entries = {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    if kind == "attn":
                        entries[f"l{li}_s{si}_{kind}"] = {
                            "k": torch.zeros((stage.n_periods,) + shape, dtype=self.dtype,
                                             device=self.device),
                            "v": torch.zeros((stage.n_periods,) + shape, dtype=self.dtype,
                                             device=self.device),
                        }
                    elif kind != "mlp":
                        raise ValueError(kind)
            cache[f"stage{i}"] = entries
        return cache

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt ``inputs`` (B, S) through the model, filling the
        cache.  Returns (last-position logits (B, V) float32, cache)."""
        x = self._embed(inputs)
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        x = self._run_stages(x, pos, "prefill", cache, None)
        logits = self._logits(x[:, -1:])[:, 0]
        out = dict(cache)
        out["lens"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, out

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, inputs: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: ``inputs`` (B,) ids.  Returns (logits
        (B, V) float32, cache with lengths advanced)."""
        lens = cache["lens"]
        x = self._embed(inputs[:, None])
        x = self._run_stages(x, lens[:, None], "decode", cache, lens)
        logits = self._logits(x)[:, 0]
        out = dict(cache)
        out["lens"] = lens + 1
        return logits, out

    # -------------------------------------------------------------- helpers
    def param_count(self) -> int:
        def count(t: Any) -> int:
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()

        return count(self.params)
