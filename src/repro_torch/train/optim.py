"""AdamW with per-arch dtype policy, schedules, clipping, int8 compression.

The JAX package's ``train/optim.py`` as torch ops on trees (nested dicts)
of tensors, with its arithmetic:

* ``adamw_init / adamw_update`` — decoupled weight decay, bias correction,
  global-norm clipping; moments updated in float32 and stored in the
  arch's ``moment_dtype`` (fp32 default; bf16 for the ≥100B archs), the
  bias correction and the learning rate computed in float32, and the
  clipped gradient rounded back to the gradient's dtype before the update
  (so bf16 gradients are clipped in float32 and rounded to bf16).
* ``cosine_schedule`` — linear warmup + cosine decay.
* ``compress_grads / decompress_grads`` — int8 gradient quantization with a
  persistent error-feedback buffer (``torch.round`` rounds half to even,
  like ``jnp.round``).

Leaves are visited in the JAX package's flatten order (dict keys sorted),
so sums over leaves (the global norm) add in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

__all__ = [
    "OptimizerConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
    "compress_grads",
    "decompress_grads",
    "error_feedback_init",
    "tree_leaves",
    "tree_map",
    "tree_paths",
]


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------
def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (nested dicts) and the matching
    leaves of ``rest``; the result keeps ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``"a/b/c"`` path, leaf) pairs in the JAX package's flatten order
    (keys sorted at every level), the paths its ``_pstr`` writes."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "float32" | "bfloat16"


def cosine_schedule(cfg: OptimizerConfig) -> Callable[[Any], torch.Tensor]:
    def schedule(step: Any) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
        t = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)

    return schedule


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g`` scaled in float32 and rounded back to its own dtype."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clip(g, scale), tree), norm


def adamw_init(params: Any, cfg: OptimizerConfig) -> Dict[str, Any]:
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    first = tree_leaves(params)[0]
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


_NO_DECAY = ("norm", "bias", "b_if", "b_gates", "dt_bias")


def _decay_mask(path: str) -> bool:
    """No weight decay on norms/biases/1-d params (the reference's path
    tokens, matched in the "/"-joined path)."""
    return not any(tok in path for tok in _NO_DECAY)


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    opt_state: Dict[str, Any],
    cfg: OptimizerConfig,
    *,
    inplace: bool = False,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, opt_state, {"lr", "grad_norm"}).

    ``inplace=False`` returns new tensors and leaves the inputs as they
    were; ``inplace=True`` writes the new params and moments into the
    given tensors (buffer donation) and returns the same trees.  Leaves
    are clipped and updated one at a time, so the float32 temporaries of
    only one leaf are alive at once."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    mdt = getattr(torch, cfg.moment_dtype)

    def leaf(path: str, p, g, m, v):
        gf = _clip(g, clip).float()      # clip_by_global_norm, one leaf at a time
        m32 = m.float() * b1 + gf * (1 - b1)
        v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if _decay_mask(path):
            update = update + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * update).to(p.dtype)
        if inplace:
            p.copy_(new_p)
            m.copy_(m32)
            v.copy_(v32)
            return p, m, v
        return new_p, m32.to(mdt), v32.to(mdt)

    def walk(path: str, p, g, m, v):
        if isinstance(p, dict):
            out = {k: walk(f"{path}{k}/", p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in out.items()} for i in range(3))
        return leaf(path[:-1], p, g, m, v)

    new_p, new_m, new_v = walk("", params, grads, opt_state["m"], opt_state["v"])
    if inplace:
        opt_state["step"].copy_(step)
        step = opt_state["step"]
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}


# --------------------------------------------------------------------------
# int8 gradient compression with error feedback
# --------------------------------------------------------------------------
def error_feedback_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: Any, error_buf: Any) -> Tuple[Tuple[Any, Any], Any]:
    """Quantize (grad + carried error) to int8 with per-tensor scale.

    Returns ((q, scale) tree, new_error_buf).  The error buffer carries the
    quantization residual into the next step (error feedback)."""

    def leaf(g, e):
        x = g.float() + e
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        qi = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return qi, scale, x - qi.float() * scale

    out = tree_map(leaf, grads, error_buf)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return (pick(0), pick(1)), pick(2)


def decompress_grads(comp: Tuple[Any, Any]) -> Any:
    qt, st = comp
    return tree_map(lambda qi, s: qi.float() * s, qt, st)
