"""Sharding rules: logical activation axes + parameter/cache partitioning.

One place owns the mapping from *logical* axis names to mesh axes, so
model code never hard-codes a mesh layout:

* ``constrain(x, ("dp", "sp", None))`` — a logical sharding constraint.
  Logical names resolve through the ambient :func:`activation_sharding`
  context; with no context installed it returns ``x`` itself.  Under a
  context it hands the resolved spec to
  :func:`~repro_torch.dist.placement.with_sharding_constraint`, a checked
  identity: one process computes the whole tensor, so the values are the
  unsharded ones, as GSPMD's are;
* ``param_specs(cfg, mesh)`` — FSDP×TP :class:`PartitionSpec` for every
  parameter leaf, shape-guarded by :func:`enforce_divisible`;
* ``cache_specs(cfg, mesh)`` — decode caches are *sequence*-sharded over
  the "model" axis (long-context: over the data axes, B=1), per-name specs;
* ``batch_spec`` / ``data_axes`` — data-parallel batch layout helpers.

Logical axes understood by :func:`constrain`:

=========  ==================================================================
``dp``     data-parallel axes of the context (``()`` → unsharded)
``sp``     sequence parallelism: "model" when the context enables it
``seq``    the context's sequence axes (decode cache sharding)
``model``  the tensor-parallel axis
``kv``     "model" iff the architecture shards the KV-head axis
``group``  "model" iff the architecture shards the query-group axis
=========  ==================================================================

The rules are the JAX package's, leaf for leaf and name for name.  A
mesh here is anything with ``axis_names`` and a ``shape`` dict (axis →
size), so the specs of a production mesh come out without its cards; a
context's ``mesh`` is a :class:`~repro_torch.dist.placement.Mesh` (a
logical mesh) or None.  The context also selects the expert-parallel MoE
(``models/layers.py``), which is the one consumer that runs per-rank code.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import placement
from .placement import NamedSharding
from .placement import PartitionSpec as P

__all__ = [
    "activation_sharding",
    "batch_spec",
    "cache_specs",
    "constrain",
    "current_act_ctx",
    "data_axes",
    "enforce_divisible",
    "param_specs",
]

_tls = threading.local()


def current_act_ctx() -> Optional[Dict[str, Any]]:
    """The innermost activation-sharding context, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activation_sharding(
    *,
    dp: Sequence[str] = (),
    seq: Sequence[str] = (),
    model: str = "model",
    attn_shard: str = "kv",
    seq_parallel: bool = False,
    mesh: Optional[placement.Mesh] = None,
):
    """Install the logical→mesh axis mapping ``constrain`` resolves against
    (per thread, innermost wins)."""
    ctx = {
        "dp": tuple(dp),
        "seq": tuple(seq),
        "model": model,
        "attn_shard": attn_shard,
        "seq_parallel": bool(seq_parallel),
        "mesh": mesh,
    }
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def _norm(axes: Tuple[str, ...]):
    """PartitionSpec entry from an axis tuple: () → None, 1-tuple → bare name."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


def _resolve(logical, ctx) -> Any:
    if logical is None:
        return None
    if logical == "dp":
        return _norm(ctx["dp"])
    if logical == "seq":
        return _norm(ctx["seq"])
    if logical == "sp":
        return ctx["model"] if ctx["seq_parallel"] else None
    if logical == "model":
        return ctx["model"]
    if logical == "kv":
        return ctx["model"] if ctx["attn_shard"] == "kv" else None
    if logical == "group":
        return ctx["model"] if ctx["attn_shard"] == "group" else None
    return logical  # literal mesh axis name passes through


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """A sharding constraint through logical axis names; ``x`` itself
    without a context.  Under a context with a mesh the spec is first
    guarded by :func:`enforce_divisible`."""
    ctx = current_act_ctx()
    if ctx is None:
        return x
    entries = tuple(_resolve(a, ctx) for a in logical_axes[: x.ndim])
    spec = P(*entries)
    mesh = ctx.get("mesh")
    if mesh is not None:
        spec = enforce_divisible(spec, x.shape, mesh)
        return placement.with_sharding_constraint(x, NamedSharding(mesh, spec))
    return placement.with_sharding_constraint(x, spec)


def data_axes(mesh) -> Tuple[str, ...]:
    """Every mesh axis that is not the tensor-parallel axis ("model")."""
    return tuple(a for a in mesh.axis_names if a != "model")


def enforce_divisible(spec: P, shape: Sequence[int], mesh) -> P:
    """Drop named axes that do not divide their dimension (→ replicated).

    A spec is advisory; divisibility is checked against the actual leaf
    shape, and an axis set that fails falls back to None for that dim."""
    sizes = dict(mesh.shape)
    out = []
    for dim, axes in zip(shape, tuple(spec)):
        if axes is None:
            out.append(None)
            continue
        ax = axes if isinstance(axes, tuple) else (axes,)
        size = int(np.prod([sizes[a] for a in ax]))
        out.append(axes if size and dim % size == 0 else None)
    return P(*out)


def batch_spec(kind: str, mesh, *, long_context: bool = False) -> P:
    """(B, S) input layout: batch over the data axes; long-context decode
    runs B=1 with the *sequence* spread over the data axes instead."""
    del kind  # train / prefill / decode share the (B, S) batch layout
    d = _norm(data_axes(mesh))
    if long_context:
        return P(None, d)
    return P(d, None)


def _tree_map(fn, node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, v) for v in node)
    return fn(node)


def param_specs(cfg, mesh) -> Any:
    """FSDP×TP spec tree congruent with the model's params tree.

    Rank ≥ 2 leaves shard the last dim over "model" (TP) and the
    second-to-last over the data axes (FSDP), with per-leaf divisibility
    fallback; vectors and scalars replicate.  Stacked period leaves keep
    their leading n_periods dim unsharded (it is the scan axis).  Shapes
    come from ``Model(cfg)`` on the ``meta`` device: nothing is allocated."""
    from ..models.model import Model  # deferred: models are heavy to import

    shapes = Model(cfg, device="meta").param_shapes()
    d = _norm(data_axes(mesh))

    def spec_for(leaf) -> P:
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if nd == 1:
            return P(None)
        entries = [None] * nd
        entries[-1] = "model"
        entries[-2] = d
        return enforce_divisible(P(*entries), tuple(leaf.shape), mesh)

    return _tree_map(spec_for, shapes)


def cache_specs(cfg, mesh, *, long_context: bool = False) -> Dict[str, P]:
    """Per-leaf-name specs for the decode/prefill cache tree.

    Cache K/V leaves are stacked ``(n_periods, B, S, KVH, Hd)``; decode
    shards the sequence axis over "model", long-context over the data axes
    with B=1.  Recurrent states shard their feature axis over "model"."""
    del cfg  # specs are layout-generic; divisibility is enforced per leaf
    d = _norm(data_axes(mesh))
    b = None if long_context else d
    s = d if long_context else "model"
    return {
        "lens": P(b),
        "k": P(None, b, s, None, None),
        "v": P(None, b, s, None, None),
        # mamba: conv (periods,B,di,d_conv), ssm (periods,B,di,d_state)
        "conv": P(None, b, "model", None),
        "ssm": P(None, b, "model", None),
        # xlstm: mlstm C (periods,B,H,hd,hd) n (periods,B,H,hd) m (periods,B,H)
        "C": P(None, b, None, None, None),
        "n": P(None, b, None, None),
        "m": P(None, b, None),
        # slstm c/h (periods,B,d)
        "c": P(None, b, None),
        "h": P(None, b, None),
    }
