"""Sharding rules: parameter, cache and batch partitioning over a mesh.

One place owns the mapping from a model's leaves to mesh axes, so the
sharded dump path (and later the sharded model) never hard-codes a
layout:

* ``param_specs(cfg, mesh)`` — FSDP×TP :class:`PartitionSpec` for every
  parameter leaf, shape-guarded by :func:`enforce_divisible`;
* ``cache_specs(cfg, mesh)`` — decode caches are *sequence*-sharded over
  the "model" axis (long-context: over the data axes, B=1), per-name specs;
* ``batch_spec`` / ``data_axes`` — data-parallel batch layout helpers.

The rules are the JAX package's, leaf for leaf.  A mesh here is anything
with ``axis_names`` and a ``shape`` dict (axis → size), so the specs of a
production mesh come out without its cards.  The activation constraints
of the sharded model (``constrain``, ``activation_sharding``) wait for
real ranks.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from .placement import PartitionSpec as P

__all__ = [
    "batch_spec",
    "cache_specs",
    "data_axes",
    "enforce_divisible",
    "param_specs",
]


def _norm(axes: Tuple[str, ...]):
    """PartitionSpec entry from an axis tuple: () → None, 1-tuple → bare name."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


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
