"""``shard_map``'s collectives over a logical mesh, in one process.

The JAX package's expert-parallel MoE runs one program per device under
``shard_map`` and meets the other devices in ``all_gather``,
``all_to_all`` and ``pmean``.  The port runs every rank of a
:class:`~repro_torch.dist.placement.Mesh` in one process, so a collective
here is one call over all ranks at once: it takes a mapping rank → that
rank's tensor (every rank of the mesh) and returns the mapping rank → its
result.

Semantics are JAX's, tiled: the *group* of a rank along ``axis`` is the
ranks that share every mesh coordinate but ``axis``'s, ordered by their
coordinate along ``axis`` (the axis index).

* :func:`all_gather` — each rank gets its group's blocks concatenated
  along ``dim`` in axis-index order;
* :func:`all_to_all` — each rank splits its block along ``split_axis``
  into one piece per group member, sends piece ``j`` to the member of
  axis index ``j``, and concatenates what it receives along
  ``concat_axis`` in axis-index order;
* :func:`pmean` — each rank gets the mean of its group's values.

They are built from differentiable tensor ops (``narrow``, ``cat``,
``stack``), so autograd flows through them.  Along an axis of size 1 a
collective returns each rank's own tensor, with no copy.  Members of one
group that receive the same result on one device (a gather, a mean) share
one tensor, as replicas on one card share a block in ``placement``.

:data:`LEDGER` counts, by op and by rank, the bytes each rank receives
from *other* ranks: what would cross the interconnect on a mesh of
cards.  It is the counterpart of the collective bytes the JAX package's
dry run reads from HLO.  A collective captured in a CUDA graph is noted
at each replay of the graph, as an eager call is at each call
(``kernels.accounting``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Mapping

import numpy as np
import torch

from ..kernels.accounting import record
from .placement import Mesh

__all__ = [
    "LEDGER",
    "CollectiveLedger",
    "all_gather",
    "all_to_all",
    "ledger",
    "pmean",
    "reset_ledger",
]


class CollectiveLedger:
    """Bytes each rank received from other ranks, and calls, by op."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.received: Dict[str, Dict[int, int]] = {}
        self.calls: Dict[str, int] = {}

    def note(self, op: str, received: Mapping[int, int]) -> None:
        with self._lock:
            by_rank = self.received.setdefault(op, {})
            for rank, nbytes in received.items():
                by_rank[rank] = by_rank.get(rank, 0) + int(nbytes)
            self.calls[op] = self.calls.get(op, 0) + 1

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {"received": {op: dict(v) for op, v in self.received.items()},
                    "calls": dict(self.calls)}

    def reset(self) -> None:
        with self._lock:
            self.received.clear()
            self.calls.clear()


LEDGER = CollectiveLedger()


def ledger() -> Dict[str, Dict]:
    """``{"received": {op: {rank: bytes}}, "calls": {op: n}}``."""
    return LEDGER.snapshot()


def reset_ledger() -> None:
    LEDGER.reset()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """Every group of ranks along ``axis``, each in axis-index order."""
    at = mesh.axis_names.index(axis)
    lines = np.moveaxis(mesh.ranks, at, -1).reshape(-1, mesh.ranks.shape[at])
    return [[int(r) for r in line] for line in lines]


def _check(values: Mapping[int, torch.Tensor], mesh: Mesh) -> None:
    if sorted(values) != list(range(mesh.size)):
        raise ValueError(f"a collective takes one tensor for each of the {mesh.size} ranks, "
                         f"got ranks {sorted(values)}")


def all_gather(blocks: Mapping[int, torch.Tensor], mesh: Mesh, axis: str,
               dim: int) -> Dict[int, torch.Tensor]:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` for every rank."""
    _check(blocks, mesh)
    out: Dict[int, torch.Tensor] = {}
    received: Dict[int, int] = {}
    for group in _groups(mesh, axis):
        if len(group) == 1:
            out[group[0]] = blocks[group[0]]
            continue
        total = sum(_nbytes(blocks[g]) for g in group)
        made: Dict[torch.device, torch.Tensor] = {}
        for r in group:
            dev = mesh.device_of(r)
            if dev not in made:
                made[dev] = torch.cat([blocks[g].to(dev) for g in group], dim=dim)
            out[r] = made[dev]
            received[r] = total - _nbytes(blocks[r])
    record(LEDGER.note, "all_gather", received)
    return out


def all_to_all(blocks: Mapping[int, torch.Tensor], mesh: Mesh, axis: str,
               split_axis: int, concat_axis: int) -> Dict[int, torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    for every rank."""
    _check(blocks, mesh)
    out: Dict[int, torch.Tensor] = {}
    received: Dict[int, int] = {}
    for group in _groups(mesh, axis):
        n = len(group)
        if n == 1:
            out[group[0]] = blocks[group[0]]
            continue
        for g in group:
            if blocks[g].shape[split_axis] % n:
                raise ValueError(f"all_to_all: dim {split_axis} of rank {g}'s "
                                 f"{tuple(blocks[g].shape)} does not split {n} ways")
        for i, r in enumerate(group):
            dev = mesh.device_of(r)
            pieces = []
            for g in group:
                size = blocks[g].shape[split_axis] // n
                pieces.append(blocks[g].narrow(split_axis, i * size, size).to(dev))
            out[r] = torch.cat(pieces, dim=concat_axis)
            received[r] = sum(_nbytes(p) for g, p in zip(group, pieces) if g != r)
    record(LEDGER.note, "all_to_all", received)
    return out


def pmean(values: Mapping[int, torch.Tensor], mesh: Mesh, axis: str) -> Dict[int, torch.Tensor]:
    """``jax.lax.pmean(x, axis)`` for every rank."""
    _check(values, mesh)
    out: Dict[int, torch.Tensor] = {}
    received: Dict[int, int] = {}
    for group in _groups(mesh, axis):
        if len(group) == 1:
            out[group[0]] = values[group[0]]
            continue
        total = sum(_nbytes(values[g]) for g in group)
        made: Dict[torch.device, torch.Tensor] = {}
        for r in group:
            dev = mesh.device_of(r)
            if dev not in made:
                made[dev] = torch.stack([values[g].to(dev) for g in group]).mean(dim=0)
            out[r] = made[dev]
            received[r] = total - _nbytes(values[r])
    record(LEDGER.note, "pmean", received)
    return out
