"""Plain PyTorch versions of the delta kernels.

Bit-identical to the jnp oracles of the JAX package's ``kernels/ref.py``.
They are what a wrapper in ``ops.py`` runs for a tensor on the CPU, what
the CPU tests compare across packages, and what ``chip_smoke.py`` holds
each CUDA kernel against on the card.  Shapes:

* chunked device state: ``(num_chunks, chunk_bytes)`` uint8 grids
* compacted dirty rows: ``(max_changed, chunk_bytes)`` plus ``(max_changed,)``
  int32 chunk indices with -1 padding
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "delta_diff_ref",
    "delta_apply_ref",
    "delta_compact_ref",
    "chunk_checksums_ref",
    "fused_encode_ref",
    "CHECKSUM_LANES",
]

# 4-lane integrity checksum over chunk bytes (uint32 wraparound).  NOT a
# content address: the chunk store's dedupe key stays blake2b.  The lanes
# let the fused dump kernel emit a digest of every dirty chunk in the pass
# that diffs and compacts it, so the host can validate the fetched bytes.
CHECKSUM_LANES = 4
_CS_MULT = 2654435761        # Knuth multiplicative-hash constant
_CS_ADD = 40503
_CS_XOR = 2246822519
_U32 = 0xFFFFFFFF


def delta_diff_ref(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-chunk dirty bitmap: any element differs → True.  (N, C) -> (N,)."""
    return (old != new).any(dim=-1)


def delta_compact_ref(
    new: torch.Tensor,          # (N, C)
    dirty: torch.Tensor,        # (N,) bool
    max_changed: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack dirty chunks into a fixed-capacity buffer.

    Returns (data (max_changed, C), idx (max_changed,) int32 with -1
    padding, count () int32 of all dirty rows).  Dirty chunks keep
    ascending order; rows past ``max_changed`` are dropped.  A cumsum gives
    each dirty row its slot, and one gather of ``max_changed`` rows fills
    the buffer, so no host synchronisation is needed."""
    N = new.shape[0]
    d = dirty.to(torch.int32)
    positions = torch.cumsum(d, 0, dtype=torch.int32) - 1
    count = d.sum(dtype=torch.int32)
    keep = dirty & (positions < max_changed)
    slot = torch.where(keep, positions, torch.full_like(positions, max_changed))
    idx = torch.full((max_changed + 1,), -1, dtype=torch.int32, device=new.device)
    # every row that is not kept lands on the sacrificial slot max_changed
    idx.scatter_(0, slot.to(torch.int64), torch.arange(N, dtype=torch.int32, device=new.device))
    idx = idx[:max_changed].clone()
    valid = idx >= 0
    data = new.index_select(0, idx.clamp(min=0).to(torch.int64))
    data.masked_fill_(~valid.reshape(-1, *([1] * (new.dim() - 1))), 0)
    return data, idx, count


def chunk_checksums_ref(chunks: torch.Tensor) -> torch.Tensor:
    """Per-row 4-lane uint32 checksums of an (N, C) chunk grid.

    Elementwise products and row sums in uint32 with wraparound — the
    formulas of the JAX package's ``chunk_checksums_ref``.  Torch sums of
    narrow integers come back as int64, so the lanes are summed in int64
    (exact modulo 2**64) and masked to 32 bits.  Returns (N, 4) uint32."""
    x = chunks.to(torch.int64)
    C = x.shape[-1]
    pos = torch.arange(C, dtype=torch.int64, device=chunks.device)
    w = (pos * _CS_MULT + _CS_ADD) & _U32
    s0 = x.sum(-1) & _U32
    s1 = (x * (pos + 1)).sum(-1) & _U32
    s2 = (x * w).sum(-1) & _U32
    s3 = ((x + 1) * (w ^ _CS_XOR)).sum(-1) & _U32
    return _as_uint32(torch.stack([s0, s1, s2, s3], dim=-1))


def _as_uint32(lanes: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → uint32 of the same bits."""
    signed = torch.where(lanes >= 2**31, lanes - 2**32, lanes).to(torch.int32)
    return signed.view(torch.uint32)


def fused_encode_ref(
    old: torch.Tensor,          # (N, C)
    new: torch.Tensor,          # (N, C)
    max_changed: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused dump kernel: diff + compact + checksum.

    Returns (data, idx, count, sums): the ``delta_compact_ref`` outputs plus
    (max_changed, 4) uint32 checksum lanes of each valid slot, zero on
    unused slots.  ``count > max_changed`` signals capacity overflow."""
    dirty = delta_diff_ref(old, new)
    data, idx, count = delta_compact_ref(new, dirty, max_changed)
    sums = chunk_checksums_ref(data).view(torch.int32)
    sums = torch.where((idx >= 0)[:, None], sums, torch.zeros_like(sums))
    return data, idx, count, sums.view(torch.uint32)


def delta_apply_ref(
    base: torch.Tensor,         # (N, C)
    data: torch.Tensor,         # (M, C) compacted dirty chunks
    idx: torch.Tensor,          # (M,) int32, -1 = padding
) -> torch.Tensor:
    """Scatter dirty chunks into a copy of base: out[idx[j]] = data[j] for
    idx[j] >= 0.  Rows with an index outside the base are dropped."""
    out = base.clone()
    valid = (idx >= 0) & (idx < base.shape[0])
    out[idx[valid].to(torch.int64)] = data[valid]
    return out
