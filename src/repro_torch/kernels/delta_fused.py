"""Fused diff + ordered compaction + checksum for delta dumps.

CUDA kernel ``csrc/delta_fused.cu`` replaces the JAX package's
``kernels/delta_fused.py:_fused_kernel``.  The Pallas kernel walks its grid
in order and carries the compaction cursor in SMEM; blocks on Hopper run
in parallel and in no order, so the ascending slot order comes from a
prefix computed inside the one launch by a decoupled look-back: each block
takes a tile of rows (``tile_rows``) by an atomic ticket, compares them,
publishes the tile's dirty count, reads its predecessors' counts until it
meets an inclusive prefix, then copies each dirty row into its slot while
summing its four checksum lanes from the same registers.  A clean row
zeroes slot ``incl(r) + (N - 1 - r)`` when it is below ``cap``: that is
``count`` plus the clean rows after it, so the clean rows zero exactly the
unused slots below ``N``, each once, without knowing ``count``.  On the
card the work is bound by bytes: 2·N·C read by the compare, cap·C written
once.  The launch needs a scratch of ``scratch_bytes(N, C)`` for the
ticket and one status word per tile, which the C entry point zeroes with
one ``cudaMemsetAsync`` before the kernel.

Contract (``ref.fused_encode_ref``): data ``(cap, C)`` with dirty rows in
ascending order and zero unused rows, idx ``(cap,)`` int32 with -1
padding, count ``()`` int32 over *all* dirty rows (``count > cap`` =
overflow), sums ``(cap, 4)`` uint32, zero on unused slots.

A tensor on the CPU goes to ``ref.fused_encode_ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, accounting
from .ref import CHECKSUM_LANES, fused_encode_ref

__all__ = ["MAX_TILE_ROWS", "TILE_BYTES", "delta_fused", "scratch_bytes", "tile_count",
           "tile_rows"]

TILE_BYTES = 64 * 1024     # bytes of each grid a block aims to compare
MAX_TILE_ROWS = 128        # the kernel's per-tile flag and prefix arrays (kMaxTileRows)


def tile_rows(C: int) -> int:
    """Rows of one tile: one row, or where rows are narrow the fewest whole
    rows that give a block about ``TILE_BYTES`` of each grid, at most
    ``MAX_TILE_ROWS``.  Depends on ``C`` alone."""
    return max(1, min(MAX_TILE_ROWS, -(-TILE_BYTES // max(int(C), 1))))


def tile_count(N: int, C: int, cap: int) -> Tuple[int, int]:
    """(row tiles, tiles past the last row): the launch's blocks.  The
    tiles past the last row zero the slots ``[N, cap)`` when ``cap > N``."""
    R = tile_rows(C)
    return -(-N // R), -(-max(cap - N, 0) // R)


def scratch_bytes(N: int, C: int) -> int:
    """The ticket (16 bytes) and one 8-byte status word per row tile."""
    return 16 + 8 * -(-N // tile_rows(C))


def delta_fused(
    old: torch.Tensor, new: torch.Tensor, *, max_changed: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(data, idx, count, sums) of the dirty rows of ``new`` against ``old``."""
    if old.shape != new.shape or old.dim() != 2 or old.dtype != new.dtype:
        raise ValueError(f"delta_fused wants two (N, C) grids, got {old.shape} / {new.shape}")
    if old.device != new.device:
        raise ValueError("delta_fused: old and new lie on different devices")
    cap = int(max_changed)
    if cap < 1:
        raise ValueError("delta_fused: max_changed must be >= 1")
    if not new.is_cuda:
        return fused_encode_ref(old, new, cap)
    if old.dtype != torch.uint8:
        raise TypeError(f"delta_fused kernel takes uint8 byte grids, got {old.dtype}")
    if not (old.is_contiguous() and new.is_contiguous()):
        raise ValueError("delta_fused kernel needs contiguous grids")
    N, C = old.shape
    dev = new.device
    scratch = torch.empty((scratch_bytes(N, C),), dtype=torch.uint8, device=dev)
    data = torch.empty((cap, C), dtype=torch.uint8, device=dev)
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    sums = torch.empty((cap, CHECKSUM_LANES), dtype=torch.int32, device=dev)
    vec = C % 16 == 0 and old.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0
    lib = _build.library()
    err = lib.repro_delta_fused(
        old.data_ptr(), new.data_ptr(), scratch.data_ptr(), data.data_ptr(), idx.data_ptr(),
        count.data_ptr(), sums.data_ptr(), N, C, cap, tile_rows(C), int(vec),
        _build.stream_handle(new),
    )
    _build.check(err, "delta_fused")
    accounting.count_launches(delta_fused)
    return data, idx, count, sums.view(torch.uint32)


delta_fused.launches = 0
