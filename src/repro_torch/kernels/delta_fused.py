"""Fused diff + ordered compaction + checksum for delta dumps.

CUDA kernels ``csrc/delta_fused.cu`` replace the JAX package's
``kernels/delta_fused.py:_fused_kernel``.  The Pallas kernel walks its grid
in order and carries the compaction cursor in SMEM; blocks on Hopper run in
parallel and in no order, so the ascending slot order comes from a scan:
a per-row flag pass (the ``delta_diff`` kernel, into a scratch), a
one-block exclusive prefix over the flags, and an emit pass that copies
each dirty row into its slot and sums its four checksum lanes from the
same registers.  On the card the work is bound by
bytes: 2·N·C read by the compare, cap·C written once (unused slots are
zeroed by the emit pass itself, so no memset writes them twice).

Contract (``ref.fused_encode_ref``): data ``(cap, C)`` with dirty rows in
ascending order and zero unused rows, idx ``(cap,)`` int32 with -1
padding, count ``()`` int32 over *all* dirty rows (``count > cap`` =
overflow), sums ``(cap, 4)`` uint32, zero on unused slots.

A tensor on the CPU goes to ``ref.fused_encode_ref``; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import CHECKSUM_LANES, fused_encode_ref

__all__ = ["delta_fused"]


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
    flags = torch.empty((N,), dtype=torch.uint8, device=dev)          # scratch
    slots = torch.empty((N,), dtype=torch.int32, device=dev)          # scratch
    data = torch.empty((cap, C), dtype=torch.uint8, device=dev)
    idx = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    sums = torch.empty((cap, CHECKSUM_LANES), dtype=torch.int32, device=dev)
    vec = C % 16 == 0 and old.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0
    lib = _build.library()
    err = lib.repro_delta_fused(
        old.data_ptr(), new.data_ptr(), flags.data_ptr(), slots.data_ptr(),
        data.data_ptr(), idx.data_ptr(), count.data_ptr(), sums.data_ptr(),
        N, C, cap, int(vec), _build.stream_handle(new),
    )
    _build.check(err, "delta_fused")
    delta_fused.launches += 1
    return data, idx, count, sums.view(torch.uint32)


delta_fused.launches = 0
