"""Dirty-chunk detection for delta dumps: ``(N, C)`` uint8 grids → ``(N,)`` bool.

CUDA kernel ``csrc/delta_diff.cu`` replaces the JAX package's
``kernels/delta_diff.py:_delta_diff_kernel`` (a Pallas TPU kernel comparing
one ``(block, C)`` tile per grid step).  On the card the work is bound by
bytes: both grids are read once (2·N·C) and N flags written.  The design
gives one thread block to each row (64 KiB on the dump path) and streams it
in 16-byte vector loads, reducing with one block-wide OR, so the grid keeps
every SM loading.

A tensor on the CPU goes to ``ref.delta_diff_ref``; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, accounting
from .ref import delta_diff_ref

__all__ = ["delta_diff"]


def delta_diff(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-row dirty bitmap, (N,) bool."""
    if old.shape != new.shape or old.dim() != 2 or old.dtype != new.dtype:
        raise ValueError(f"delta_diff wants two (N, C) grids, got {old.shape} / {new.shape}")
    if old.device != new.device:
        raise ValueError("delta_diff: old and new lie on different devices")
    if not new.is_cuda:
        return delta_diff_ref(old, new)
    if old.dtype != torch.uint8:
        raise TypeError(f"delta_diff kernel takes uint8 byte grids, got {old.dtype}")
    if not (old.is_contiguous() and new.is_contiguous()):
        raise ValueError("delta_diff kernel needs contiguous grids")
    N, C = old.shape
    dirty = torch.empty((N,), dtype=torch.bool, device=new.device)
    vec = C % 16 == 0 and old.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0
    lib = _build.library()
    err = lib.repro_delta_diff(
        old.data_ptr(), new.data_ptr(), dirty.data_ptr(), N, C, int(vec),
        _build.stream_handle(new),
    )
    _build.check(err, "delta_diff")
    accounting.count_launches(delta_diff)
    return dirty


delta_diff.launches = 0
