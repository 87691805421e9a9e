"""Slow-path restore scatter: ``base[idx[j]] = data[j]`` for ``idx[j] >= 0``.

CUDA kernel ``csrc/delta_apply.cu`` replaces the JAX package's
``kernels/delta_apply.py:_delta_apply_kernel`` (a Pallas TPU kernel with
the indices as scalar prefetch and the base aliased to the output).  On the
card the work is bound by bytes: the valid rows of ``data`` are read once
and written once into ``base``.  The design gives one thread block to each
compacted row; a padding row (-1) returns at once and a valid row is copied
in 16-byte vectors.

Unlike the JAX call, which donates nothing, the kernel **mutates ``base`` in
place** and returns it: a caller that must keep its base passes a clone.
A tensor on the CPU is updated from ``ref.delta_apply_ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import delta_apply_ref

__all__ = ["delta_apply"]


def delta_apply(base: torch.Tensor, data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Scatter ``data`` rows into ``base`` in place; returns ``base``."""
    if base.dim() != 2 or data.dim() != 2 or base.shape[1] != data.shape[1]:
        raise ValueError(f"delta_apply wants (N, C) and (M, C), got {base.shape} / {data.shape}")
    if idx.shape != (data.shape[0],) or idx.dtype != torch.int32:
        raise ValueError(f"delta_apply wants (M,) int32 indices, got {idx.shape} {idx.dtype}")
    if base.dtype != data.dtype:
        raise TypeError(f"delta_apply: base {base.dtype} vs data {data.dtype}")
    if not (base.device == data.device == idx.device):
        raise ValueError("delta_apply: base, data and idx lie on different devices")
    if not base.is_cuda:
        base.copy_(delta_apply_ref(base, data, idx))
        return base
    if not (base.is_contiguous() and data.is_contiguous() and idx.is_contiguous()):
        raise ValueError("delta_apply kernel needs contiguous tensors")
    N, M = base.shape[0], data.shape[0]
    row_bytes = base.shape[1] * base.element_size()
    vec = row_bytes % 16 == 0 and base.data_ptr() % 16 == 0 and data.data_ptr() % 16 == 0
    lib = _build.library()
    err = lib.repro_delta_apply(
        base.data_ptr(), data.data_ptr(), idx.data_ptr(), N, M, row_bytes, int(vec),
        _build.stream_handle(base),
    )
    _build.check(err, "delta_apply")
    delta_apply.launches += 1
    return base


delta_apply.launches = 0
