"""Copy-on-write page privatization of a KV pool, in place.

CUDA kernel ``csrc/page_copy.cu`` replaces the JAX package's
``kernels/page_copy.py:page_copy_stacked`` and ``page_copy`` (Pallas TPU
kernels whose grid DMAs one page per step, with the indices as scalar
prefetch and the pool aliased to the output).  On the card the work is
bound by bytes: each source page is read once and each destination page
written once.  The design gives one thread block to each (pair, period)
and copies the page in 16-byte vectors; ``page_copy`` is the same launch
with one period.

The pool is **updated in place** and returned, as the TPU kernel's donated
pool is.  The indices are host values (lists, numpy arrays or tensors; a
CUDA index tensor costs a synchronisation to read), and the allocator's
invariants are checked on the host before any launch: equal lengths,
distinct ``dst``, ``src`` and ``dst`` disjoint, every index in range.  A
pool on the CPU is updated from ``ref.page_copy_stacked_ref``; a CUDA pool
launches the kernel or raises.  No pairs launch nothing.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from . import _build
from .ref import page_copy_stacked_ref

__all__ = ["launch_kernel", "page_copy", "page_copy_stacked"]


def _host_pairs(src_idx: Any, dst_idx: Any, n_pages: int) -> Tuple[np.ndarray, np.ndarray]:
    def host(x: Any) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.int64).reshape(-1)

    src, dst = host(src_idx), host(dst_idx)
    if src.shape != dst.shape:
        raise ValueError(f"page_copy: {src.size} sources but {dst.size} destinations")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n_pages):
        raise ValueError(f"page_copy: a page index lies outside [0, {n_pages})")
    if np.unique(dst).size != dst.size:
        raise ValueError("page_copy: destination pages are not distinct")
    if np.intersect1d(src, dst).size:
        raise ValueError("page_copy: source and destination pages overlap")
    return src, dst


def _copy(pool: torch.Tensor, src_idx: Any, dst_idx: Any) -> bool:
    """Copy pages of a stacked ``(N_periods, P, ...)`` pool in place;
    returns whether the kernel was launched."""
    if pool.dim() < 2:
        raise ValueError(f"page_copy wants a (N_periods, P, ...) pool, got {tuple(pool.shape)}")
    src, dst = _host_pairs(src_idx, dst_idx, pool.shape[1])
    if src.size == 0:
        return False
    if not pool.is_cuda:
        s = torch.from_numpy(src.astype(np.int32))
        d = torch.from_numpy(dst.astype(np.int32))
        pool.copy_(page_copy_stacked_ref(pool, s, d))
        return False
    if not pool.is_contiguous():
        raise ValueError("page_copy kernel needs a contiguous pool")
    s = torch.from_numpy(src.astype(np.int32)).to(pool.device)
    d = torch.from_numpy(dst.astype(np.int32)).to(pool.device)
    launch_kernel(pool, s, d)
    return True


def launch_kernel(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> None:
    """The kernel alone, on a contiguous CUDA ``(N_periods, P, ...)`` pool
    and int32 index tensors already on the card: no host checks (the
    caller holds the invariants), no launch counted.  The wrappers call it
    after their checks; a benchmark can capture it in a CUDA graph."""
    n_periods, n_pages = pool.shape[0], pool.shape[1]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    vec = page_bytes % 16 == 0 and pool.data_ptr() % 16 == 0
    lib = _build.library()
    err = lib.repro_page_copy(
        pool.data_ptr(), src.data_ptr(), dst.data_ptr(), n_periods, n_pages, src.numel(),
        page_bytes, int(vec), _build.stream_handle(pool),
    )
    _build.check(err, "page_copy")


def page_copy_stacked(pool: torch.Tensor, src_idx: Any, dst_idx: Any) -> torch.Tensor:
    """``pool[:, dst] = pool[:, src]`` in place over ``(N_periods, P, psz,
    KVH, D)``; returns ``pool``."""
    if _copy(pool, src_idx, dst_idx):
        page_copy_stacked.launches += 1
    return pool


def page_copy(pool: torch.Tensor, src_idx: Any, dst_idx: Any) -> torch.Tensor:
    """``pool[dst] = pool[src]`` in place over ``(P, psz, KVH, D)``;
    returns ``pool``."""
    if _copy(pool[None], src_idx, dst_idx):
        page_copy.launches += 1
    return pool


page_copy_stacked.launches = 0
page_copy.launches = 0
