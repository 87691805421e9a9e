"""Copy-on-write page privatization of KV pools, in place.

CUDA kernel ``csrc/page_copy.cu`` replaces the JAX package's
``kernels/page_copy.py:page_copy_stacked`` and ``page_copy`` (Pallas TPU
kernels whose grid DMAs one page per step, with the indices as scalar
prefetch and the pool aliased to the output).  On the card the work is
bound by bytes: each source page is read once and each destination page
written once.  One launch copies the pairs in up to ``MAX_POOLS`` pools of
one shape (a serving pool's K and V pools of every attention sublayer) for
up to ``MAX_PAIRS`` pairs; the pool pointers and the pairs travel by value
in the kernel's parameters, so no index is copied to the card.  The grid
gives one block to each (pool, pair, period, 4 KiB segment of the page).
More pools or pairs launch again, in chunks, each chunk counted.
``page_copy`` is the same launch with one period.

The pools are **updated in place** and returned, as the TPU kernel's
donated pool is.  The indices are host values (lists, numpy arrays or
tensors; a CUDA index tensor costs a synchronisation to read), and the
allocator's invariants are checked on the host before any launch: equal
lengths, distinct ``dst``, ``src`` and ``dst`` disjoint, every index in
range.  A pool on the CPU is updated from ``ref.page_copy_stacked_ref``; a
CUDA pool launches the kernel or raises.  No pairs launch nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, List, Sequence, Tuple, Union

import numpy as np
import torch

from . import _build, accounting
from .ref import page_copy_stacked_ref

__all__ = ["MAX_PAIRS", "MAX_POOLS", "launch_kernel", "page_copy", "page_copy_stacked"]

MAX_POOLS = 8              # pool pointers in one launch's parameters (kMaxPools)
MAX_PAIRS = 256            # (src, dst) pairs in one launch's parameters (kMaxPairs)

Pools = Union[torch.Tensor, Sequence[torch.Tensor]]


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


def _pool_list(pool: Pools) -> List[torch.Tensor]:
    """One pool or a sequence of pools of one shape, dtype and device."""
    pools = [pool] if isinstance(pool, torch.Tensor) else list(pool)
    if not pools or not all(isinstance(p, torch.Tensor) for p in pools):
        raise ValueError("page_copy_stacked wants a pool tensor or a non-empty sequence of them")
    first = pools[0]
    if first.dim() < 2:
        raise ValueError(f"page_copy wants a (N_periods, P, ...) pool, got {tuple(first.shape)}")
    for p in pools[1:]:
        if p.shape != first.shape or p.dtype != first.dtype or p.device != first.device:
            raise ValueError(
                f"page_copy_stacked: pools differ ({tuple(p.shape)} {p.dtype} {p.device} "
                f"against {tuple(first.shape)} {first.dtype} {first.device})"
            )
    return pools


def _copy(pools: List[torch.Tensor], src_idx: Any, dst_idx: Any) -> int:
    """Copy pages of stacked ``(N_periods, P, ...)`` pools in place;
    returns the kernel launches made."""
    first = pools[0]
    src, dst = _host_pairs(src_idx, dst_idx, first.shape[1])
    if src.size == 0 or first.numel() == 0:
        return 0
    if not first.is_cuda:
        s = torch.from_numpy(src.astype(np.int32))
        d = torch.from_numpy(dst.astype(np.int32))
        for p in pools:
            p.copy_(page_copy_stacked_ref(p, s, d))
        return 0
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("page_copy kernel needs contiguous pools")
    return launch_kernel(pools, src, dst)


def launch_kernel(pools: Sequence[torch.Tensor], src: Any, dst: Any) -> int:
    """The kernel alone, on contiguous CUDA ``(N_periods, P, ...)`` pools of
    one shape and dtype and host index arrays: no checks (the caller holds
    the invariants), no launch counted.  Launches once per chunk of
    ``MAX_POOLS`` pools × ``MAX_PAIRS`` pairs and returns the launches.
    The wrappers call it after their checks; a benchmark can capture it in
    a CUDA graph (the pairs are copied into the graph's kernel nodes)."""
    src = np.ascontiguousarray(src, dtype=np.int32).reshape(-1)
    dst = np.ascontiguousarray(dst, dtype=np.int32).reshape(-1)
    first = pools[0]
    n_periods, n_pages = first.shape[0], first.shape[1]
    page_bytes = math.prod(first.shape[2:]) * first.element_size()
    vec = page_bytes % 16 == 0 and all(p.data_ptr() % 16 == 0 for p in pools)
    lib = _build.library()
    stream = _build.stream_handle(first)
    launches = 0
    for i in range(0, len(pools), MAX_POOLS):
        chunk = pools[i : i + MAX_POOLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*(p.data_ptr() for p in chunk))
        for j in range(0, src.size, MAX_PAIRS):
            s, d = src[j : j + MAX_PAIRS], dst[j : j + MAX_PAIRS]
            err = lib.repro_page_copy(
                ctypes.addressof(ptrs), len(chunk), s.ctypes.data, d.ctypes.data, s.size,
                n_periods, n_pages, page_bytes, int(vec), stream,
            )
            _build.check(err, "page_copy")
            launches += 1
    return launches


def page_copy_stacked(pool: Pools, src_idx: Any, dst_idx: Any) -> Pools:
    """``pool[:, dst] = pool[:, src]`` in place over ``(N_periods, P, psz,
    KVH, D)``, for one pool or for each pool of a sequence of pools of one
    shape, dtype and device; returns what it was given."""
    accounting.count_launches(page_copy_stacked, _copy(_pool_list(pool), src_idx, dst_idx))
    return pool


def page_copy(pool: torch.Tensor, src_idx: Any, dst_idx: Any) -> torch.Tensor:
    """``pool[dst] = pool[src]`` in place over ``(P, psz, KVH, D)``;
    returns ``pool``."""
    accounting.count_launches(page_copy, _copy(_pool_list(pool[None]), src_idx, dst_idx))
    return pool


page_copy_stacked.launches = 0
page_copy.launches = 0
