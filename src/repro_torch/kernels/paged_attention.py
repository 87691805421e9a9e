"""Decode attention through a copy-on-write page table.

CUDA kernel ``csrc/paged_attention.cu`` replaces the JAX package's
``kernels/paged_attention.py:paged_attention`` (a Pallas TPU kernel whose
grid walks ``(B, KVH, max_pages)`` in order, carrying a flash-style online
softmax in VMEM, with the page table and lengths as scalar prefetch).  On
the card the work is bound by bytes: each session's active K and V pages
are read once for about 2·G flops per element.  The design is split-K in
one launch: each (sequence, kv head) gets a thread-block cluster of
``split_count(B, KVH, max_pages)`` blocks, which share out the session's
active pages, stage them in shared memory with ``cp.async``, keep their own
float32 online softmax a 16-token tile at a time (bfloat16 on the tensor
cores with ``mma.sync``, float32 on the CUDA cores), and merge through
distributed shared memory with a log-sum-exp combine.  Pages past a
session's active count are never read; a session with ``seq_len == 0``
gets 0, as from the TPU kernel.

Layout, as in the JAX package: q ``(B, KVH, G, D)``, pages
``(P, page_size, KVH, D)``, table ``(B, max_pages)`` int32 of valid page
ids, ``seq_lens`` ``(B,)`` int32; float32 or bfloat16; out in q's type.
The kernel takes D in {64, 128, 256} and G up to 8.  A tensor on the CPU
goes to ``ref.paged_attention_ref``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, accounting
from .ref import paged_attention_ref

__all__ = ["paged_attention", "split_count", "max_active_clusters"]

KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_MAX_GROUP = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132
MAX_SPLIT = 16               # the largest cluster the card takes (non-portable above 8)
MIN_PAGES_PER_BLOCK = 4      # a narrower table is not worth splitting


def split_count(batch: int, kv_heads: int, max_pages: int, sms: int = H100_SMS) -> int:
    """Blocks per (sequence, kv head) cluster, from shapes only.

    The smallest power of two that gives at least one block per SM over the
    ``batch · kv_heads`` clusters, at most ``MAX_SPLIT``, and at most one
    block per ``MIN_PAGES_PER_BLOCK`` pages of the table (so never more than
    ``max_pages``).  The kernel splits each session's *active* pages over
    the cluster, so a block of a short session may get none; reading the
    lengths here would cost a host sync per layer."""
    heads = batch * kv_heads
    if heads <= 0 or max_pages < 2 * MIN_PAGES_PER_BLOCK:
        return 1
    want = 1 << (-(-sms // heads) - 1).bit_length()
    cap = min(MAX_SPLIT, want, max_pages // MIN_PAGES_PER_BLOCK)
    return 1 << (cap.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """See the module docstring.  ``scale=None`` means ``1/sqrt(D)``."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention wants q (B, KVH, G, D) and pages (P, psz, KVH, D), "
                         f"got {tuple(q.shape)} / {tuple(k_pages.shape)}")
    B, KVH, G, D = q.shape
    P, psz, kvh_k, d_k = k_pages.shape
    if (kvh_k, d_k) != (KVH, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(f"paged_attention: table {tuple(page_table.shape)} / lengths "
                         f"{tuple(seq_lens.shape)} do not match B={B}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: page table and lengths must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"paged_attention: q {q.dtype}, k {k_pages.dtype}, v {v_pages.dtype}")
    if len({t.device for t in (q, k_pages, v_pages, page_table, seq_lens)}) != 1:
        raise ValueError("paged_attention: inputs lie on different devices")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, scale=scale)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS or not 1 <= G <= KERNEL_MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes D in {KERNEL_HEAD_DIMS} and "
                         f"G <= {KERNEL_MAX_GROUP}, got D={D}, G={G}")
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention kernel needs 16-byte aligned q and pages")
    out = torch.empty_like(q)
    max_pages = page_table.shape[1]
    split = split_count(B, KVH, max_pages, _sm_count(q.device.index or 0))
    lib = _build.library()
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, KVH, G, D, psz, max_pages, split,
        float(scale), _DTYPE_CODE[q.dtype], _build.stream_handle(q),
    )
    _build.check(err, "paged_attention")
    accounting.count_launches(paged_attention)
    return out


paged_attention.launches = 0


def max_active_clusters(group: int, head_dim: int, dtype: torch.dtype, split: int) -> int:
    """How many clusters of ``split`` blocks of the kernel for this group
    size, head dim and type the card holds at once (the CUDA occupancy
    calculator; nothing is launched).  A launch of more clusters runs in
    waves."""
    n = ctypes.c_int(-1)
    err = _build.library().repro_paged_attention_clusters(
        group, head_dim, split, _DTYPE_CODE[dtype], ctypes.addressof(n))
    _build.check(err, "paged_attention occupancy")
    return n.value
