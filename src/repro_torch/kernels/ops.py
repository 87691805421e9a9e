"""Public entry points for the kernels.

Routing is by the tensor's device, per call:

* a **CUDA** tensor goes to the hand-written kernel (``delta_diff.py``,
  ``delta_fused.py``, ``delta_apply.py``, ``page_copy.py``,
  ``paged_attention.py``, ``moe_decode.py``), which launches on the
  current stream or raises.  Nothing sends a CUDA tensor to the plain
  version.
* a **CPU** tensor goes to the plain PyTorch version in ``ref.py``, which
  is bit-identical to the JAX package's jnp oracles (``moe_decode``, which
  has no JAX counterpart, keeps its plain version in its own module).

Also here: the torch-op compaction (``delta_compact``), the block-native
diff of one shard part (``shard_block_encode``, torch ops: the JAX
package's is a jnp jit, not a Pallas kernel), the numpy mirror of the
checksum lanes the dump drain checks fetched rows against, and the
device→host fetches (non-blocking copies into pinned host tensors,
completed by a CUDA event), whole or per shard block.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from . import ref as _ref
from .delta_apply import delta_apply
from .delta_diff import delta_diff
from .delta_fused import delta_fused
from .moe_decode import moe_decode
from .page_copy import page_copy, page_copy_stacked
from .paged_attention import paged_attention
from .ref import CHECKSUM_LANES

__all__ = [
    "paged_attention",
    "moe_decode",
    "page_copy",
    "page_copy_stacked",
    "delta_diff",
    "delta_fused",
    "delta_apply",
    "delta_compact",
    "delta_encode",
    "fused_encode",
    "shard_block_encode",
    "chunk_checksums_device",
    "chunk_checksums_host",
    "HostFetch",
    "device_fetch",
    "start_host_fetch",
    "start_shard_fetch",
    "shard_fetch",
    "shard_fetch_assemble",
    "launch_counts",
    "reset_launch_counts",
    "CHECKSUM_LANES",
]

_KERNELS = {
    "delta_diff": delta_diff,
    "delta_fused": delta_fused,
    "delta_apply": delta_apply,
    "page_copy": page_copy,
    "page_copy_stacked": page_copy_stacked,
    "paged_attention": paged_attention,
    "moe_decode": moe_decode,
}


def launch_counts() -> dict:
    """Kernel launches on CUDA tensors since the last reset, by kernel.  A
    replay of a captured CUDA graph adds the launches its capture recorded
    (``accounting``), so a graphed step counts what an eager one does."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0


def delta_compact(new: torch.Tensor, dirty: torch.Tensor, max_changed: int):
    """Fixed-capacity compaction of dirty chunks (torch ops on any device;
    plain jnp in the JAX package too)."""
    return _ref.delta_compact_ref(new, dirty, int(max_changed))


def delta_encode(old: torch.Tensor, new: torch.Tensor, max_changed: int):
    """diff + compact: (data, idx, count).  The unfused dump plan: the
    ``delta_diff`` kernel followed by the torch-op compaction."""
    return _ref.delta_compact_ref(new, delta_diff(old, new), int(max_changed))


def fused_encode(old: torch.Tensor, new: torch.Tensor, max_changed: int):
    """diff + compact + checksum: (data, idx, count, sums), one kernel pass
    over the dirty bytes on the card."""
    return delta_fused(old, new, max_changed=int(max_changed))


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def shard_block_encode(old: torch.Tensor, new: torch.Tensor, counts: Tuple[int, ...],
                       tile: Tuple[int, ...], max_changed: int):
    """Block-native diff + compact for one shard part: ``(data, idx,
    count)`` with ``delta_encode``'s contract, over the part's native block
    layout instead of a materialized tile grid.

    Per-tile dirtiness is a compare + reduce over the tile axes (one read of
    old and new, nothing written back), and only the ``max_changed`` first
    dirty tiles are extracted — each as its row-major bytes, identical to
    the matching ``device_tile_grid`` row.  Slots are ascending, padded with
    -1, and ``count`` counts every dirty tile (``count > max_changed`` is
    the overflow signal).  Tiles compare bit for bit (as words of the
    element size), so a -0.0 → 0.0 write is dirty and an unchanged NaN is
    clean; the JAX package compares values.  Torch ops on the block's
    device, with no host sync."""
    nd = len(counts)
    cap = int(max_changed)
    inter: List[int] = []
    for c, t in zip(counts, tile):
        inter.extend((c, t))
    words = _WORDS[new.element_size()]
    o = old if old.dtype == words else old.view(words)
    n = new if new.dtype == words else new.view(words)
    neq = (o != n).reshape(inter)
    dirty = neq.any(dim=tuple(2 * i + 1 for i in range(nd))).reshape(-1)
    n_local = dirty.numel()
    count = dirty.sum(dtype=torch.int32)
    pos = torch.cumsum(dirty, 0, dtype=torch.int64) - 1
    slot = torch.where(dirty & (pos < cap), pos, torch.full_like(pos, cap))
    buf = torch.full((cap + 1,), -1, dtype=torch.int32, device=new.device)
    buf.scatter_(0, slot, torch.arange(n_local, dtype=torch.int32, device=new.device))
    idx = buf[:cap]
    perm = [2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
    tiles = new.reshape(inter).permute(perm)          # (c0..ck, t0..tk), a view
    coords = torch.unravel_index(idx.clamp(min=0).to(torch.int64), tuple(counts))
    rows = tiles[coords].reshape(cap, -1).contiguous()
    u8 = rows if rows.dtype == torch.uint8 else rows.view(torch.uint8)
    data = torch.where((idx >= 0)[:, None], u8, torch.zeros_like(u8))
    return data, idx, count


def chunk_checksums_device(chunks: torch.Tensor) -> torch.Tensor:
    """``ref.chunk_checksums_ref`` lanes on the chunks' own device."""
    return _ref.chunk_checksums_ref(chunks)


# numpy mirror constants of ref.chunk_checksums_ref — kept in lockstep
_CS_MULT = np.uint32(2654435761)
_CS_ADD = np.uint32(40503)
_CS_XOR = np.uint32(2246822519)


def chunk_checksums_host(chunks: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``ref.chunk_checksums_ref``: (N, C) → (N, 4) uint32.

    The dump drain validates fetched fused-kernel rows against the
    device-computed lanes with it, in one vectorized host pass."""
    x = np.ascontiguousarray(chunks).astype(np.uint32)
    if x.ndim == 1:
        x = x[None, :]
    C = x.shape[-1]
    pos = np.arange(C, dtype=np.uint32)[None, :]
    w = pos * _CS_MULT + _CS_ADD
    s0 = np.sum(x, axis=-1, dtype=np.uint32)
    s1 = np.sum(x * (pos + np.uint32(1)), axis=-1, dtype=np.uint32)
    s2 = np.sum(x * w, axis=-1, dtype=np.uint32)
    s3 = np.sum((x + np.uint32(1)) * (w ^ _CS_XOR), axis=-1, dtype=np.uint32)
    return np.stack([s0, s1, s2, s3], axis=-1)


class HostFetch:
    """Device→host copies in flight: ``non_blocking`` copies of the CUDA
    tensors into pinned host tensors, and a CUDA event recorded behind them
    on the current stream.  ``wait()`` blocks on the event and returns the
    host arrays.  CPU tensors are returned as they are.  A failed copy
    raises here or in ``wait()``; it is never swallowed."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._host: List[torch.Tensor] = []
        self._event = None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                if self._event is None:
                    self._event = torch.cuda.Event()
            else:
                h = t
            self._host.append(h)
        if self._event is not None:
            self._event.record(torch.cuda.current_stream())

    @property
    def from_device(self) -> bool:
        return self._event is not None

    @property
    def nbytes(self) -> int:
        return sum(h.numel() * h.element_size() for h in self._host)

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def start_host_fetch(*tensors: torch.Tensor) -> HostFetch:
    """Begin device→host copies without blocking; see :class:`HostFetch`."""
    return HostFetch(tensors)


def device_fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Materialize tensors on the host, overlapping the copies."""
    return start_host_fetch(*tensors).wait()


# --------------------------------------------------------------------------
# shard-granular fetches (the gather-free dump path)
# --------------------------------------------------------------------------
def _blocks(array: Any) -> List[Tuple[Any, Any, torch.Tensor]]:
    """(rank, index, block) of each distinct block: a sharded tensor's
    ``unique_shards()``, the tensor itself (rank None) otherwise."""
    unique = getattr(array, "unique_shards", None)
    if unique is None:
        return [(None, tuple(slice(0, d) for d in array.shape), array)]
    return [(sh.rank, sh.index, sh.data) for sh in unique()]


def start_shard_fetch(*arrays: Any) -> List[HostFetch]:
    """Begin device→host copies of every distinct block of each array, each
    from its own block (never a gathered copy); one :class:`HostFetch` per
    block, in order.  bfloat16 blocks travel as 16-bit words."""
    from ..core.convert import as_words

    return [
        start_host_fetch(as_words(block.contiguous()))
        for a in arrays
        for _rank, _index, block in _blocks(a)
    ]


def shard_fetch(array: Any) -> List[Tuple[Any, Any]]:
    """Explicit per-block device→host fetch: ``[(rank, host_block), ...]``,
    one entry per distinct block (replicas fetched once).  Host blocks are
    numpy arrays, or CPU tensors for bfloat16; a plain tensor is one block
    of rank None."""
    from ..core.convert import from_words

    blocks = _blocks(array)
    fetches = start_shard_fetch(array)
    return [
        (rank, from_words(f.wait()[0], block.dtype))
        for (rank, _index, block), f in zip(blocks, fetches)
    ]


def shard_fetch_assemble(array: Any) -> Any:
    """Host copy of a (possibly sharded) tensor assembled from per-block
    fetches: O(S) bytes move, each block once from its own device, and the
    assembly happens in host memory.  A numpy array passes through;
    bfloat16 comes back as a CPU tensor."""
    from ..core.convert import from_words

    if isinstance(array, np.ndarray):
        return array
    blocks = _blocks(array)
    fetches = start_shard_fetch(array)
    out = None
    for (_rank, index, _block), f in zip(blocks, fetches):
        host = f.wait()[0]
        if out is None:
            out = np.empty(tuple(array.shape), dtype=host.dtype)
        out[index] = host
    return from_words(out, array.dtype)
