"""Public entry points for the delta kernels.

Routing is by the tensor's device, per call:

* a **CUDA** tensor goes to the hand-written kernel (``delta_diff.py``,
  ``delta_fused.py``, ``delta_apply.py``), which launches on the current
  stream or raises.  Nothing sends a CUDA tensor to the plain version.
* a **CPU** tensor goes to the plain PyTorch version in ``ref.py``, which
  is bit-identical to the JAX package's jnp oracles.

Also here: the torch-op compaction (``delta_compact``), the numpy mirror of
the checksum lanes the dump drain checks fetched rows against, and the
device→host fetch (non-blocking copies into pinned host tensors, completed
by a CUDA event).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import ref as _ref
from .delta_apply import delta_apply
from .delta_diff import delta_diff
from .delta_fused import delta_fused
from .ref import CHECKSUM_LANES

__all__ = [
    "delta_diff",
    "delta_fused",
    "delta_apply",
    "delta_compact",
    "delta_encode",
    "fused_encode",
    "chunk_checksums_device",
    "chunk_checksums_host",
    "HostFetch",
    "device_fetch",
    "start_host_fetch",
    "launch_counts",
    "reset_launch_counts",
    "CHECKSUM_LANES",
]

_KERNELS = {"delta_diff": delta_diff, "delta_fused": delta_fused, "delta_apply": delta_apply}


def launch_counts() -> dict:
    """Kernel launches on CUDA tensors since the last reset, by kernel."""
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
