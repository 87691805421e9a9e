"""Hand-written CUDA kernels for the checkpoint/rollback and serving paths.

* ``delta_diff`` — dirty-chunk bitmap of two byte grids (unfused dump plan).
* ``delta_fused`` — diff + ordered compaction + checksum lanes in one pass
  over the dirty bytes (default dump plan).
* ``delta_apply`` — scatter of compacted chunks into a base grid (slow
  restore).
* ``page_copy_stacked`` / ``page_copy`` — copy-on-write privatization of
  KV pool pages (the serving loop's CoW fault and async warm).
* ``paged_attention`` — GQA decode attention through a page table.
* ``moe_decode`` — a dropless MoE layer's decode step over the routed
  experts only (no TPU counterpart; its plain version is in its module).

Each kernel ships as ``csrc/<name>.cu`` plus a wrapper ``<name>.py`` that
checks its inputs, launches on the current stream and counts launches
(through ``accounting``, whose record a captured CUDA graph applies at each
replay);
``ops.py`` routes CUDA tensors to the kernels and CPU tensors to the plain
versions in ``ref.py``; ``_build.py`` compiles ``csrc/`` at first use.
"""
from . import ops, ref
from ._build import KernelBuildError, KernelError, KernelLaunchError
from .ops import (
    chunk_checksums_host,
    delta_apply,
    delta_compact,
    delta_diff,
    delta_encode,
    delta_fused,
    fused_encode,
    launch_counts,
    moe_decode,
    page_copy,
    page_copy_stacked,
    paged_attention,
    reset_launch_counts,
)

__all__ = [
    "ops",
    "ref",
    "KernelBuildError",
    "KernelError",
    "KernelLaunchError",
    "chunk_checksums_host",
    "delta_apply",
    "delta_compact",
    "delta_diff",
    "delta_encode",
    "delta_fused",
    "fused_encode",
    "launch_counts",
    "moe_decode",
    "page_copy",
    "page_copy_stacked",
    "paged_attention",
    "reset_launch_counts",
]
