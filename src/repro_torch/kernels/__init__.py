"""Hand-written CUDA kernels for the checkpoint/rollback hot path.

* ``delta_diff`` — dirty-chunk bitmap of two byte grids (unfused dump plan).
* ``delta_fused`` — diff + ordered compaction + checksum lanes in one pass
  over the dirty bytes (default dump plan).
* ``delta_apply`` — scatter of compacted chunks into a base grid (slow
  restore).

Each kernel ships as ``csrc/<name>.cu`` plus a wrapper ``<name>.py`` that
checks its inputs, launches on the current stream and counts launches;
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
    "reset_launch_counts",
]
