"""Mesh construction for the port.

Single pod: (16, 16) over ("data", "model"), 256 ranks; multi-pod: (2, 16,
16) over ("pod", "data", "model"), 512 ranks, "pod" an outer pure
data-parallel axis.  A production mesh puts one rank on each card and
raises when the machine has fewer cards than ranks.  A *logical* mesh lays
any number of ranks onto one device (the sharded dump path then runs rank
by rank on one card); :func:`make_local_mesh` spreads whatever cards the
machine has over ("data", "model").

Functions, not module constants: importing this module touches no device.
Every function here takes ``device`` (the card unless the caller asks for the
CPU; without a card it raises).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..core.deltacr import resolve_device
from ..dist.placement import Mesh

__all__ = ["make_local_mesh", "make_logical_mesh", "make_production_mesh"]


def _cards(device: Any) -> list:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False, device: Any = None) -> Mesh:
    """One rank per card over the production layout; raises when the
    machine has fewer cards than the mesh has ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devices = _cards(device)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {len(devices)} — "
            "use make_logical_mesh to lay the ranks onto fewer cards"
        )
    return Mesh(shape, axes, devices[:n])


def make_local_mesh(model_parallel: int = 1, *, device: Any = None) -> Mesh:
    """Whatever-is-available mesh over ("data", "model"), one rank a card."""
    devices = _cards(device)
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel={model_parallel}")
    return Mesh((n // model_parallel, model_parallel), ("data", "model"), devices)


def make_logical_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data", "model"),
    *,
    device: Any = None,
) -> Mesh:
    """Every rank of ``shape`` on one device (the card by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape, axis_names, dev)
