"""Carry session state between numpy dicts and :class:`CowTensorState`.

The JAX package's states hand their payload out as ``Dict[str,
np.ndarray]`` (``dump_payload()``); these helpers build the port's device
state from the same dict and read it back, so both packages can be fed
identical state.  bfloat16 crosses as its raw 16-bit words: a numpy array
whose dtype is named ``bfloat16`` (``ml_dtypes``, present beside JAX only)
is reinterpreted bit for bit, and ``state_to_numpy`` returns bfloat16
tensors as ``uint16`` words, since numpy alone cannot hold them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .deltacr import CowTensorState

__all__ = ["state_from_numpy", "state_to_numpy", "tensor_from_numpy", "tensor_to_numpy"]

_WORDS = {torch.bfloat16: np.uint16}


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with the bits and logical dtype of ``arr``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def tensor_to_numpy(t: Any) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 as uint16 words); numpy
    arrays pass through."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype in _WORDS:
        return t.view(torch.int16).numpy().view(_WORDS[t.dtype]).copy()
    return t.numpy().copy()


def state_from_numpy(
    arrays: Dict[str, np.ndarray], device: Any = None, **kwargs: Any
) -> CowTensorState:
    """A :class:`CowTensorState` on ``device`` (the card by default) holding
    the bits of ``arrays``."""
    return CowTensorState(
        {k: tensor_from_numpy(v) for k, v in arrays.items()}, device=device, **kwargs
    )


def state_to_numpy(state: CowTensorState) -> Dict[str, np.ndarray]:
    """Host copies of every tensor of ``state`` (bfloat16 as uint16 words)."""
    return {k: tensor_to_numpy(state.get(k)) for k in state.keys()}
