"""Carry session state and model weights between numpy and the port.

The JAX package's states hand their payload out as ``Dict[str,
np.ndarray]`` (``dump_payload()``) and its models their weights as a
nested dict of arrays; these helpers build the port's device state and
``Model`` weights from the same numpy trees and read them back, so both
packages can be fed identical bytes.  bfloat16 crosses as its raw 16-bit
words: a numpy array whose dtype is named ``bfloat16`` (``ml_dtypes``,
present beside JAX only) is reinterpreted bit for bit, and the ``*_to_numpy``
helpers return bfloat16 tensors as ``uint16`` words, since numpy alone
cannot hold them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .deltacr import CowTensorState

__all__ = [
    "as_words",
    "from_words",
    "params_from_numpy",
    "params_to_numpy",
    "sharded_state_from_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "tensor_from_numpy",
    "tensor_to_numpy",
]

_WORDS = {torch.bfloat16: torch.int16}


def as_words(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype numpy can hold, bit for bit: bfloat16 as int16
    words (a view), any other dtype unchanged."""
    words = _WORDS.get(t.dtype)
    return t if words is None else t.view(words)


def from_words(a: np.ndarray, dtype: torch.dtype) -> Any:
    """Inverse of :func:`as_words` on the host: the words of a bfloat16
    tensor come back as a CPU tensor sharing ``a``'s memory; an array of
    any other dtype is returned as it is."""
    return torch.from_numpy(a).view(dtype) if dtype in _WORDS else a


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
    host = as_words(t).numpy()
    return (host.view(np.uint16) if t.dtype in _WORDS else host).copy()


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


def sharded_state_from_numpy(
    arrays: Dict[str, np.ndarray], shardings: Dict[str, Any], device: Any = None
) -> Any:
    """A ``dist.shard_dump.ShardedTensorState`` holding the bits of
    ``arrays``: each key placed on its ``NamedSharding`` in ``shardings``
    (block by block onto the mesh's ranks), a key without one as a plain
    tensor on ``device`` (the card by default)."""
    from ..dist.placement import device_put
    from ..dist.shard_dump import ShardedTensorState
    from .deltacr import resolve_device

    out: Dict[str, Any] = {}
    dev = None
    for key, arr in arrays.items():
        target = shardings.get(key)
        if target is not None:
            out[key] = device_put(tensor_from_numpy(arr), target)
        else:
            if dev is None:
                dev = resolve_device(device)
            out[key] = tensor_from_numpy(arr).to(dev)
    return ShardedTensorState(out)


def params_from_numpy(tree: Dict[str, Any], device: Any = None) -> Dict[str, Any]:
    """The JAX package's params pytree (nested dicts of numpy arrays) as the
    same tree of tensors on ``device`` (the card by default), for
    ``Model(cfg, params=...)``.  ``uint16`` leaves are bfloat16 words (as
    ``params_to_numpy`` writes them; no weight of the models is uint16) and
    are reinterpreted, never converted."""
    from .deltacr import resolve_device

    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = tensor_from_numpy(np.asarray(node))
        if t.dtype == torch.uint16:
            t = t.view(torch.bfloat16)
        return t.to(dev).contiguous()

    return walk(tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Host numpy copies of a params tree (bfloat16 as uint16 words)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)
