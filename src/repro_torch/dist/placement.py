"""Logical meshes and sharded tensors: the port's counterpart of ``jax.sharding``.

In JAX's single-controller mode a ``jax.Array`` is a global shape plus its
``addressable_shards`` (index, device, data), all held by one process, and
the sharded dump path is written against that.  The port keeps the same
picture without one process per rank:

* :class:`Mesh` — named axes over a grid of **ranks**, each rank mapped to
  a ``torch.device``.  Several ranks may share one card: a (4, 2) mesh on
  one H100 places eight ranks' blocks on ``cuda:0``.  Every per-shard plan,
  byte count and restore of the sharded dump path then runs rank by rank,
  as it would across cards; what a shared card does not exercise is the
  traffic between cards.
* :class:`PartitionSpec` / :class:`NamedSharding` — a spec entry names the
  mesh axes a dimension is split over (``None``, an axis, or a tuple of
  axes, major first); ``addressable_devices_indices_map`` is keyed by
  **rank** (a dict by device would fold the ranks of one card into one).
* :class:`ShardedTensor` — global shape, dtype, sharding and one
  :class:`Shard` (rank, device, index, contiguous block) per rank.  Blocks
  are never written in place: an update builds a new tensor that copies
  the blocks it touches and shares the rest (:meth:`ShardedTensor.with_box`,
  :meth:`ShardedTensor.with_flat`), so a fork or a dump anchor that holds
  the old tensor keeps its bytes.  Ranks of one device that hold the same
  index share one block tensor (replication costs no extra memory on a
  shared card).
* :func:`with_sharding_constraint` is ``jax.lax.with_sharding_constraint``
  for one process that computes the whole tensor: it checks the spec and
  returns the tensor unchanged (the values are the unsharded ones, as
  GSPMD's are).
* :func:`device_put` places a tensor (or a numpy array, or another
  sharded tensor: a reshard, block by block, never through a gathered
  copy) onto a sharding; :func:`from_blocks` is
  ``make_array_from_single_device_arrays``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "Shard",
    "ShardedTensor",
    "device_put",
    "from_blocks",
    "with_sharding_constraint",
]

Index = Tuple[slice, ...]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:N``, so block devices compare."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over a row-major grid of ranks, one ``torch.device`` each.

    ``devices`` lists the device of every rank (rank order); one device is
    repeated for all ranks, and a logical mesh on one card repeats it."""

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Sequence[str],
        devices: Any,
    ):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        n = int(np.prod(shape, dtype=np.int64))
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * n
        devs = [_indexed(torch.device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh {shape} needs {n} rank devices, got {len(devs)}")
        self.axis_names = axis_names
        self.rank_devices: Tuple[torch.device, ...] = tuple(devs)
        self.ranks = np.arange(n, dtype=np.int64).reshape(shape)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def device_set(self) -> set:
        return set(self.rank_devices)

    def device_of(self, rank: int) -> torch.device:
        return self.rank_devices[rank]

    def coords(self, rank: int) -> Dict[str, int]:
        """The rank's coordinate along every axis."""
        at = np.unravel_index(int(rank), self.ranks.shape)
        return {a: int(c) for a, c in zip(self.axis_names, at)}

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.rank_devices})
        return f"Mesh({self.shape}, devices={devs})"


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None``, an axis name, or a tuple of axis
    names (major first).  A 1-tuple is normalized to its bare name, as
    ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`.  Dimensions past the
    spec's length are unsharded; every split must divide its dimension."""

    def __init__(self, mesh: Mesh, spec: Any):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        used: List[str] = []
        for entry in self.spec:
            for a in _axes(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {a!r} not in {mesh.axis_names}")
                used.append(a)
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")

    @property
    def device_set(self) -> set:
        return self.mesh.device_set

    def split_counts(self, ndim: int) -> Tuple[int, ...]:
        sizes = self.mesh.shape
        out = []
        for d in range(ndim):
            entry = self.spec[d] if d < len(self.spec) else None
            out.append(int(np.prod([sizes[a] for a in _axes(entry)], dtype=np.int64)))
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        counts = self.split_counts(len(shape))
        for dim, c in zip(shape, counts):
            if dim % c:
                raise ValueError(
                    f"shape {tuple(shape)} does not split evenly under {self.spec} "
                    f"on {self.mesh}"
                )
        return tuple(int(dim) // c for dim, c in zip(shape, counts))

    def addressable_devices_indices_map(self, shape: Sequence[int]) -> Dict[int, Index]:
        """Rank → the slice of the global tensor that rank holds (every
        rank is addressable: one process holds the whole mesh)."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than shape {shape}")
        block = self.shard_shape(shape)
        sizes = self.mesh.shape
        out: Dict[int, Index] = {}
        for rank in range(self.mesh.size):
            at = self.mesh.coords(rank)
            index = []
            for d, dim in enumerate(shape):
                entry = self.spec[d] if d < len(self.spec) else None
                coord = 0
                for a in _axes(entry):      # major first
                    coord = coord * sizes[a] + at[a]
                start = coord * block[d]
                index.append(slice(start, start + block[d]))
            out[rank] = tuple(index)
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def with_sharding_constraint(x: torch.Tensor, sharding: Any) -> torch.Tensor:
    """``x`` itself, after checking ``sharding`` (a :class:`NamedSharding`
    or a bare :class:`PartitionSpec`) against it: at most ``x.ndim``
    entries, each None, an axis name or a tuple of names, and every named
    axis in the mesh when there is one.  A spec that fails raises."""
    mesh = sharding.mesh if isinstance(sharding, NamedSharding) else None
    spec = sharding.spec if mesh is not None else sharding
    if not isinstance(spec, PartitionSpec):
        raise TypeError(f"expected a NamedSharding or PartitionSpec, got {type(sharding).__name__}")
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the {x.dim()}-d tensor")
    for entry in spec:
        axes = _axes(entry)
        if not all(isinstance(a, str) for a in axes):
            raise ValueError(f"spec {spec}: entry {entry!r} is not an axis name")
        if mesh is not None and any(a not in mesh.axis_names for a in axes):
            raise ValueError(f"spec {spec} names an axis not in {mesh.axis_names}")
    return x


@dataclass(frozen=True)
class Shard:
    """One rank's block of a :class:`ShardedTensor`."""

    rank: int
    device: torch.device
    index: Index
    data: torch.Tensor


def _index_key(index: Index) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in index)


class ShardedTensor:
    """A global tensor held as one contiguous block per rank.

    ``addressable_shards`` lists every rank's :class:`Shard` in rank order;
    ``nbytes`` is the global size, as ``jax.Array.nbytes``."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype: torch.dtype,
        sharding: NamedSharding,
        shards: Sequence[Shard],
    ):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.addressable_shards: List[Shard] = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.numel * torch.empty((), dtype=self.dtype).element_size()

    def unique_shards(self) -> List[Shard]:
        """One shard per distinct index (replicas fold to the lowest rank)."""
        seen: Dict[Tuple, Shard] = {}
        for sh in self.addressable_shards:
            seen.setdefault(_index_key(sh.index), sh)
        return list(seen.values())

    def full(self, device: Any = None) -> torch.Tensor:
        """The global tensor assembled on ``device`` (the first shard's
        device by default) from one copy of each distinct block."""
        shards = self.unique_shards()
        dev = torch.device(device) if device is not None else shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for sh in shards:
            out[sh.index] = sh.data.to(dev)
        return out

    def with_box(self, index: Sequence[slice], value: torch.Tensor) -> "ShardedTensor":
        """A new tensor equal to this one with ``value`` written at the box
        ``index`` (one slice per leading dimension, steps of 1).  Blocks the
        box touches are copied and written; the others are shared."""
        box = [slice(*s.indices(dim)[:2]) for s, dim in zip(index, self.shape)]
        box += [slice(0, dim) for dim in self.shape[len(box):]]
        want = tuple(b.stop - b.start for b in box)
        value = value.expand(want) if tuple(value.shape) != want else value

        def write(sh: Shard) -> Optional[torch.Tensor]:
            lo = [max(b.start, s.start) for b, s in zip(box, sh.index)]
            hi = [min(b.stop, s.stop) for b, s in zip(box, sh.index)]
            if any(h <= l for l, h in zip(lo, hi)):
                return None
            block = sh.data.clone()
            dst = tuple(slice(l - s.start, h - s.start) for l, h, s in zip(lo, hi, sh.index))
            src = tuple(slice(l - b.start, h - b.start) for l, h, b in zip(lo, hi, box))
            block[dst] = value[src].to(block.device, block.dtype)
            return block

        return self._rebuilt(write)

    def with_flat(self, positions: torch.Tensor, values: torch.Tensor) -> "ShardedTensor":
        """A new 1-D tensor equal to this one with ``values[j]`` written at
        element ``positions[j]`` (distinct positions).  Blocks that receive
        a write are copied; the others are shared."""
        if self.ndim != 1:
            raise ValueError("with_flat takes a 1-D tensor")

        def write(sh: Shard) -> Optional[torch.Tensor]:
            s = sh.index[0]
            pos = positions.to(sh.device)
            hit = (pos >= s.start) & (pos < s.stop)
            if not bool(hit.any()):
                return None
            block = sh.data.clone()
            block[pos[hit] - s.start] = values.to(sh.device, block.dtype)[hit]
            return block

        return self._rebuilt(write)

    def _rebuilt(self, write) -> "ShardedTensor":
        # one write per (index, device): replicas on one card share a block
        made: Dict[Tuple, Optional[torch.Tensor]] = {}
        shards = []
        for sh in self.addressable_shards:
            key = (_index_key(sh.index), sh.device)
            if key not in made:
                made[key] = write(sh)
            block = made[key]
            shards.append(sh if block is None else Shard(sh.rank, sh.device, sh.index, block))
        return ShardedTensor(self.shape, self.dtype, self.sharding, shards)

    def __repr__(self) -> str:
        return (
            f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
            f"spec={self.sharding.spec}, ranks={len(self.addressable_shards)})"
        )


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    from ..core.convert import tensor_from_numpy

    return tensor_from_numpy(np.asarray(value))


def device_put(value: Any, sharding: NamedSharding) -> ShardedTensor:
    """Place ``value`` — a tensor on any device, a numpy array, or a
    :class:`ShardedTensor` — onto ``sharding``.  Each rank's block is an
    independent copy; ranks of one device with the same index share it.  A
    sharded input is resharded block by block: every target block is filled
    from the source blocks that overlap it, with no gathered copy."""
    if isinstance(value, ShardedTensor):
        return _reshard(value, sharding)
    t = _as_tensor(value)
    imap = sharding.addressable_devices_indices_map(t.shape)
    made: Dict[Tuple, torch.Tensor] = {}
    shards = []
    for rank, index in imap.items():
        dev = sharding.mesh.device_of(rank)
        key = (_index_key(index), dev)
        if key not in made:
            made[key] = t[index].to(dev).clone(memory_format=torch.contiguous_format)
        shards.append(Shard(rank, dev, index, made[key]))
    return ShardedTensor(t.shape, t.dtype, sharding, shards)


def _reshard(src: ShardedTensor, sharding: NamedSharding) -> ShardedTensor:
    imap = sharding.addressable_devices_indices_map(src.shape)
    sources = src.unique_shards()
    made: Dict[Tuple, torch.Tensor] = {}
    shards = []
    for rank, index in imap.items():
        dev = sharding.mesh.device_of(rank)
        key = (_index_key(index), dev)
        if key not in made:
            block = torch.empty(
                tuple(s.stop - s.start for s in index), dtype=src.dtype, device=dev
            )
            for sh in sources:
                lo = [max(a.start, b.start) for a, b in zip(index, sh.index)]
                hi = [min(a.stop, b.stop) for a, b in zip(index, sh.index)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                dst = tuple(slice(l - a.start, h - a.start) for l, h, a in zip(lo, hi, index))
                part = tuple(slice(l - b.start, h - b.start) for l, h, b in zip(lo, hi, sh.index))
                block[dst] = sh.data[part].to(dev)
            made[key] = block
        shards.append(Shard(rank, dev, index, made[key]))
    return ShardedTensor(src.shape, src.dtype, sharding, shards)


def from_blocks(
    shape: Sequence[int], sharding: NamedSharding, blocks: Iterable[torch.Tensor]
) -> ShardedTensor:
    """A :class:`ShardedTensor` from one block per rank, in rank order (the
    role of ``jax.make_array_from_single_device_arrays``).  Each block must
    lie on its rank's device with its rank's block shape."""
    shape = tuple(int(s) for s in shape)
    imap = sharding.addressable_devices_indices_map(shape)
    blocks = list(blocks)
    if len(blocks) != len(imap):
        raise ValueError(f"{len(blocks)} blocks for {len(imap)} ranks")
    shards = []
    dtype = None
    for (rank, index), block in zip(imap.items(), blocks):
        dev = sharding.mesh.device_of(rank)
        want = tuple(s.stop - s.start for s in index)
        if tuple(block.shape) != want or block.device != dev:
            raise ValueError(
                f"rank {rank}: block {tuple(block.shape)} on {block.device}, "
                f"expected {want} on {dev}"
            )
        if dtype is not None and block.dtype != dtype:
            raise ValueError("blocks of different dtypes")
        dtype = block.dtype
        shards.append(Shard(rank, dev, index, block.contiguous()))
    return ShardedTensor(shape, dtype, sharding, shards)
