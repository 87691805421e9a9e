"""Shard-native dump plans: gather-free O(delta) checkpoints under a mesh.

The dump pipeline's flat chunk grids are ``(n_chunks, chunk_bytes)`` views
over the *global* tensor; for a tensor laid out over a mesh, building that
grid is a full gather before the diff even runs.  This module replaces the
flat layout with a **canonical tile plan**, as the JAX package does:

* :class:`TilePlan` tiles a tensor into N-d blocks; one tile = one store
  chunk, with a *global* chunk id = the row-major index of its tile
  coordinate.  The plan is a pure function of ``(shape, dtype,
  chunk_bytes)`` — it never looks at a mesh — so chunk ids and digests are
  bit-identical on one rank or sixty-four, stay stable across re-layouts,
  and equal the JAX package's.
* :class:`ShardedView` carries one :class:`ShardPart` per distinct block:
  the part's local tile grid is built from its own block (reshape +
  permute + a uint8 view), and its ``tile_ids`` map local grid rows to
  global chunk ids.  A layout whose blocks are not tile-aligned degrades to
  a single part over the whole tensor, whose grid build is a gather,
  counted in :data:`FETCH` — never silent.
* :class:`ShardedTensorState` is the device-side ``ForkableState`` /
  ``DeltaEncodable`` over a dict of (sharded) tensors, the counterpart of
  the JAX package's ``ShardedArrayState``.

Restore is symmetric: :func:`grid_to_array` inverts the tile layout on the
host, and :meth:`ShardedTensorState.restore_from_payload` places blocks on
a *target* sharding — a checkpoint taken under one layout restores under
another.

Ranks are the unit of accounting: several ranks of a logical mesh may
share one card, so :class:`FetchStats` keys its bytes by rank, and a part
names both its rank and its device.  torch has no transfer guard; the
gather-free evidence is the ledger itself (``gather_bytes == 0``, and the
per-rank bytes summing to the pipeline's device→host bytes).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.convert import as_words
from ..core.delta_pipeline import DeltaGeneration
from ..core.deltacr import as_device_tensor, resolve_device
from ..core.deltafs import array_from_bytes, dtype_itemsize, dtype_str, torch_dtype
from ..kernels import ops as kops
from .placement import NamedSharding, Shard, ShardedTensor, device_put, from_blocks

__all__ = [
    "FETCH",
    "FetchStats",
    "ShardPart",
    "ShardedTensorState",
    "ShardedView",
    "TilePlan",
    "array_to_grid",
    "assemble_from_parts",
    "device_grid_to_block",
    "fetch_stats",
    "grid_to_array",
    "is_partitioned",
    "reset_fetch_stats",
    "sharded_view",
    "view_from_part_grids",
]

#: Per-dim tile-count cap (the JAX package's): 32 tiles per dim and the
#: pow2-divisor rule keep plans nesting into every production mesh axis
#: (≤16-way) while bounding n_tiles for high-rank tensors.
MAX_TILES_PER_DIM = 32


# --------------------------------------------------------------------------
# fetch accounting (the gather-free evidence ledger)
# --------------------------------------------------------------------------
class FetchStats:
    """Byte ledger for the sharded dump path (process-global, thread-safe).

    ``fetched_bytes`` counts explicit per-part device→host fetches, control
    words (compaction indices, counts, checksum lanes) included;
    ``row_bytes`` counts the tile rows among them.  ``by_rank`` and
    ``rows_by_rank`` split both per source rank.  ``gather_bytes`` counts
    full-tensor materializations of partitioned tensors — what the sharded
    path exists to eliminate; a fallback that still gathers lands here."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.fetched_bytes = 0
        self.row_bytes = 0
        self.gather_bytes = 0
        self.gathers = 0
        self.by_rank: Dict[Any, int] = {}
        self.rows_by_rank: Dict[Any, int] = {}

    def note_fetch(self, rank: Any, nbytes: int, *, rows: int = 0) -> None:
        with self._lock:
            self.fetched_bytes += int(nbytes)
            self.row_bytes += int(rows)
            self.by_rank[rank] = self.by_rank.get(rank, 0) + int(nbytes)
            self.rows_by_rank[rank] = self.rows_by_rank.get(rank, 0) + int(rows)

    def note_gather(self, nbytes: int) -> None:
        with self._lock:
            self.gather_bytes += int(nbytes)
            self.gathers += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "fetched_bytes": self.fetched_bytes,
                "row_bytes": self.row_bytes,
                "gather_bytes": self.gather_bytes,
                "gathers": self.gathers,
                "by_rank": dict(self.by_rank),
                "rows_by_rank": dict(self.rows_by_rank),
            }

    def reset(self) -> None:
        with self._lock:
            self.fetched_bytes = 0
            self.row_bytes = 0
            self.gather_bytes = 0
            self.gathers = 0
            self.by_rank.clear()
            self.rows_by_rank.clear()


FETCH = FetchStats()


def fetch_stats() -> Dict[str, Any]:
    return FETCH.snapshot()


def reset_fetch_stats() -> None:
    FETCH.reset()


# --------------------------------------------------------------------------
# canonical tile plan
# --------------------------------------------------------------------------
def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return dtype_str(dtype)
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


@dataclass(frozen=True)
class TilePlan:
    """Mesh-independent tiling of one tensor into chunk-sized N-d tiles.

    ``grid[d]`` tiles along dim ``d`` (a power of two capped at
    :data:`MAX_TILES_PER_DIM`, always dividing ``shape[d]``); the tile shape
    is ``shape[d] // grid[d]`` per dim.  Chunk id of a tile = row-major
    linear index of its tile coordinate — a *global* coordinate, identical
    on every layout.  Construction: start from the largest allowed per-dim
    tile counts, then halve the dim with the most tiles (ties → lowest
    index) until one tile holds at least ``chunk_bytes``.  The dtype is
    kept by name ("bfloat16" included, which numpy cannot hold)."""

    shape: Tuple[int, ...]
    dtype: str
    grid: Tuple[int, ...]

    @property
    def tile(self) -> Tuple[int, ...]:
        return tuple(s // g for s, g in zip(self.shape, self.grid))

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.grid, dtype=np.int64))

    @property
    def itemsize(self) -> int:
        return dtype_itemsize(self.dtype)

    @property
    def tile_bytes(self) -> int:
        return int(np.prod(self.tile, dtype=np.int64)) * self.itemsize

    @property
    def nbytes(self) -> int:
        return self.tile_bytes * self.n_tiles

    @staticmethod
    def for_array(shape: Tuple[int, ...], dtype: Any, chunk_bytes: int) -> "TilePlan":
        shape = tuple(int(s) for s in shape)
        assert shape and all(s > 0 for s in shape), "tile plans need rank>=1, non-empty"
        dt = _dtype_name(dtype)
        itemsize = dtype_itemsize(dt)
        grid = [min(s & -s, MAX_TILES_PER_DIM) for s in shape]  # pow2 divisor cap

        def tile_bytes() -> int:
            return int(np.prod([s // g for s, g in zip(shape, grid)], dtype=np.int64)) * itemsize

        while tile_bytes() < chunk_bytes and any(g > 1 for g in grid):
            d = int(np.argmax(grid))             # most tiles; ties → lowest dim
            grid[d] //= 2
        return TilePlan(shape=shape, dtype=dt, grid=tuple(grid))

    @staticmethod
    def from_meta(meta: Any) -> "TilePlan":
        """The plan a persisted ``TensorMeta`` was dumped with."""
        return TilePlan(shape=tuple(meta.shape), dtype=meta.dtype, grid=tuple(meta.tile_grid))


def _interleave(counts: Tuple[int, ...], tile: Tuple[int, ...]) -> Tuple[List[int], List[int]]:
    """(reshape dims, permutation) taking a block to (c0..ck, t0..tk)."""
    dims: List[int] = []
    for c, t in zip(counts, tile):
        dims.extend((c, t))
    nd = len(counts)
    perm = [2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
    return dims, perm


def _inverse_perm(nd: int) -> List[int]:
    perm = [0] * (2 * nd)
    for i in range(nd):
        perm[2 * i] = i
        perm[2 * i + 1] = nd + i
    return perm


def _host_words(arr: Any) -> np.ndarray:
    """A host array or tensor as unsigned words of its item size (a view
    when already on the host): tiling moves whole elements, so the words
    stand for any dtype, bfloat16 included."""
    if isinstance(arr, torch.Tensor):
        arr = as_words(arr.detach().contiguous()).cpu().numpy()
    a = np.ascontiguousarray(arr)
    return a.reshape(-1).view(np.dtype(f"<u{a.dtype.itemsize}"))


def array_to_grid(arr: Any, plan: TilePlan) -> np.ndarray:
    """Host tile grid: ``(n_tiles, tile_bytes)`` uint8, rows in global-id
    order.  ``arr`` is a numpy array or a tensor of the plan's item size."""
    words = _host_words(arr)
    if words.dtype.itemsize != plan.itemsize:
        raise ValueError(f"array of {words.dtype.itemsize}-byte items for a {plan.dtype} plan")
    dims, perm = _interleave(plan.grid, plan.tile)
    tiles = np.ascontiguousarray(words.reshape(plan.shape).reshape(dims).transpose(perm))
    return tiles.reshape(plan.n_tiles, -1).view(np.uint8)


def grid_to_array(grid: np.ndarray, plan: TilePlan) -> Any:
    """Inverse of :func:`array_to_grid` (host): a numpy array of the plan's
    dtype, or a CPU tensor for a dtype numpy cannot hold (bfloat16)."""
    words = np.ascontiguousarray(grid).view(np.dtype(f"<u{plan.itemsize}"))
    vals = words.reshape(tuple(plan.grid) + tuple(plan.tile))
    flat = np.ascontiguousarray(vals.transpose(_inverse_perm(len(plan.shape))))
    return array_from_bytes(flat.reshape(-1).view(np.uint8), plan.shape, plan.dtype)


def device_tile_grid(block: torch.Tensor, counts: Tuple[int, ...], tile: Tuple[int, ...]) -> torch.Tensor:
    """A block's local tile grid, ``(n_local, tile_bytes)`` uint8, built on
    the block's own device (reshape + permute + a uint8 view): row ``j`` is
    the row-major bytes of local tile ``j``."""
    dims, perm = _interleave(counts, tile)
    n_local = int(np.prod(counts, dtype=np.int64))
    flat = block.reshape(dims).permute(perm).reshape(n_local, -1).contiguous()
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def device_grid_to_block(
    grid: torch.Tensor, counts: Tuple[int, ...], tile: Tuple[int, ...], dtype: str
) -> torch.Tensor:
    """Inverse of :func:`device_tile_grid` on the grid's device (the
    restore scatter)."""
    n_local = int(np.prod(counts, dtype=np.int64))
    x = grid.reshape(n_local, -1)
    dt = torch_dtype(dtype)
    if dt != torch.uint8:
        x = x.view(dt)
    block_shape = tuple(c * t for c, t in zip(counts, tile))
    out = x.reshape(tuple(counts) + tuple(tile)).permute(_inverse_perm(len(counts)))
    return out.reshape(block_shape).contiguous()


# --------------------------------------------------------------------------
# sharded views
# --------------------------------------------------------------------------
@dataclass
class ShardPart:
    """One distinct block's slice of a tile plan.

    ``tile_ids[j]`` is the *global* chunk id of local grid row ``j``;
    ``grid_fn`` builds the local ``(n_local, tile_bytes)`` uint8 grid on the
    part's device.  Parts of a live tensor rebuild lazily and drop their
    cached grid after the dump (``owns_grid=False``); decode products own a
    concrete grid and keep it (they *are* the base).  ``block_fn`` returns
    the native block when the part wraps a live tensor's shard, so the dump
    can diff block-native (``ops.shard_block_encode``)."""

    rank: Optional[int]
    device: Optional[torch.device]
    offsets: Tuple[int, ...]          # tile-coordinate offset of this block
    counts: Tuple[int, ...]           # tiles per dim in this block
    tile_ids: np.ndarray = field(repr=False)
    grid_fn: Callable[[], Any] = field(repr=False)
    owns_grid: bool = False
    _grid: Any = field(default=None, repr=False)
    block_fn: Optional[Callable[[], Any]] = field(default=None, repr=False)

    @property
    def n_local(self) -> int:
        return int(self.tile_ids.shape[0])

    @property
    def grid(self) -> Any:
        if self._grid is None:
            self._grid = self.grid_fn()
        return self._grid

    def drop_cached_grid(self) -> None:
        if not self.owns_grid:
            self._grid = None


@dataclass
class ShardedView:
    """A tensor as per-part tile grids with global chunk ids.

    The sibling of :class:`~repro_torch.core.delta_pipeline.ChunkedView`
    for the pipeline's planning layer: the same identifying fields (shape,
    dtype, nbytes, chunk_bytes, n_chunks, trailing_pad), plus the plan and
    the parts the pipeline fans per-part tasks out of."""

    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    chunk_bytes: int                  # == plan.tile_bytes
    n_chunks: int                     # == plan.n_tiles
    plan: TilePlan
    parts: List[ShardPart]
    sharding: Any = None              # source sharding (restore layout)
    trailing_pad: int = 0             # tiles cover exactly: always 0

    def drop_cached_device_grid(self) -> None:
        for part in self.parts:
            part.drop_cached_grid()

    def part_map(self) -> Dict[bytes, ShardPart]:
        """Parts keyed by their tile-id signature (base alignment lookup)."""
        return {p.tile_ids.tobytes(): p for p in self.parts}

    def row_bytes(self, idx: int) -> Optional[bytes]:
        """One global chunk's bytes, fetched from the single part that owns
        it (the verified-read repair path; never a gather)."""
        for part in self.parts:
            pos = np.flatnonzero(part.tile_ids == idx)
            if pos.size:
                j = int(pos[0])
                grid = part.grid
                if isinstance(grid, np.ndarray):
                    return np.ascontiguousarray(grid[j]).tobytes()
                (row,) = kops.start_host_fetch(grid[j : j + 1]).wait()
                FETCH.note_fetch(part.rank, row.nbytes, rows=row.nbytes)
                return row.tobytes()
        return None


def _unique_shards(arr: Any) -> Optional[List[Shard]]:
    """Distinct blocks of ``arr`` (replicas fold to the lowest rank); a
    plain tensor is one block of rank 0; None for host arrays."""
    if isinstance(arr, ShardedTensor):
        return arr.unique_shards()
    if isinstance(arr, torch.Tensor):
        return [Shard(0, arr.device, tuple(slice(0, d) for d in arr.shape), arr)]
    return None


def is_partitioned(arr: Any) -> bool:
    """True when a full host read of ``arr`` must combine more than one
    block.  A replicated tensor is not partitioned: one replica holds every
    byte, so fetching it is not a gather."""
    shards = _unique_shards(arr)
    return shards is not None and len(shards) > 1


def sharded_view(arr: Any, plan: TilePlan) -> ShardedView:
    """The per-part view of ``arr`` under ``plan``.

    Every distinct block whose bounds are tile-aligned becomes a
    :class:`ShardPart`; a layout that does not nest into the plan (or a
    host array) degrades to a single part over the whole tensor — on a
    partitioned tensor that part's grid build is a gather, counted in
    :data:`FETCH`."""
    parts = _plan_parts(arr, plan)
    if parts is None:
        parts = [_whole_array_part(arr, plan)]
    return ShardedView(
        shape=plan.shape,
        dtype=plan.dtype,
        nbytes=plan.nbytes,
        chunk_bytes=plan.tile_bytes,
        n_chunks=plan.n_tiles,
        plan=plan,
        parts=parts,
        sharding=getattr(arr, "sharding", None),
    )


def _plan_parts(arr: Any, plan: TilePlan) -> Optional[List[ShardPart]]:
    shards = _unique_shards(arr)
    if not shards:
        return None
    tile = plan.tile
    covered = np.zeros(plan.n_tiles, bool)
    parts: List[ShardPart] = []
    for sh in shards:
        offs: List[int] = []
        cnts: List[int] = []
        for sl, t in zip(sh.index, tile):
            if sl.start % t or sl.stop % t:
                return None               # block not tile-aligned: gather fallback
            offs.append(sl.start // t)
            cnts.append((sl.stop - sl.start) // t)
        ids = _block_tile_ids(tuple(offs), tuple(cnts), plan.grid)
        if covered[ids].any():
            return None                   # overlapping blocks: gather fallback
        covered[ids] = True
        parts.append(_shard_part(sh, tuple(offs), tuple(cnts), ids, tile))
    if not covered.all():
        return None                       # holes: gather fallback
    return parts


def _block_tile_ids(
    offsets: Tuple[int, ...], counts: Tuple[int, ...], grid: Tuple[int, ...]
) -> np.ndarray:
    """Global chunk ids of a tile block, in local row-major order."""
    axes = [np.arange(o, o + c, dtype=np.int64) for o, c in zip(offsets, counts)]
    coords = np.meshgrid(*axes, indexing="ij")
    return np.ravel_multi_index([c.reshape(-1) for c in coords], grid).astype(np.int64)


def _shard_part(
    sh: Shard, offsets: Tuple[int, ...], counts: Tuple[int, ...], ids: np.ndarray,
    tile: Tuple[int, ...],
) -> ShardPart:
    data = sh.data
    return ShardPart(
        rank=sh.rank,
        device=sh.device,
        offsets=offsets,
        counts=counts,
        tile_ids=ids,
        grid_fn=lambda d=data, c=counts, t=tile: device_tile_grid(d, c, t),
        block_fn=lambda d=data: d,
    )


def _whole_array_part(arr: Any, plan: TilePlan) -> ShardPart:
    def build(a=arr, p=plan):
        host = kops.shard_fetch_assemble(a)
        if is_partitioned(a):
            FETCH.note_gather(plan.nbytes)
        return array_to_grid(host, p)

    return ShardPart(
        rank=None,
        device=None,
        offsets=tuple(0 for _ in plan.grid),
        counts=tuple(plan.grid),
        tile_ids=np.arange(plan.n_tiles, dtype=np.int64),
        grid_fn=build,
    )


def view_from_part_grids(
    plan: TilePlan, parts: List[Tuple[ShardPart, Any]], sharding: Any
) -> ShardedView:
    """A ShardedView over *owned* concrete per-part grids (a decode
    product: the rebuilt generation registers these as the next base)."""
    new_parts = [
        ShardPart(
            rank=part.rank,
            device=part.device,
            offsets=part.offsets,
            counts=part.counts,
            tile_ids=part.tile_ids,
            grid_fn=(lambda g=grid: g),
            owns_grid=True,
            _grid=grid,
        )
        for part, grid in parts
    ]
    return ShardedView(
        shape=plan.shape,
        dtype=plan.dtype,
        nbytes=plan.nbytes,
        chunk_bytes=plan.tile_bytes,
        n_chunks=plan.n_tiles,
        plan=plan,
        parts=new_parts,
        sharding=sharding,
    )


def assemble_from_parts(view: ShardedView, blocks: List[torch.Tensor]) -> ShardedTensor:
    """A global :class:`ShardedTensor` from one block per rank of the
    view's sharding (the restore scatter)."""
    return from_blocks(view.shape, view.sharding, blocks)


# --------------------------------------------------------------------------
# ShardedTensorState — the device-side CowTensorState analogue
# --------------------------------------------------------------------------
class ShardedTensorState:
    """ForkableState + DeltaEncodable over a dict of (sharded) tensors.

    Values are :class:`ShardedTensor`s or plain tensors, and are never
    written in place: ``set`` rebinds a key (build the new value with
    ``ShardedTensor.with_box``/``with_flat`` or :func:`device_put`) and
    feeds the dirty-key hint.  So fork is aliasing — a fork, a template or
    a dump anchor keeps the blocks it saw — and ``warm`` has nothing to do.
    ``delta_generation`` exposes every multi-chunk tensor as a
    :class:`ShardedView` under its canonical :class:`TilePlan`, so dumps
    diff and drain per part with zero gathers; sub-chunk tensors go to the
    host digest path (a partitioned one is a gather, and counted)."""

    def __init__(self, arrays: Optional[Dict[str, Any]] = None):
        for key, val in (arrays or {}).items():
            if not isinstance(val, (ShardedTensor, torch.Tensor)):
                raise TypeError(f"{key!r}: a ShardedTensor or a tensor, not {type(val).__name__}")
        self._arrays: Dict[str, Any] = dict(arrays or {})
        self._released = False
        self._dirty: Optional[Set[str]] = None
        self._dirty_base: Optional[int] = None

    # -- reads / writes ---------------------------------------------------
    def get(self, key: str) -> Any:
        return self._arrays[key]

    def keys(self):
        return self._arrays.keys()

    def set(self, key: str, value: Any) -> None:
        if not isinstance(value, (ShardedTensor, torch.Tensor)):
            raise TypeError(f"{key!r}: a ShardedTensor or a tensor, not {type(value).__name__}")
        if self._dirty is not None:
            self._dirty.add(key)
        self._arrays[key] = value

    # -- dirty tracking ---------------------------------------------------
    def reset_dirty_tracking(self, base_ckpt: Optional[int] = None) -> None:
        self._dirty = set()
        self._dirty_base = base_ckpt

    def invalidate_dirty_tracking(self) -> None:
        self._dirty = None
        self._dirty_base = None

    def dirty_tracking_base(self) -> Optional[int]:
        return self._dirty_base if self._dirty is not None else None

    # -- ForkableState ----------------------------------------------------
    def fork(self) -> "ShardedTensorState":
        clone = ShardedTensorState(self._arrays)
        clone._dirty = None if self._dirty is None else set(self._dirty)
        clone._dirty_base = self._dirty_base
        return clone

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._arrays = {}

    def warm(self) -> None:
        pass                              # values are never written in place

    def dump_payload(self) -> Dict[str, Any]:
        """Full host payload (the digest/legacy path — a gather for a
        partitioned tensor, and the ledger says so)."""
        out: Dict[str, Any] = {}
        for key, arr in self._arrays.items():
            host = kops.shard_fetch_assemble(arr)
            if is_partitioned(arr):
                FETCH.note_gather(int(arr.nbytes))
            out[key] = host
        return out

    # -- DeltaEncodable ---------------------------------------------------
    def delta_generation(self, chunk_bytes: int) -> DeltaGeneration:
        views: Dict[str, Any] = {}
        extras: Dict[str, Any] = {}
        for key, arr in self._arrays.items():
            nbytes = int(arr.nbytes)
            if nbytes >= chunk_bytes and arr.ndim >= 1 and nbytes > 0:
                plan = TilePlan.for_array(tuple(arr.shape), arr.dtype, chunk_bytes)
                views[key] = sharded_view(arr, plan)
            else:
                # sub-chunk tensors take the host digest path; a partitioned
                # one still needs its blocks combined — count that honestly
                host = kops.shard_fetch_assemble(arr)
                if is_partitioned(arr):
                    FETCH.note_gather(nbytes)
                extras[key] = host
        dirty = None if self._dirty is None else frozenset(self._dirty)
        return DeltaGeneration(views=views, extras=extras, dirty_keys=dirty)

    # -- restore ----------------------------------------------------------
    @staticmethod
    def restore_from_payload(
        payload: Dict[str, Any],
        shardings: Optional[Dict[str, NamedSharding]] = None,
        *,
        device: Any = None,
    ) -> "ShardedTensorState":
        """Rebuild the state from a decoded payload.

        ``shardings`` maps key → target :class:`NamedSharding` (the
        *restore-time* layout, possibly another than the dump's): values go
        there block by block.  Without a target, a decoded
        :class:`ShardedTensor` is adopted as it is and any other value is
        placed on ``device`` (the card unless the caller asks for the CPU;
        without a card it raises)."""
        arrays: Dict[str, Any] = {}
        dev = None
        for key, val in payload.items():
            target = shardings.get(key) if shardings else None
            if target is not None:
                arrays[key] = device_put(val, target)
            elif isinstance(val, ShardedTensor):
                arrays[key] = val
            else:
                if dev is None:
                    dev = resolve_device(device)
                arrays[key] = as_device_tensor(val, dev)
        return ShardedTensorState(arrays)
