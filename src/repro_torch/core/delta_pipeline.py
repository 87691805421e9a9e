"""Device-to-store delta dump pipeline — the O(delta) checkpoint hot path.

The paper's Key Insight is that a sandbox should "duplicate only the changes
between consecutive checkpoints".  This module is where that happens for the
DeltaCR dump path:

* :class:`DeltaEncodable` extends the ``ForkableState`` protocol with
  :meth:`delta_generation`: a per-checkpoint *chunked view* of the state —
  fixed-size byte-chunk grids per tensor (zero-copy on host, bitcast on
  device) plus a dirty-key hint (keys written since the last checkpoint).
* :class:`DeltaDumpPipeline` diffs each generation against the previous one
  with the delta kernels (``kernels.fused_encode``: dirty-chunk bitmap,
  fixed-capacity compaction and checksum lanes in one pass; or
  ``kernels.delta_encode`` past the fused budget) and moves **only the compacted dirty chunks**
  device→host.  Unchanged chunks are re-referenced from the parent image at
  the metadata level; keys the dirty hint clears are re-referenced without
  materializing a single byte.
* Slow-path restore runs in reverse: reconstruct from the nearest
  *materialized* base generation plus a ``kernels.delta_apply`` scatter of
  the image's dirty chunks fetched from the store — instead of concatenating
  and copying every chunk of every tensor.

Cost model per checkpoint (S = state bytes, Δ = changed bytes):

=====================  =============  ==========================
stage                  legacy          pipeline
=====================  =============  ==========================
serialize              O(S) host copy  0 (views are zero-copy)
parent compare         O(S) bytes ==   O(S) on-device diff (no PCIe)
device→host            O(S)            O(Δ) compacted chunks
hash + store           O(S)            O(Δ), hashed exactly once
=====================  =============  ==========================

Generations are retained in a small LRU (each anchored by the dump's own
fork, so CoW keeps the viewed pages immutable).  A dump whose checkpoint
found the parent's template live also carries a fork of it, which serves
as its base whether or not the cache kept the parent's generation; only a
dump with neither falls back to the digest path, which is still O(S)
hashing but O(Δ) store writes.

Grids are numpy arrays (host state: an exact numpy compare and scatter)
or torch tensors (device state: the CUDA kernels on the card, their plain
versions for a tensor on the CPU).  A ``dist.shard_dump.ShardedView``
(a tensor over a mesh, tiled by its canonical ``TilePlan``) fans out into
one task per part, each diffed and drained from its own block, and its
images are *tiled*: ``TensorMeta.tile_grid`` names the plan, and decode
rebuilds them per part (``delta_apply`` on each part's grid) or, without a
sharded base, through the tile layout of a rebuilt grid (on its device) or
of the store's chunks (on the host).
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    List,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

import numpy as np
import torch

from .. import trace
from . import faults
from ..kernels import ops as kops
from .chunk_store import ChunkStore, chunk_digest
from .deltafs import (  # noqa: F401 (re-export)
    TensorMeta,
    array_from_bytes,
    digest_encode_array,
    dtype_str,
    host_bytes,
    read_meta_array,
    torch_dtype,
)
from .faults import FaultError
from .stream import ChunkStreamEngine, StreamCancelled, WindowItem


def _host_dirty_rows(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Row indices where two (N, C) uint8 grids differ.

    Compares at the widest word dividing the row — an 8× smaller boolean
    intermediate than a per-byte compare."""
    n, c = old.shape
    for w in (np.uint64, np.uint32, np.uint16):
        if c % np.dtype(w).itemsize == 0:
            old = old.view(w)
            new = new.view(w)
            break
    return np.flatnonzero((old != new).any(axis=1)).astype(np.int64)


def _as_grid(grid: Any, device: torch.device) -> torch.Tensor:
    """A grid as a uint8 tensor on ``device`` (a host grid is uploaded)."""
    if isinstance(grid, torch.Tensor):
        return grid.to(device)
    return torch.from_numpy(np.ascontiguousarray(grid)).to(device)


def _grid_device(*grids: Any) -> torch.device:
    for g in grids:
        if isinstance(g, torch.Tensor):
            return g.device
    return torch.device("cpu")


def _upload_grid(grid: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host→device copy of a rebuilt generation grid."""
    return torch.from_numpy(grid).to(device)


def _part_rows(grid: Any, part: Any) -> Any:
    """A shard part's rows of a whole tile-layout grid (numpy or a tensor)."""
    if isinstance(grid, np.ndarray):
        return grid[part.tile_ids]
    return grid.index_select(0, torch.as_tensor(part.tile_ids, device=grid.device))


__all__ = [
    "ChunkedView",
    "DeltaDumpPipeline",
    "DeltaEncodable",
    "DeltaGeneration",
    "StreamCancelled",
    "digest_encode_array",
    "mark_clean",
    "mark_unknown",
]


# --------------------------------------------------------------------------
# Chunked views + generation protocol
# --------------------------------------------------------------------------
@dataclass
class ChunkedView:
    """A tensor as an ``(n_chunks, chunk_bytes)`` uint8 grid, built lazily.

    ``grid_fn`` materializes the grid (numpy for host state, a uint8 torch
    tensor for device state); it is only invoked when the key is actually dirty, so a
    clean tensor costs nothing.  The final row is zero-padded by
    ``trailing_pad`` bytes, matching the store's chunk convention — host and
    device chunks therefore hash identically and dedupe against each other.
    """

    shape: Tuple[int, ...]
    dtype: str                       # logical tensor dtype (e.g. "float32")
    nbytes: int
    chunk_bytes: int                 # bytes per grid row
    n_chunks: int
    trailing_pad: int
    grid_fn: Callable[[], Any] = field(repr=False)
    _grid: Any = field(default=None, repr=False)
    # Non-empty when grid rows are the tiles of a shard-native TilePlan
    # (dist.shard_dump) instead of a flat row-major byte split.  Kernel
    # diff/apply bases only pair with views of the *same* layout; metadata
    # digest compares are layout-independent and need no guard.
    tile_grid: Tuple[int, ...] = ()

    @property
    def grid(self) -> Any:
        if self._grid is None:
            self._grid = self.grid_fn()
        return self._grid

    def drop_cached_device_grid(self) -> None:
        """Free a cached tensor grid (rebuilt on next use; the anchor fork
        keeps the source tensor alive).  Host grids are zero-copy views and
        stay cached."""
        if self._grid is not None and not isinstance(self._grid, np.ndarray):
            self._grid = None

    @staticmethod
    def from_host_array(arr: np.ndarray, chunk_bytes: int) -> "ChunkedView":
        """Zero-copy byte-grid over a contiguous host array (copy only for a
        padded tail row).  Requires ``arr.nbytes > 0``."""
        arr = np.ascontiguousarray(arr)
        nbytes = int(arr.nbytes)
        assert nbytes > 0, "empty tensors go through the digest path"
        n_chunks = -(-nbytes // chunk_bytes)
        pad = n_chunks * chunk_bytes - nbytes

        def build() -> np.ndarray:
            flat = arr.reshape(-1).view(np.uint8)
            if pad == 0:
                return flat.reshape(n_chunks, chunk_bytes)
            grid = np.zeros((n_chunks, chunk_bytes), np.uint8)
            grid.reshape(-1)[:nbytes] = flat
            return grid

        return ChunkedView(
            shape=tuple(arr.shape),
            dtype=dtype_str(arr.dtype),
            nbytes=nbytes,
            chunk_bytes=chunk_bytes,
            n_chunks=n_chunks,
            trailing_pad=pad,
            grid_fn=build,
        )


@dataclass
class DeltaGeneration:
    """One checkpoint's chunked snapshot, as produced by a DeltaEncodable.

    ``views`` are the kernel-diffable tensors; ``extras`` are small or
    irregular tensors that go through the per-chunk digest path.
    ``dirty_keys`` is the superset of keys that may differ from the parent
    generation (None = unknown → everything is treated as dirty).
    ``state_keys`` names the extras that hold a recurrent sublayer's state
    (traced as ``dump.state``).
    """

    views: Dict[str, ChunkedView] = field(default_factory=dict)
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    dirty_keys: Optional[FrozenSet[str]] = None
    state_keys: FrozenSet[str] = frozenset()

    def is_dirty(self, key: str) -> bool:
        return self.dirty_keys is None or key in self.dirty_keys


@runtime_checkable
class DeltaEncodable(Protocol):
    """ForkableState that can expose per-generation chunked views."""

    def fork(self) -> "DeltaEncodable": ...
    def release(self) -> None: ...
    def warm(self) -> None: ...
    def dump_payload(self) -> Dict[str, np.ndarray]: ...
    def delta_generation(self, chunk_bytes: int) -> DeltaGeneration: ...


# -- dirty-tracking duck helpers (states opt in by implementing the methods)
def mark_clean(state: Any, base_ckpt: Optional[int] = None) -> None:
    """Reset write tracking: the state is bit-identical to checkpoint
    ``base_ckpt``, and a dump whose parent is that same checkpoint may treat
    the tracked write set as exact.  The hint is *keyed* to the base — a
    dump against any other parent must ignore it (see dirty_base)."""
    fn = getattr(state, "reset_dirty_tracking", None)
    if fn is not None:
        fn(base_ckpt)


def mark_unknown(state: Any) -> None:
    """Invalidate write tracking: the state's lineage no longer matches the
    checkpoint the next dump will delta against (e.g. a transient checkpoint
    was dropped), so every key must be treated as dirty."""
    fn = getattr(state, "invalidate_dirty_tracking", None)
    if fn is not None:
        fn()


def dirty_base(state: Any) -> Optional[int]:
    """The checkpoint id the state's write tracking is relative to, or None
    when tracking is invalid/unanchored (treat everything as dirty)."""
    fn = getattr(state, "dirty_tracking_base", None)
    return fn() if fn is not None else None


# --------------------------------------------------------------------------
# Pipeline
# --------------------------------------------------------------------------
@dataclass
class _GenRecord:
    image_id: int
    views: Dict[str, ChunkedView]
    anchor: Optional[Any]            # fork keeping the viewed memory immutable
    pins: int = 0                    # in-flight encode/decode users
    dead: bool = False               # evicted; release anchor when unpinned

    def release(self) -> None:
        if self.anchor is not None:
            try:
                self.anchor.release()
            except Exception:
                pass
            self.anchor = None


@dataclass
class EncodeResult:
    entries: Dict[str, TensorMeta]
    dirtied: int
    clean_keys: int = 0              # metadata-level reuse (no bytes touched)
    kernel_keys: int = 0             # diffed by the delta kernels
    full_keys: int = 0               # full materialization (new/overflow)
    # streaming accounting (zeros on the synchronous path)
    streamed: bool = False
    windows: int = 0
    window_bytes: int = 0            # the (possibly adaptive) budget used
    encode_ms: float = 0.0
    drain_ms: float = 0.0
    commit_ms: float = 0.0
    stream_wall_ms: float = 0.0
    shard_parts: int = 0             # per-part tasks run (sharded views only)


@dataclass
class _ShardRows:
    """One shard part's drained rows, keyed by *global* chunk id.

    Produced by the per-part tasks of a sharded view; holds raw
    ``(payload, digest)`` pairs only — store folding is deferred to
    :meth:`DeltaDumpPipeline._commit_sharded_key`, which assembles every
    part's rows in global chunk order so the resulting metadata is
    chunk-for-chunk identical to a single-rank dump.  ``chunk_ids`` stays
    empty: a part holds no store references, so the transactional rollback
    walk sees nothing to decref here."""

    plan_key: str                    # the owning tensor key (task key adds #shardK)
    rows: Dict[int, Tuple[bytes, Optional[bytes]]]
    kind: str                        # "kernel" | "full"
    chunk_ids: Tuple[int, ...] = ()


@dataclass
class _ShardedPlan:
    """Bookkeeping for one sharded view's fan-out: the per-part tasks plus
    the commit-time context (usable parent meta, whether any part diffed
    against a base)."""

    view: Any                        # dist.shard_dump.ShardedView
    pm: Optional[TensorMeta]
    tasks: List["_KeyTask"]
    used_base: bool


@dataclass
class _KeyTask:
    """One non-clean tensor's dump work as a three-stage window item.

    ``encode`` (caller thread) runs the diff — a ``kernels.delta_encode``
    dispatch for device grids, the exact numpy compare for host grids, or
    nothing for full-materialization keys.  ``drain`` (overlap pool, pure)
    fetches the dirty rows device→host and produces ``(payload, digest)``
    per row — all GIL-releasing copy/hash work, no store access.  ``commit``
    (caller thread again) folds the rows into the store and returns
    ``(meta, dirtied, kind)`` with ``kind`` in {"kernel", "full"} (a
    capacity overflow detected in drain downgrades kernel → full)."""

    key: str
    weight: int
    encode: Callable[[], Any]
    drain: Callable[[Any], Any]
    commit: Callable[[Any], Tuple[TensorMeta, int, str]]

    def run_sync(self) -> Tuple[TensorMeta, int, str]:
        return self.commit(self.drain(self.encode()))

    def as_window_item(self) -> WindowItem:
        return WindowItem(
            key=self.key,
            weight=self.weight,
            encode=self.encode,
            drain=self.drain,
            commit=self.commit,
        )


class DeltaDumpPipeline:
    """Coordinates delta_encode dumps and delta_apply restores for one store."""

    #: Budget for the fused plan's compaction buffer (max_changed ×
    #: chunk_bytes); past it the unfused plan (delta_diff + compaction)
    #: runs.  The JAX package's VMEM budget, kept so both packages choose
    #: the same plan for the same tensor.
    FUSED_VMEM_BYTES = 8 * 1024 * 1024

    def __init__(
        self,
        store: ChunkStore,
        *,
        capacity_frac: float = 0.5,
        max_generations: int = 4,
        stream: Optional[ChunkStreamEngine] = None,
        fused: bool = True,
        fused_verify: bool = True,
    ):
        self.store = store
        self.capacity_frac = float(capacity_frac)
        self.max_generations = int(max_generations)
        self.stream = stream
        self.fused = bool(fused)
        self.fused_verify = bool(fused_verify)
        self.fused_checksum_mismatches = 0    # host-verify failures (retried)
        self.d2h_bytes = 0                    # bytes fetched off the card
        self._gens: "OrderedDict[int, _GenRecord]" = OrderedDict()
        self._lock = threading.RLock()

    # ------------------------------------------------------------ gen cache
    #
    # Records are *pinned* while an encode/decode is reading their (lazy)
    # grids: eviction/replacement marks a pinned record dead and its anchor
    # is only released when the last reader unpins — otherwise a concurrent
    # restore could free the anchored pages mid-diff and corrupt the base.
    def record_for(self, image_id: Optional[int]) -> Optional[_GenRecord]:
        """Pinned lookup; pair every non-None return with release_record()."""
        if image_id is None:
            return None
        with self._lock:
            rec = self._gens.get(image_id)
            if rec is not None:
                rec.pins += 1
                self._gens.move_to_end(image_id)
            return rec

    def release_record(self, rec: Optional[_GenRecord]) -> None:
        if rec is None:
            return
        with self._lock:
            rec.pins -= 1
            releasable = rec.dead and rec.pins == 0
        if releasable:
            rec.release()

    def _retire_locked(self, rec: _GenRecord, out: list) -> None:
        rec.dead = True
        if rec.pins == 0:
            out.append(rec)

    def register(
        self, image_id: int, views: Dict[str, ChunkedView], anchor: Optional[Any]
    ) -> None:
        """Retain this image's generation as a future diff/restore base."""
        releasable: list = []
        with self._lock:
            old = self._gens.pop(image_id, None)
            if old is not None:
                self._retire_locked(old, releasable)
            self._gens[image_id] = _GenRecord(image_id=image_id, views=views, anchor=anchor)
            while len(self._gens) > self.max_generations:
                _, rec = self._gens.popitem(last=False)
                self._retire_locked(rec, releasable)
        for rec in releasable:
            rec.release()

    def anchored_ids(self) -> List[int]:
        """Image ids with a registered generation, oldest-first (LRU order).

        The persistence plane records these as the *generation-cache
        anchors*: after a restart, :meth:`rebuild_generation` re-materializes
        them from store chunks so the first post-recovery dumps are already
        O(delta)-chained instead of paying a full-path dump each."""
        with self._lock:
            return list(self._gens.keys())

    def rebuild_generation(self, image: Any, device: Any = None) -> bool:
        """Re-register an image's generation from its store chunks.

        Restart recovery: builds a byte-grid for every grid-aligned tensor
        of ``image`` and registers them as a diff/restore base (anchor-less
        — the grids own their memory).  On ``device`` (the card unless the
        caller asks for the CPU) each grid is a uint8 tensor, one
        host→device copy per tensor, so the first restore after a restart
        runs ``delta_apply`` and the first dump the delta kernels there; on
        the CPU the grids stay numpy, as host state's are.  A chunk that
        cannot be read skips its tensor; a failed upload raises.  Returns
        False when no tensor was rebuildable (nothing registered)."""
        from .deltacr import resolve_device

        dev = resolve_device(device)
        store = self.store
        views: Dict[str, ChunkedView] = {}
        for name, meta in image.entries.items():
            n = len(meta.chunk_ids)
            if n == 0:
                continue
            try:
                row_bytes = len(store.get(meta.chunk_ids[0]))
                if row_bytes == 0 or not self._rows_match(meta, row_bytes):
                    continue
                grid = np.empty((n, row_bytes), np.uint8)
                for i, cid in enumerate(meta.chunk_ids):
                    grid[i] = np.frombuffer(store.get(cid), np.uint8)
            except Exception:
                # a quarantined/corrupt chunk must not abort recovery: this
                # tensor just misses the rebuilt anchor — the first dump
                # against it pays the full path, which is correct, only slow
                continue
            # outside the except: an upload that fails must not leave a host
            # grid behind, which would send the next dump off the card
            base = grid if dev.type == "cpu" else _upload_grid(grid, dev)
            views[name] = ChunkedView(
                shape=meta.shape,
                dtype=meta.dtype,
                nbytes=meta.nbytes,
                chunk_bytes=row_bytes,
                n_chunks=n,
                trailing_pad=meta.trailing_pad,
                grid_fn=lambda g=base: g,
                tile_grid=tuple(meta.tile_grid),
            )
        if not views:
            return False
        self.register(image.image_id, views, anchor=None)
        return True

    def evict(self, image_id: int) -> None:
        releasable: list = []
        with self._lock:
            rec = self._gens.pop(image_id, None)
            if rec is not None:
                self._retire_locked(rec, releasable)
        for rec in releasable:
            rec.release()

    def clear(self) -> None:
        releasable: list = []
        with self._lock:
            for rec in self._gens.values():
                self._retire_locked(rec, releasable)
            self._gens.clear()
        for rec in releasable:
            rec.release()

    def shutdown(self) -> None:
        self.clear()
        if self.stream is not None:
            self.stream.shutdown()

    # --------------------------------------------------------------- encode
    def encode_generation(
        self,
        gen: DeltaGeneration,
        parent_image: Optional[Any],
        *,
        cancel: Optional[threading.Event] = None,
        priority: str = "bg",
        parent_state: Optional[Any] = None,
    ) -> EncodeResult:
        """Build the image entries for one generation (dump-worker thread).

        ``parent_state``, when given, is a state bit-identical to
        ``parent_image``: the fork of the parent's template that
        ``DeltaCR.checkpoint`` carries to the dump.  Its generation is
        never registered, so it takes no slot of the cache.  A flat key
        diffs against the fork's view first, then the cache's record for
        the parent image: the fork's grid is a gather on the key's own
        device, where a record rebuilt by a decode holds a host grid that
        would be uploaded whole.  A sharded key takes the cache's record
        first, whose parts were placed under the key's plan, then the
        fork's.  Without either, the key drains in full.  Every base gives
        the image the full drain gives: all are the parent image's bytes.

        When the pipeline owns a :class:`ChunkStreamEngine` and the plan is
        large enough to split into windows, the per-tensor work streams
        through it: diff dispatch of window k+1 overlaps the device→host
        copy + store put of window k.  ``cancel`` aborts at the next window
        boundary and rolls back every chunk reference this dump acquired
        (raising :class:`StreamCancelled`); ``priority`` is forwarded to the
        QoS gate ("bg" dumps yield to runnable sessions, "fg" do not).
        """
        res = EncodeResult(entries={}, dirtied=0)
        parent_entries = parent_image.entries if parent_image is not None else {}
        parent_rec = None
        carried: Dict[str, Any] = {}
        if parent_image is not None:
            trace.count("dump.with_parent")
            parent_rec = self.record_for(parent_image.image_id)
            if parent_state is not None:
                carried = parent_state.delta_generation(self.store.chunk_bytes).views
                trace.count("dump.parent_fork")
            elif parent_rec is None:    # no base at all: every dirty key drains in full
                trace.count("dump.base_miss")
        try:
            return self._encode_with_parent(
                gen, parent_entries, parent_rec, carried, res, cancel=cancel, priority=priority
            )
        finally:
            # device grids materialized for this diff are O(state) on-device
            # copies — free them; the anchors re-gather lazily next time
            for view in gen.views.values():
                view.drop_cached_device_grid()
            for view in carried.values():
                view.drop_cached_device_grid()
            if parent_rec is not None:
                for view in parent_rec.views.values():
                    view.drop_cached_device_grid()
            self.release_record(parent_rec)

    def _encode_with_parent(
        self,
        gen: DeltaGeneration,
        parent_entries: Dict[str, TensorMeta],
        parent_rec: Optional[_GenRecord],
        carried: Dict[str, Any],
        res: "EncodeResult",
        *,
        cancel: Optional[threading.Event] = None,
        priority: str = "bg",
    ) -> "EncodeResult":
        store = self.store
        tasks: List[_KeyTask] = []
        sharded: "OrderedDict[str, _ShardedPlan]" = OrderedDict()
        for key, view in gen.views.items():
            pm = parent_entries.get(key)
            # NOTE: the kernel path does not require parent digests — its
            # dirty knowledge comes from the generation grids, and decode
            # detects dirty chunks by id inequality.
            pm_ok = pm is not None and pm.dtype == view.dtype
            # --- clean key: metadata-level re-reference, zero bytes moved
            if pm_ok and pm.shape == tuple(view.shape) and not gen.is_dirty(key):
                store.incref_many(pm.chunk_ids)
                res.entries[key] = pm
                res.clean_keys += 1
                continue
            cached = parent_rec.views.get(key) if parent_rec is not None else None
            if hasattr(view, "parts"):   # dist.shard_dump.ShardedView
                base = cached if cached is not None else carried.get(key)
                splan = self._plan_sharded_key(key, view, pm if pm_ok else None, base)
                sharded[key] = splan
                tasks.extend(splan.tasks)
            else:
                base = carried.get(key, cached)
                tasks.append(self._plan_key(key, view, pm if pm_ok else None, base))

        items = [t.as_window_item() for t in tasks]
        streamed = self.stream is not None and self.stream.should_stream(items)
        shard_out: Dict[str, List[_ShardRows]] = {}
        try:
            if streamed:
                self._run_streamed(tasks, items, res, cancel, priority, shard_out)
            else:
                self._run_sync(tasks, res, cancel, shard_out)
            # assemble each sharded key's parts in global chunk order — the
            # store folds run on this (single) thread, so ids and digests
            # come out exactly as a single-rank dump would produce them
            for key, splan in sharded.items():
                self._commit_sharded_key(key, splan, shard_out.get(key, []), res)
            # extras stay inside the transaction: a failure here must also
            # roll back every reference the tasks/clean keys acquired
            for key, arr in gen.extras.items():
                pm = parent_entries.get(key)
                if (
                    pm is not None
                    and pm.shape == tuple(arr.shape)
                    and pm.dtype == dtype_str(arr.dtype)
                    and not gen.is_dirty(key)
                ):
                    store.incref_many(pm.chunk_ids)
                    res.entries[key] = pm
                    res.clean_keys += 1
                    continue
                is_state = key in gen.state_keys
                with trace.span("dump.state") if is_state else contextlib.nullcontext():
                    meta, n_dirty = digest_encode_array(store, arr, pm)
                if is_state:
                    trace.count("dump.state_bytes", int(arr.nbytes))
                res.entries[key] = meta
                res.dirtied += n_dirty
        except BaseException:
            self._rollback(res.entries)
            res.entries = {}
            raise
        return res

    # ----------------------------------------------------- encode: planning
    def _plan_key(
        self,
        key: str,
        view: ChunkedView,
        pm: Optional[TensorMeta],
        base: Optional[ChunkedView],
    ) -> _KeyTask:
        """Classify one dirty tensor into a two-stage task."""
        weight = view.n_chunks * view.chunk_bytes
        if (
            pm is not None
            and base is not None
            # kernel bases must share the flat row layout; tiled metadata or
            # a sharded/tiled base pairs only with the sharded planner
            and not pm.tile_grid
            and not getattr(base, "tile_grid", ())
            and not hasattr(base, "parts")
            and base.chunk_bytes == view.chunk_bytes
            and len(pm.chunk_ids) == base.n_chunks
        ):
            # a padded parent tail row only compares against an identical
            # layout (same row count + pad); otherwise exclude it
            if base.n_chunks == view.n_chunks and base.trailing_pad == view.trailing_pad:
                comparable = base.n_chunks
            else:
                comparable = base.n_chunks - (1 if base.trailing_pad else 0)
            K = min(view.n_chunks, comparable)
            if K > 0:
                old_grid, new_grid = base.grid, view.grid
                if isinstance(old_grid, np.ndarray) and isinstance(new_grid, np.ndarray):
                    return self._plan_host_kernel(key, view, pm, old_grid, new_grid, K, weight)
                return self._plan_device_kernel(key, view, pm, old_grid, new_grid, K, weight)
        # --- full path: materialize the grid, digest-delta every row
        return _KeyTask(
            key=key,
            weight=weight,
            encode=lambda: None,
            drain=lambda _enc, v=view: self._drain_rows(self._to_host(v.grid), range(v.n_chunks)),
            commit=lambda rows, v=view, p=pm: (*self._commit_full_grid(v, p, rows), "full"),
        )

    def _drain_rows(
        self, grid, indices, keys=None
    ) -> Dict[int, Tuple[bytes, Optional[bytes]]]:
        """Pure drain body: copy + hash the given rows of a host grid.

        One ``tobytes`` copy and (when the store dedupes) one GIL-releasing
        blake2b per row — exactly the work profile that scales across drain
        workers; no locks, no store access.  ``keys`` remaps grid rows to
        result keys (compacted kernel output, grown-tail offsets); identity
        when omitted."""
        want_digest = self.store.dedupe
        rows: Dict[int, Tuple[bytes, Optional[bytes]]] = {}
        indices = list(indices)
        keys = indices if keys is None else list(keys)
        for k, i in zip(keys, indices):
            payload = np.ascontiguousarray(grid[int(i)]).tobytes()
            rows[int(k)] = (payload, chunk_digest(payload, 0) if want_digest else None)
        return rows

    def _plan_host_kernel(
        self, key, view, pm, old_grid, new_grid, K: int, weight: int
    ) -> _KeyTask:
        # Host grids: a vectorized numpy compare IS the delta kernel here —
        # routing 2×K×C bytes through the device would cost more than the
        # diff.  The result is exact, so the fixed-capacity limit (a
        # kernel-compaction artifact) does not apply.  Encode = the compare;
        # drain = per-row copy + hash; commit = store folds.
        def encode() -> np.ndarray:
            return _host_dirty_rows(old_grid[:K], new_grid[:K])

        def drain(hit: np.ndarray) -> Dict[int, Tuple[bytes, Optional[bytes]]]:
            # rows past K (a grown tensor's tail) are new, hence all dirty
            indices = list(hit) + list(range(K, view.n_chunks))
            return self._drain_rows(new_grid, indices)

        def commit(rows) -> Tuple[TensorMeta, int, str]:
            meta, n_dirty = self._commit_kernel_meta(view, pm, K, rows)
            return meta, n_dirty, "kernel"

        return _KeyTask(key=key, weight=weight, encode=encode, drain=drain, commit=commit)

    @staticmethod
    def _padded_pair(old_grid, new_grid, K: int, K2: int, cap: int):
        """The first K rows of both grids on one device.  The capacity is
        planned on K2 rows; the grids are zero-padded to K2 only where it
        exceeds K.  Below that the identical pad rows, which can never read
        as dirty, change no output, and the pad would copy both grids
        whole: 2.5 GiB of transient device memory for one 516-page K/V
        grid of qwen3-14b."""
        dev = _grid_device(new_grid, old_grid)
        old_t = _as_grid(old_grid, dev)[:K]
        new_t = _as_grid(new_grid, dev)[:K]
        if cap > K:
            pad = (0, 0, 0, K2 - K)
            old_t = torch.nn.functional.pad(old_t, pad)
            new_t = torch.nn.functional.pad(new_t, pad)
        return old_t.contiguous(), new_t.contiguous()

    def _plan_device_kernel(
        self, key, view, pm, old_grid, new_grid, K: int, weight: int
    ) -> _KeyTask:
        # plan on the pow2 row count so the fixed capacity only takes
        # O(log N) values as a KV cache grows (the JAX package pads to keep
        # its jit cache small; the same count keeps the plans identical)
        K2 = 1 << (K - 1).bit_length()
        cap = self._capacity(K2)
        if self.fused and cap * view.chunk_bytes <= self.FUSED_VMEM_BYTES:
            return self._plan_device_fused(
                key, view, pm, old_grid, new_grid, K, K2, cap, weight
            )

        def encode():
            old_t, new_t = self._padded_pair(old_grid, new_grid, K, K2, cap)
            data, idx, count = kops.delta_encode(old_t, new_t, cap)
            # async: start the small control copies now; the rows are
            # fetched in drain as an exact [:count] slice
            return data, kops.start_host_fetch(idx, count)

        def drain(enc):
            data, control = enc
            self._note_d2h(control)
            idx_np, count_np = control.wait()
            return self._drain_compacted(view, K, cap, data, idx_np, int(count_np))

        return _KeyTask(
            key=key, weight=weight, encode=encode, drain=drain,
            commit=lambda tagged: self._commit_tagged(view, pm, K, tagged),
        )

    def _plan_device_fused(
        self, key, view, pm, old_grid, new_grid, K: int, K2: int, cap: int, weight: int
    ) -> _KeyTask:
        """Single-pass device plan: ``kernels.fused_encode`` diffs, compacts
        and checksums the dirty rows in one kernel launch, so dirty bytes
        cross the device memory hierarchy once instead of three times.

        Drain validates the fetched bytes against the device-computed
        checksum lanes (when ``fused_verify``): a mismatch raises a catchable
        :class:`FaultError` that rides the dump path's transactional
        retry/fallback plane — the attempt rolls back and the retry
        re-fetches, exactly like an injected drain fault."""

        def encode():
            old_t, new_t = self._padded_pair(old_grid, new_grid, K, K2, cap)
            data, idx, count, sums = kops.fused_encode(old_t, new_t, cap)
            # start the small control copies (idx, count, sums) now so
            # drain can classify at once; the rows follow as a [:count]
            # slice, so the bytes moved stay proportional to the delta
            return data, kops.start_host_fetch(idx, count, sums)

        def drain(enc):
            data, control = enc
            self._note_d2h(control)
            idx_np, count_np, sums_np = control.wait()
            n = int(count_np)
            if n > cap:
                return self._drain_compacted(view, K, cap, data, idx_np, n)
            data_np = self._to_host(data[:n])
            faults.fire("kernels.fused")
            if self.fused_verify and n:
                got = kops.chunk_checksums_host(data_np)
                want = sums_np[:n]
                if not np.array_equal(got, want):
                    bad = np.flatnonzero(np.any(got != want, axis=1))
                    self.fused_checksum_mismatches += len(bad)
                    raise FaultError(
                        f"fused dump checksum mismatch on {key!r}: "
                        f"{len(bad)}/{n} fetched rows fail the "
                        f"device-computed lanes (attempt rolls back)"
                    )
            return self._tag_kernel_rows(view, K, data_np, idx_np[:n])

        return _KeyTask(
            key=key, weight=weight, encode=encode, drain=drain,
            commit=lambda tagged: self._commit_tagged(view, pm, K, tagged),
        )

    def _drain_compacted(self, view, K: int, cap: int, data, idx_np, n: int):
        """Drain one compacted kernel output.  The dirty rows are front-packed
        in ascending order, so the first ``n`` rows are exactly the delta."""
        if n > cap:
            # capacity overflow: fall back to the full chunk set
            return "full", self._drain_rows(self._to_host(view.grid), range(view.n_chunks))
        return self._tag_kernel_rows(view, K, self._to_host(data[:n]), idx_np[:n])

    def _to_host(self, grid: Any) -> np.ndarray:
        """A grid (or grid slice) as a host numpy array; bytes that leave
        the card are counted in ``d2h_bytes``."""
        if isinstance(grid, torch.Tensor):
            fetch = kops.start_host_fetch(grid)
            self._note_d2h(fetch)
            return fetch.wait()[0]
        return np.asarray(grid)

    def _note_d2h(self, fetch: "kops.HostFetch") -> None:
        if fetch.from_device:
            with self._lock:
                self.d2h_bytes += fetch.nbytes

    def _tag_kernel_rows(self, view, K: int, data_np, idx_np):
        rows = self._drain_rows(data_np, range(len(idx_np)), keys=(int(i) for i in idx_np))
        if view.n_chunks > K:        # grown rows: all dirty, one fetch
            tail = self._to_host(view.grid[K:])
            rows.update(
                self._drain_rows(tail, range(tail.shape[0]), keys=range(K, K + tail.shape[0]))
            )
        return "kernel", rows

    def _commit_tagged(self, view, pm, K: int, tagged) -> Tuple[TensorMeta, int, str]:
        tag, rows = tagged
        if tag == "full":
            return (*self._commit_full_grid(view, pm, rows), "full")
        meta, n_dirty = self._commit_kernel_meta(view, pm, K, rows)
        return meta, n_dirty, "kernel"

    # ----------------------------------------------- encode: sharded views
    #
    # A dist.shard_dump.ShardedView fans out into one task per part: the
    # diff/compact runs on the part's own device against that part's slice
    # of the base, and the drain fetches exactly the compacted dirty rows
    # (front-packed, an exact [:count] slice) from that part alone — no
    # gather ever happens, and the bytes land per rank in the
    # shard_dump.FETCH ledger.  Store folding is deferred: parts return
    # _ShardRows and _commit_sharded_key assembles global chunk order.
    def _plan_sharded_key(
        self, key: str, view: Any, pm: Optional[TensorMeta], base: Optional[Any]
    ) -> _ShardedPlan:
        pm_use = (
            pm
            if (
                pm is not None
                and pm.shape == tuple(view.shape)
                and tuple(pm.tile_grid) == tuple(view.plan.grid)
                and len(pm.chunk_ids) == view.n_chunks
            )
            else None
        )
        # a usable diff base is either the parent's ShardedView under the
        # identical plan (per-part diff) or a tile-layout grid rebuilt from
        # the store (host numpy or a device tensor), whose rows each part
        # takes by its tile ids
        base_map = None
        flat_base = None
        if pm_use is not None and base is not None:
            if hasattr(base, "parts"):
                if tuple(base.plan.grid) == tuple(view.plan.grid):
                    base_map = base.part_map()
            elif (
                tuple(getattr(base, "tile_grid", ())) == tuple(view.plan.grid)
                and base.chunk_bytes == view.chunk_bytes
                and base.n_chunks == view.n_chunks
            ):
                flat_base = base.grid
        tasks: List[_KeyTask] = []
        used_base = False
        for k, part in enumerate(view.parts):
            tkey = f"{key}#shard{k}"
            weight = part.n_local * view.chunk_bytes
            bpart = base_map.get(part.tile_ids.tobytes()) if base_map is not None else None
            # keyed by rank: several ranks of a logical mesh share a card
            if bpart is not None and part.device is not None and bpart.rank == part.rank:
                used_base = True
                tasks.append(self._plan_shard_kernel(
                    tkey, key, view, part, (lambda bp=bpart: bp.grid), weight,
                    base_block_fn=bpart.block_fn,
                ))
            elif flat_base is not None and part.device is not None:
                used_base = True
                tasks.append(self._plan_shard_kernel(
                    tkey, key, view, part, (lambda g=flat_base, p=part: _part_rows(g, p)), weight,
                ))
            else:
                tasks.append(self._plan_shard_full(tkey, key, part, weight))
        return _ShardedPlan(view=view, pm=pm_use, tasks=tasks, used_base=used_base)

    def _note_part_fetch(self, part: Any, fetch: "kops.HostFetch", rows: int = 0) -> None:
        from ..dist.shard_dump import FETCH

        self._note_d2h(fetch)
        FETCH.note_fetch(part.rank, fetch.nbytes, rows=rows)

    def _part_grid_host(self, part: Any) -> np.ndarray:
        """A part's whole grid on the host (its own bytes only)."""
        g = part.grid
        if isinstance(g, np.ndarray):
            return g
        fetch = kops.start_host_fetch(g)
        self._note_part_fetch(part, fetch, rows=fetch.nbytes)
        return fetch.wait()[0]

    def _plan_shard_kernel(
        self, tkey: str, plan_key: str, view: Any, part: Any, base_fn, weight: int,
        *, base_block_fn=None,
    ) -> _KeyTask:
        K = part.n_local
        K2 = 1 << (K - 1).bit_length()
        cap = self._capacity(K2)
        use_fused = self.fused and cap * view.chunk_bytes <= self.FUSED_VMEM_BYTES
        block_path = base_block_fn is not None and part.block_fn is not None

        def encode():
            if block_path:
                # block-native path: diff the two live blocks in their
                # native layout (compare + reduce) and extract only the
                # dirty tiles — neither side pays the O(state) tile-grid
                # transpose; rows are bit-identical to the grid path's.
                # Checksum lanes are computed in drain over the fetched rows.
                data, idx, count = kops.shard_block_encode(
                    base_block_fn(), part.block_fn(), tuple(part.counts),
                    tuple(view.plan.tile), cap,
                )
                return data, None, kops.start_host_fetch(idx, count)
            old, new = self._padded_pair(base_fn(), part.grid, K, K2, cap)
            if use_fused:
                data, idx, count, sums = kops.fused_encode(old, new, cap)
            else:
                data, idx, count = kops.delta_encode(old, new, cap)
                sums = None
            # start only the control copies; the rows follow in drain as an
            # exact [:count] slice, so moved bytes stay ∝ the delta
            return data, sums, kops.start_host_fetch(idx, count)

        def drain(enc):
            data, sums, control = enc
            self._note_part_fetch(part, control)
            idx_np, count_np = control.wait()
            n = int(count_np)
            if n > cap:
                # capacity overflow: this part drains in full — still only
                # its own block's bytes, never a gather
                rows = self._drain_rows(self._part_grid_host(part), range(K), keys=part.tile_ids)
                return _ShardRows(plan_key, rows, "full")
            if n == 0:
                return _ShardRows(plan_key, {}, "kernel")
            verify = use_fused and (sums is not None or block_path)
            if verify and self.fused_verify:
                lanes = sums[:n] if sums is not None else kops.chunk_checksums_device(data[:n])
                fetch = kops.start_host_fetch(data[:n], lanes)
            else:
                fetch = kops.start_host_fetch(data[:n])
            self._note_part_fetch(part, fetch, rows=n * view.chunk_bytes)
            fetched = fetch.wait()
            data_np = fetched[0]
            if verify:
                faults.fire("kernels.fused")
                if self.fused_verify:
                    got = kops.chunk_checksums_host(data_np)
                    want = fetched[1]
                    if not np.array_equal(got, want):
                        bad = np.flatnonzero(np.any(got != want, axis=1))
                        self.fused_checksum_mismatches += len(bad)
                        raise FaultError(
                            f"fused dump checksum mismatch on {tkey!r}: "
                            f"{len(bad)}/{n} fetched rows fail the "
                            f"device-computed lanes (attempt rolls back)"
                        )
            gids = part.tile_ids[np.asarray(idx_np[:n], dtype=np.int64)]
            return _ShardRows(plan_key, self._drain_rows(data_np, range(n), keys=gids), "kernel")

        return _KeyTask(key=tkey, weight=weight, encode=encode, drain=drain, commit=lambda sr: sr)

    def _plan_shard_full(self, tkey: str, plan_key: str, part: Any, weight: int) -> _KeyTask:
        def drain(_enc):
            # a whole-tensor fallback part's grid is a host grid whose
            # build already counted its gather
            rows = self._drain_rows(self._part_grid_host(part), range(part.n_local),
                                    keys=part.tile_ids)
            return _ShardRows(plan_key, rows, "full")

        return _KeyTask(key=tkey, weight=weight, encode=lambda: None, drain=drain,
                        commit=lambda sr: sr)

    def _commit_sharded_key(
        self,
        key: str,
        splan: _ShardedPlan,
        shard_rows: List[_ShardRows],
        res: EncodeResult,
    ) -> None:
        """Fold one sharded view's drained parts into the store.

        Walks global chunk ids 0..n-1 in order on the caller thread — store
        mutation stays single-threaded and the resulting metadata (ids,
        digests, tile layout) is bit-identical to what a single-rank dump
        of the same tensor under the same TilePlan produces, which is the
        cross-layout determinism invariant the differential tests pin."""
        view = splan.view
        pm = splan.pm
        store = self.store
        rows: Dict[int, Tuple[bytes, Optional[bytes]]] = {}
        kinds = set()
        for sr in shard_rows:
            rows.update(sr.rows)
            kinds.add(sr.kind)
        pm_digests_ok = pm is not None and len(pm.digests) == len(pm.chunk_ids)
        with_digests = store.dedupe and (pm is None or pm_digests_ok)
        ids: List[int] = []
        digests: List[bytes] = []
        dirtied = 0
        try:
            for i in range(view.n_chunks):
                pr = rows.get(i)
                if pr is None:  # clean under the per-part diff
                    if pm is None:
                        raise FaultError(
                            f"sharded dump of {key!r} missing chunk {i} "
                            f"with no parent metadata"
                        )
                    store.incref(pm.chunk_ids[i])
                    ids.append(pm.chunk_ids[i])
                    if with_digests:
                        digests.append(pm.digests[i])
                    continue
                payload, digest = pr
                same = False
                if pm is not None:
                    if digest is not None and pm_digests_ok:
                        same = pm.digests[i] == digest
                    elif digest is None:  # digest-less store: byte compare
                        same = store.get(pm.chunk_ids[i]) == payload
                if same:
                    store.incref(pm.chunk_ids[i])
                    ids.append(pm.chunk_ids[i])
                    if with_digests:
                        digests.append(digest)
                    continue
                if digest is not None:
                    ids.append(store.put_digested(payload, digest=digest, pad=0))
                else:
                    ids.append(store.put(payload, pad=0))
                if with_digests:
                    digests.append(digest)
                dirtied += 1
        except BaseException:
            # partial fold: refs taken so far belong to no entry yet —
            # return them so the dump's rollback leaves the store balanced
            store.decref_many(ids)
            raise
        res.entries[key] = TensorMeta(
            shape=tuple(view.shape),
            dtype=view.dtype,
            chunk_ids=tuple(ids),
            digests=tuple(digests) if with_digests else (),
            trailing_pad=0,
            tile_grid=tuple(view.plan.grid),
        )
        res.dirtied += dirtied
        res.shard_parts += len(splan.tasks)
        if splan.used_base and "full" not in kinds:
            res.kernel_keys += 1
        else:
            res.full_keys += 1

    # ---------------------------------------------------- encode: execution
    def _merge_task_result(
        self, res: EncodeResult, key: str, out: Tuple[TensorMeta, int, str]
    ) -> None:
        meta, n_dirty, kind = out
        res.entries[key] = meta
        res.dirtied += n_dirty
        if kind == "kernel":
            res.kernel_keys += 1
        else:
            res.full_keys += 1

    def _run_sync(
        self,
        tasks: List[_KeyTask],
        res: EncodeResult,
        cancel: Optional[threading.Event],
        shard_out: Dict[str, List[_ShardRows]],
    ) -> None:
        for task in tasks:
            if cancel is not None and cancel.is_set():
                raise StreamCancelled(
                    f"dump cancelled after {len(res.entries)} tensors (sync path)"
                )
            out = task.run_sync()
            if isinstance(out, _ShardRows):
                shard_out.setdefault(out.plan_key, []).append(out)
            else:
                self._merge_task_result(res, task.key, out)

    def _run_streamed(
        self,
        tasks: List[_KeyTask],
        items: List[WindowItem],
        res: EncodeResult,
        cancel: Optional[threading.Event],
        priority: str,
        shard_out: Dict[str, List[_ShardRows]],
    ) -> None:
        assert self.stream is not None
        out: Dict[str, Any] = {}
        try:
            stats = self.stream.stream(items, out, cancel=cancel, priority=priority)
        except BaseException:
            # roll back everything the drain thread completed; the caller's
            # handler then rolls back clean-key increfs via res.entries
            self._rollback(out)
            raise
        for task in tasks:                      # deterministic merge order
            o = out[task.key]
            if isinstance(o, _ShardRows):
                shard_out.setdefault(o.plan_key, []).append(o)
            else:
                self._merge_task_result(res, task.key, o)
        res.streamed = True
        res.windows = stats.windows
        res.window_bytes = stats.window_bytes
        res.encode_ms = stats.encode_ms
        res.drain_ms = stats.drain_ms
        res.commit_ms = stats.commit_ms
        res.stream_wall_ms = stats.wall_ms

    def _rollback(self, produced: Dict[str, Any]) -> None:
        """Drop every chunk reference held by already-produced entries,
        restoring the store to its pre-dump state (transactional dumps)."""
        ids: List[int] = []
        for val in produced.values():
            meta = val[0] if isinstance(val, tuple) else val
            ids.extend(meta.chunk_ids)
        if ids:
            self.store.decref_many(ids)

    def _capacity(self, n_chunks: int) -> int:
        """Fixed compaction capacity, pow2-rounded (the JAX package's rule,
        kept so plans and overflow steps match it)."""
        target = max(1, int(np.ceil(n_chunks * self.capacity_frac)))
        return min(n_chunks, 1 << (target - 1).bit_length())

    def _commit_kernel_meta(
        self,
        view: ChunkedView,
        pm: TensorMeta,
        K: int,
        rows: Dict[int, Tuple[bytes, Optional[bytes]]],
    ) -> Tuple[TensorMeta, int]:
        """Fold drained dirty rows (index → (payload, digest)) into the
        store, re-referencing the parent's chunks for everything clean.

        Runs on the caller thread — all store mutation is single-threaded,
        so chunk ids come out identical to a synchronous dump.  Meta digests
        are recorded only when the parent entry also carries them (digests
        are all-or-nothing per entry)."""
        store = self.store
        with_digests = store.dedupe and len(pm.digests) == len(pm.chunk_ids)
        ids = []
        digests = []
        dirtied = 0
        try:
            for i in range(view.n_chunks):
                pr = rows.get(i)
                if pr is None:  # clean: re-reference the parent's chunk
                    store.incref(pm.chunk_ids[i])
                    ids.append(pm.chunk_ids[i])
                    if with_digests:
                        digests.append(pm.digests[i])
                    continue
                payload, digest = pr
                pad = view.trailing_pad if i == view.n_chunks - 1 else 0
                if digest is not None:   # rows are already padded: pad-0 hash
                    ids.append(store.put_digested(payload, digest=digest, pad=pad))
                else:
                    ids.append(store.put(payload, pad=pad))
                if with_digests:
                    digests.append(digest)
                dirtied += 1
        except BaseException:
            # a put/incref failure mid-fold: the refs taken so far are not in
            # any entry yet, so the outer rollback cannot see them — return
            # them here to keep the dump transactional
            store.decref_many(ids)
            raise
        return (
            TensorMeta(
                shape=view.shape,
                dtype=view.dtype,
                chunk_ids=tuple(ids),
                digests=tuple(digests) if with_digests else (),
                trailing_pad=view.trailing_pad,
            ),
            dirtied,
        )

    def _commit_full_grid(
        self,
        view: ChunkedView,
        pm: Optional[TensorMeta],
        rows: Dict[int, Tuple[bytes, Optional[bytes]]],
    ) -> Tuple[TensorMeta, int]:
        """Fold a fully-drained grid into the store, digest-deltaing every
        row against the parent entry (new tensors, shape changes, kernel
        capacity overflows)."""
        prev_ids = pm.chunk_ids if pm is not None and pm.shape == view.shape else ()
        prev_digests = pm.digests if pm is not None and pm.shape == view.shape else ()
        store = self.store
        with_digests = store.dedupe      # digests exist to key content dedupe
        ids = []
        digests = []
        dirtied = 0
        try:
            for i in range(view.n_chunks):
                payload, digest = rows[i]
                if i < len(prev_ids):
                    if digest is not None and i < len(prev_digests):
                        same = prev_digests[i] == digest
                    else:  # digest-less entry or store: full byte compare
                        same = store.get(prev_ids[i]) == payload
                    if same:
                        store.incref(prev_ids[i])
                        ids.append(prev_ids[i])
                        if digest is not None:
                            digests.append(digest)
                        continue
                pad = view.trailing_pad if i == view.n_chunks - 1 else 0
                if digest is not None:
                    ids.append(store.put_digested(payload, digest=digest, pad=pad))
                    digests.append(digest)
                else:
                    ids.append(store.put(payload, pad=pad))
                dirtied += 1
        except BaseException:
            # partial fold (a put fault or a corrupt parent read): the refs
            # taken so far belong to no entry yet — return them so the
            # dump's rollback leaves the store balanced
            store.decref_many(ids)
            raise
        return (
            TensorMeta(
                shape=view.shape,
                dtype=view.dtype,
                chunk_ids=tuple(ids),
                digests=tuple(digests) if with_digests else (),
                trailing_pad=view.trailing_pad,
            ),
            dirtied,
        )

    # --------------------------------------------------------------- decode
    def decode(self, image: Any, parent_image: Optional[Any]) -> Dict[str, Any]:
        """Rebuild a dump image's payload.

        Tensors whose parent generation is still materialized are rebuilt as
        base grid + ``delta_apply`` scatter of only the chunks whose ids
        differ from the parent's; everything else falls back to a full chunk
        concatenation.  The rebuilt generation is registered so subsequent
        restores (and dumps of its children) stay O(delta).

        Payload values are tensors on the base grid's device where the base
        is a tensor grid, and host arrays otherwise (numpy, or a CPU tensor
        for a dtype numpy cannot hold).
        """
        parent_rec = self.record_for(parent_image.image_id) if parent_image is not None else None
        try:
            payload, new_views = self._decode_with_base(image, parent_image, parent_rec)
        finally:
            self.release_record(parent_rec)
        self.register(image.image_id, new_views, anchor=None)
        return payload

    def _decode_with_base(
        self, image: Any, parent_image: Optional[Any], parent_rec: Optional[_GenRecord]
    ) -> Tuple[Dict[str, Any], Dict[str, ChunkedView]]:
        store = self.store
        payload: Dict[str, Any] = {}
        new_views: Dict[str, ChunkedView] = {}
        for name, meta in image.entries.items():
            grid: Any = None
            base = parent_rec.views.get(name) if parent_rec is not None else None
            pm = parent_image.entries.get(name) if parent_image is not None else None
            if meta.tile_grid:
                # shard-native image: per-part delta_apply when the base is
                # still sharded under the same plan, the tile layout else
                payload[name], view = self._decode_tiled(meta, pm, base)
                new_views[name] = view
                continue
            if (
                base is not None
                and pm is not None
                and not hasattr(base, "parts")
                and not getattr(base, "tile_grid", ())
                and not pm.tile_grid
                and len(pm.chunk_ids) == base.n_chunks
                and meta.dtype == pm.dtype
                and self._rows_match(meta, base.chunk_bytes)
            ):
                N = len(meta.chunk_ids)
                dirty = [
                    i
                    for i in range(N)
                    if i >= len(pm.chunk_ids) or meta.chunk_ids[i] != pm.chunk_ids[i]
                ]
                if isinstance(base.grid, np.ndarray):
                    # host base: a numpy scatter is the delta-apply kernel
                    # here (same cost argument as the encode path)
                    grid = np.zeros((N, base.chunk_bytes), np.uint8)
                    k = min(N, base.n_chunks)
                    grid[:k] = base.grid[:k]
                    for i in dirty:
                        grid[i] = np.frombuffer(store.get(meta.chunk_ids[i]), np.uint8)
                else:
                    grid = self._apply_on_device(base, N, dirty, meta)
                payload[name] = self._grid_to_array(grid, meta)
            else:
                payload[name] = read_meta_array(store, meta)
            # register the rebuilt tensor as a future base
            row_bytes = (
                base.chunk_bytes
                if grid is not None
                else len(store.get(meta.chunk_ids[0])) if meta.chunk_ids else 0
            )
            if row_bytes > 0 and meta.nbytes > 0:
                if grid is not None:
                    view = ChunkedView(
                        shape=meta.shape,
                        dtype=meta.dtype,
                        nbytes=meta.nbytes,
                        chunk_bytes=row_bytes,
                        n_chunks=grid.shape[0],
                        trailing_pad=meta.trailing_pad,
                        grid_fn=lambda g=grid: g,
                    )
                else:
                    view = self._view_from_array(payload[name], meta, row_bytes)
                if view is not None:
                    new_views[name] = view
        return payload, new_views

    def _apply_on_device(
        self, base: ChunkedView, N: int, dirty: List[int], meta: TensorMeta
    ) -> torch.Tensor:
        """A fresh (N, C) grid: a clone of the tensor base grid with the
        image's dirty chunks scattered in by ``kernels.delta_apply``.

        The kernel writes in place, so it gets a clone: the parent
        generation's grid is a view of an anchored template and must never
        change (the JAX call donates nothing either)."""
        src = base.grid
        if base.n_chunks >= N:
            grid = src[:N].clone()
        else:
            grid = torch.zeros((N, base.chunk_bytes), dtype=torch.uint8, device=src.device)
            grid[: base.n_chunks] = src
        self._apply_rows(grid, [(i, meta.chunk_ids[i]) for i in dirty])
        return grid

    def _apply_rows(self, grid: torch.Tensor, rows_ids: List[Tuple[int, int]]) -> None:
        """Scatter store chunks into ``grid`` in place with
        ``kernels.delta_apply``: ``rows_ids`` lists (grid row, chunk id).
        The scatter rows are pow2-padded (idx -1 = no-op in the kernel), the
        JAX package's launch geometry; nothing launches for no rows."""
        if not rows_ids:
            return
        M = 1 << (len(rows_ids) - 1).bit_length()
        rows = np.zeros((M, grid.shape[1]), np.uint8)
        idx = np.full((M,), -1, np.int32)
        for j, (i, cid) in enumerate(rows_ids):
            rows[j] = np.frombuffer(self.store.get(cid), np.uint8)
            idx[j] = i
        dev = grid.device
        kops.delta_apply(grid, torch.from_numpy(rows).to(dev), torch.from_numpy(idx).to(dev))

    # ------------------------------------------------------- decode: tiled
    def _decode_tiled(
        self, meta: TensorMeta, pm: Optional[TensorMeta], base: Optional[Any]
    ) -> Tuple[Any, Any]:
        """Rebuild a shard-native (tiled) tensor and its next base view.

        The route follows where the parent base lives, and an error on a
        route raises; no route falls back to another.  A ShardedView whose
        parts sit on devices, under the same TilePlan: each part scatters
        only its own dirty tiles with ``delta_apply`` on its own device and
        the global tensor reassembles from per-rank blocks (no host
        round-trip of clean bytes).  A tile grid rebuilt on a device (after
        ``recover``): the image's dirty tiles go in with ``delta_apply`` on a
        clone.  Otherwise (a host base, a misaligned layout's gather part,
        or no usable base) clean tiles come from a host grid or the store,
        and the tile layout is inverted on the host."""
        from ..dist import shard_dump as sd

        plan = sd.TilePlan.from_meta(meta)
        pm_ok = (
            pm is not None
            and tuple(pm.tile_grid) == tuple(meta.tile_grid)
            and pm.dtype == meta.dtype
            and pm.shape == meta.shape
            and len(pm.chunk_ids) == len(meta.chunk_ids)
        )
        if (
            pm_ok
            and base is not None
            and hasattr(base, "parts")
            and tuple(base.plan.grid) == tuple(plan.grid)
            and all(part.device is not None for part in base.parts)
        ):
            return self._decode_tiled_sharded(meta, pm, base, plan)
        n = plan.n_tiles
        flat_base = None
        if (
            pm_ok
            and base is not None
            and not hasattr(base, "parts")
            and tuple(getattr(base, "tile_grid", ())) == tuple(plan.grid)
            and base.chunk_bytes == plan.tile_bytes
            and base.n_chunks == n
        ):
            flat_base = base.grid
        if isinstance(flat_base, torch.Tensor):
            grid = flat_base.clone()
            self._apply_rows(grid, [
                (i, meta.chunk_ids[i]) for i in range(n) if meta.chunk_ids[i] != pm.chunk_ids[i]
            ])
            arr = sd.device_grid_to_block(grid, plan.grid, plan.tile, meta.dtype)
        else:
            store = self.store
            grid = np.empty((n, plan.tile_bytes), np.uint8)
            for i in range(n):
                if flat_base is not None and meta.chunk_ids[i] == pm.chunk_ids[i]:
                    grid[i] = flat_base[i]
                else:
                    grid[i] = np.frombuffer(store.get(meta.chunk_ids[i]), np.uint8)
            arr = sd.grid_to_array(grid, plan)
        view = ChunkedView(
            shape=tuple(meta.shape),
            dtype=meta.dtype,
            nbytes=plan.nbytes,
            chunk_bytes=plan.tile_bytes,
            n_chunks=n,
            trailing_pad=0,
            grid_fn=lambda g=grid: g,
            tile_grid=tuple(plan.grid),
        )
        return arr, view

    def _decode_tiled_sharded(
        self, meta: TensorMeta, pm: TensorMeta, base: Any, plan: Any
    ) -> Tuple[Any, Any]:
        """Per-part restore: each part of the base scatters the image's
        dirty tiles of its own block into a clone of its grid (one
        ``delta_apply`` per part with dirty tiles; the base never changes),
        then its block is rebuilt from the grid, and every rank of the
        base's sharding takes the block at its index.  A base without a
        sharding (a plain tensor) is one part, and its block is the tensor."""
        from ..dist import shard_dump as sd

        out_parts = []
        block_by_off: Dict[Tuple[int, ...], torch.Tensor] = {}
        for part in base.parts:
            gids = part.tile_ids
            dirty = [
                (j, meta.chunk_ids[int(g)])
                for j, g in enumerate(gids)
                if meta.chunk_ids[int(g)] != pm.chunk_ids[int(g)]
            ]
            # a live part's grid is built fresh (uncached); an owned one is
            # the base itself and is cloned before the in-place scatter
            bgrid = part.grid if part.owns_grid else part.grid_fn()
            if dirty:
                bgrid = bgrid.clone()
                self._apply_rows(bgrid, dirty)
            out_parts.append((part, bgrid))
            block_by_off[part.offsets] = sd.device_grid_to_block(
                bgrid, part.counts, plan.tile, meta.dtype
            )
        sharding = base.sharding
        view = sd.view_from_part_grids(plan, out_parts, sharding)
        if sharding is None:
            (block,) = block_by_off.values()
            return block, view
        tile = plan.tile
        moved: Dict[Tuple, torch.Tensor] = {}
        blocks = []
        for rank, index in sharding.addressable_devices_indices_map(tuple(meta.shape)).items():
            dev = sharding.mesh.device_of(rank)
            offs = tuple(sl.start // t for sl, t in zip(index, tile))
            block = block_by_off[offs]
            if block.device != dev:
                block = moved.setdefault((offs, dev), block.to(dev))
            blocks.append(block)
        return sd.assemble_from_parts(view, blocks), view

    @staticmethod
    def _rows_match(meta: TensorMeta, row_bytes: int) -> bool:
        """Image chunking must align with the base grid's row layout."""
        n = len(meta.chunk_ids)
        return n > 0 and n * row_bytes == meta.nbytes + meta.trailing_pad

    @staticmethod
    def _grid_to_array(grid: Any, meta: TensorMeta) -> Any:
        """The tensor of ``meta`` from its (N, C) byte grid, as an
        independent copy (the grid stays registered as a future base)."""
        if isinstance(grid, torch.Tensor):
            flat = grid.reshape(-1)[: meta.nbytes].clone()
            return flat.view(torch_dtype(meta.dtype)).reshape(meta.shape)
        return array_from_bytes(np.ascontiguousarray(grid).reshape(-1), meta.shape, meta.dtype)

    @staticmethod
    def _view_from_array(
        arr: Any, meta: TensorMeta, row_bytes: int
    ) -> Optional[ChunkedView]:
        n = len(meta.chunk_ids)
        if n * row_bytes != meta.nbytes + meta.trailing_pad:
            return None
        # Eager copy, twice over: (a) the caller's restore_fn owns (and may
        # mutate) the payload array after decode returns, so a lazy view
        # would alias it; (b) a store-backed lazy rebuild would race
        # drop_checkpoint's chunk decrefs on records still pinned by an
        # in-flight dump.  Cost is bounded: at most max_generations decoded
        # states stay resident, and MCTS re-injects templates so decode
        # registrations are rare.
        grid = np.zeros((n, row_bytes), np.uint8)
        grid.reshape(-1)[: meta.nbytes] = host_bytes(arr)
        return ChunkedView(
            shape=meta.shape,
            dtype=meta.dtype,
            nbytes=meta.nbytes,
            chunk_bytes=row_bytes,
            n_chunks=n,
            trailing_pad=meta.trailing_pad,
            grid_fn=lambda g=grid: g,
        )
