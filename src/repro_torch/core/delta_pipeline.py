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
fork, so CoW keeps the viewed pages immutable); a cache miss falls back to
the digest path, which is still O(S) hashing but O(Δ) store writes.

Grids are numpy arrays (host state: an exact numpy compare and scatter)
or torch tensors (device state: the CUDA kernels on the card, their plain
versions for a tensor on the CPU).  The mesh-sharded and tiled branches of
the JAX package are not ported yet.
"""
from __future__ import annotations

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
    """

    views: Dict[str, ChunkedView] = field(default_factory=dict)
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    dirty_keys: Optional[FrozenSet[str]] = None

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
        use_base: bool = True,
    ) -> EncodeResult:
        """Build the image entries for one generation (dump-worker thread).

        When the pipeline owns a :class:`ChunkStreamEngine` and the plan is
        large enough to split into windows, the per-tensor work streams
        through it: diff dispatch of window k+1 overlaps the device→host
        copy + store put of window k.  ``cancel`` aborts at the next window
        boundary and rolls back every chunk reference this dump acquired
        (raising :class:`StreamCancelled`); ``priority`` is forwarded to the
        QoS gate ("bg" dumps yield to runnable sessions, "fg" do not).

        ``use_base=False`` is the adaptive engine's *straight-copy* mode for
        mostly-dirty generations: skip the diff kernels entirely (no base
        grid lookup → every dirty-hinted key drains in full) while keeping
        everything else — clean-key metadata reuse, streaming overlap, the
        parent digest compare at commit (dump bytes stay ∝ the dirty set),
        and the generation anchor for future O(delta) chaining.
        """
        res = EncodeResult(entries={}, dirtied=0)
        parent_entries = parent_image.entries if parent_image is not None else {}
        parent_rec = (
            self.record_for(parent_image.image_id)
            if parent_image is not None and use_base
            else None
        )
        try:
            return self._encode_with_parent(
                gen, parent_entries, parent_rec, res, cancel=cancel, priority=priority
            )
        finally:
            # device grids materialized for this diff are O(state) on-device
            # copies — free them; the anchors re-gather lazily next time
            for view in gen.views.values():
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
        res: "EncodeResult",
        *,
        cancel: Optional[threading.Event] = None,
        priority: str = "bg",
    ) -> "EncodeResult":
        store = self.store
        tasks: List[_KeyTask] = []
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
            base = parent_rec.views.get(key) if parent_rec is not None else None
            tasks.append(self._plan_key(key, view, pm if pm_ok else None, base))

        items = [t.as_window_item() for t in tasks]
        streamed = self.stream is not None and self.stream.should_stream(items)
        try:
            if streamed:
                self._run_streamed(tasks, items, res, cancel, priority)
            else:
                self._run_sync(tasks, res, cancel)
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
                meta, n_dirty = digest_encode_array(store, arr, pm)
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
    def _padded_pair(old_grid, new_grid, K: int, K2: int):
        """The first K rows of both grids on one device, zero-padded to K2
        rows: the identical pad rows can never read as dirty."""
        dev = _grid_device(new_grid, old_grid)
        old_t = _as_grid(old_grid, dev)[:K]
        new_t = _as_grid(new_grid, dev)[:K]
        if K2 != K:
            pad = (0, 0, 0, K2 - K)
            old_t = torch.nn.functional.pad(old_t, pad)
            new_t = torch.nn.functional.pad(new_t, pad)
        return old_t.contiguous(), new_t.contiguous()

    def _plan_device_kernel(
        self, key, view, pm, old_grid, new_grid, K: int, weight: int
    ) -> _KeyTask:
        # pow2-pad the row count so the fixed capacity only takes
        # O(log N) values as a KV cache grows (the JAX package pads to keep
        # its jit cache small; the same padding keeps the plans identical)
        K2 = 1 << (K - 1).bit_length()
        cap = self._capacity(K2)
        if self.fused and cap * view.chunk_bytes <= self.FUSED_VMEM_BYTES:
            return self._plan_device_fused(
                key, view, pm, old_grid, new_grid, K, K2, cap, weight
            )

        def encode():
            old_t, new_t = self._padded_pair(old_grid, new_grid, K, K2)
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
            old_t, new_t = self._padded_pair(old_grid, new_grid, K, K2)
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
    ) -> None:
        for task in tasks:
            if cancel is not None and cancel.is_set():
                raise StreamCancelled(
                    f"dump cancelled after {len(res.entries)} tensors (sync path)"
                )
            self._merge_task_result(res, task.key, task.run_sync())

    def _run_streamed(
        self,
        tasks: List[_KeyTask],
        items: List[WindowItem],
        res: EncodeResult,
        cancel: Optional[threading.Event],
        priority: str,
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
            self._merge_task_result(res, task.key, out[task.key])
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
            if (
                base is not None
                and pm is not None
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
        dev = src.device
        if base.n_chunks >= N:
            grid = src[:N].clone()
        else:
            grid = torch.zeros((N, base.chunk_bytes), dtype=torch.uint8, device=dev)
            grid[: base.n_chunks] = src
        if dirty:
            # pow2-pad the scatter rows (idx -1 = no-op in the kernel), the
            # JAX package's launch geometry
            M = 1 << (len(dirty) - 1).bit_length()
            rows = np.zeros((M, base.chunk_bytes), np.uint8)
            idx = np.full((M,), -1, np.int32)
            for j, i in enumerate(dirty):
                rows[j] = np.frombuffer(self.store.get(meta.chunk_ids[i]), np.uint8)
                idx[j] = i
            kops.delta_apply(
                grid, torch.from_numpy(rows).to(dev), torch.from_numpy(idx).to(dev)
            )
        return grid

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
