"""DeltaCR — template-fork fast path + async delta dumps for session state.

The ephemeral dimension of a DeltaBox sandbox.  On the GPU the "process
memory" is the live agent-session state held in device tensors: KV cache,
recurrent state, decode cursors, RNG state, environment buffers.  DeltaCR
manages it with the paper's two co-designed paths:

* **Template pool (fast path).**  At every checkpoint the session is *forked*
  at a quiesce point — for :class:`CowTensorState` this shares every tensor
  by reference, copy-on-write (the page-table-only ``fork()`` analogue, no
  data movement).  The frozen fork is registered
  as that checkpoint's template.  Restore = fork the template again: O(state
  metadata), independent of memory footprint.  A bounded pool evicts LRU
  templates (releasing their page references); eviction costs only latency,
  never correctness.

* **Async dump (durable slow path).**  Concurrently, the template's payload
  is serialized to the chunk store on a single-worker background thread (the
  CRIU-dump-to-tmpfs analogue), *delta-encoded* against the parent
  checkpoint's image.  States implementing :class:`~.delta_pipeline.DeltaEncodable`
  go through the :class:`~.delta_pipeline.DeltaDumpPipeline`: an on-device
  diff + compaction (the CUDA delta kernels) so only the compacted dirty
  chunks ever cross device→host, untouched tensors are re-referenced at the
  metadata level, and dump cost is O(inter-checkpoint delta).  Other states
  use the per-chunk digest path (hash once, 16-byte parent compare).  The
  dump is masked by the LLM inference window — the caller never blocks on it.

* **Async-warm.**  After a fork, ``warm()`` runs on a background thread to
  pre-privatize the pages the session will write next (the CoW-fault
  absorption thread of §4.2.2).

States plug in through the :class:`ForkableState` protocol; ``CowArrayState``
is the host-side implementation over numpy arrays and :class:`CowTensorState`
the device-side one over torch tensors.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Set, Tuple, runtime_checkable

import numpy as np
import torch

from .. import trace
from ..kernels._build import KernelError
from . import faults
from .chunk_store import ChunkStore, chunk_digest
from .delta_pipeline import (
    ChunkedView,
    DeltaDumpPipeline,
    DeltaGeneration,
    EncodeResult,
    digest_encode_array,
    dirty_base,
    mark_clean,
    mark_unknown,
)
from .deltafs import TensorMeta, dtype_str, host_bytes, read_meta_array
from .faults import FaultError, WorkerKilled
from .image_store import DumpTicket, ImageStore
from .policy import DumpPolicy, ModeSelector, dirty_fraction_hint
from .stream import ChunkStreamEngine, DumpGate, StreamCancelled, StreamConfig

__all__ = [
    "ForkableState",
    "CowArrayState",
    "CowTensorState",
    "DumpImage",
    "DumpPolicy",
    "DumpTimeout",
    "DeltaCR",
    "DeltaCRStats",
]


class DumpTimeout(RuntimeError):
    """A dump attempt exceeded its per-dump deadline.

    Raised *after* the attempt's state has been fully rolled back (the
    deadline rides the transactional :class:`StreamCancelled` cancel path),
    so the caller may retry or degrade to the legacy full path safely."""


class _EitherEvent:
    """is_set() over several events — lets a per-dump deadline ride the same
    cancel plumbing drop_checkpoint uses, without touching the user event."""

    def __init__(self, *events: Optional[threading.Event]):
        self._events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)


try:
    # The same interpreter-shutdown hook concurrent.futures uses: runs
    # *before* non-daemon thread joins and daemon-thread teardown, so live
    # workers drain cleanly even when the process exits without shutdown()
    # (an unhandled exception while a dump is mid-device-fetch would
    # otherwise kill the daemon thread inside native code and abort).
    from threading import _register_atexit as _thread_atexit
except ImportError:  # pragma: no cover - future interpreters
    _thread_atexit = None

_LIVE_WORKERS: "weakref.WeakSet[_SupervisedWorker]" = weakref.WeakSet()
_WORKER_ATEXIT_ARMED = False


def _drain_workers_at_exit() -> None:
    for worker in list(_LIVE_WORKERS):
        worker.shutdown(wait=True)


class _SupervisedWorker:
    """Supervised single-thread FIFO executor (the GSD dump thread).

    Same FIFO ordering as the ThreadPoolExecutor it replaces — the delta
    chain depends on parent dumps completing before children — plus
    supervision: if the worker thread dies (a :class:`WorkerKilled`
    escaping a task, or any interpreter-level BaseException), the dying
    thread resolves its in-flight future loudly (converted to a catchable
    :class:`FaultError`), spawns its own successor, and exits.  Queued
    tasks survive in the queue and drain on the successor; nothing wedges
    and no ticket is silently lost — each dump task aborts its ImageStore
    ticket on the way out (see ``DeltaCR._dump_image``)."""

    def __init__(self, name: str):
        self._name = name
        self._q: "queue.Queue[Optional[Tuple[Future, Callable[..., Any], tuple]]]" = queue.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._shut = False
        self.deaths = 0              # worker threads that died mid-loop
        self.restarts = 0            # successor threads spawned
        global _WORKER_ATEXIT_ARMED
        if _thread_atexit is not None:
            _LIVE_WORKERS.add(self)
            if not _WORKER_ATEXIT_ARMED:
                _WORKER_ATEXIT_ARMED = True
                _thread_atexit(_drain_workers_at_exit)
        self._spawn(initial=True)

    def _spawn(self, *, initial: bool = False) -> None:
        with self._lock:
            if self._shut:
                return
            alive = self._thread is not None and self._thread.is_alive()
            if alive and self._thread is not threading.current_thread():
                return               # someone else already respawned
            if not initial:
                self.restarts += 1
            self._thread = threading.Thread(target=self._run, name=self._name, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException:
            with self._lock:
                self.deaths += 1
                shut = self._shut
            if not shut:
                self._spawn()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                result = fn(*args)
            except WorkerKilled as exc:
                # resolve the task loudly with an *Exception* (callers use
                # `except Exception` / future.result()), then let the kill
                # escape and take this thread down — supervision restarts it
                fut.set_exception(FaultError(f"dump worker died: {exc}"))
                raise
            except BaseException as exc:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

    def submit(self, fn: Callable[..., Any], *args: Any) -> Future:
        with self._lock:
            if self._shut:
                raise RuntimeError("dump worker is shut down")
        fut: Future = Future()
        self._q.put((fut, fn, args))
        # belt-and-braces: normally the dying thread respawns itself, but if
        # that also failed, the next submit revives the worker
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
        if not alive:
            self._spawn()
        return fut

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._shut = True
            thread = self._thread
        self._q.put(None)
        if wait and thread is not None:
            thread.join(timeout=60.0)


# --------------------------------------------------------------------------
# ForkableState protocol + host reference implementation
# --------------------------------------------------------------------------
@runtime_checkable
class ForkableState(Protocol):
    """The contract DeltaCR needs from a session state."""

    def fork(self) -> "ForkableState":
        """O(metadata) copy-on-write clone observing the same instant."""

    def release(self) -> None:
        """Drop this clone's references (template eviction / session kill)."""

    def warm(self) -> None:
        """Pre-privatize the hot write set (async-warm); optional no-op."""

    def dump_payload(self) -> Dict[str, Any]:
        """Flat name→array payload capturing the full state (numpy arrays,
        or torch tensors for device state)."""


class CowArrayState:
    """Host-side ForkableState over a dict of numpy arrays.

    Fork shares every array by reference (refcounted); the first write to a
    shared array copies it (the CoW fault).  ``warm`` pre-copies arrays in
    the declared hot set so later writes find them private — the async-warm
    analogue.  Used for RL environment state and as the benchmark archetype
    substrate.

    Write tracking: the keys written since this clone's lineage was last
    marked clean (a checkpoint or restore) feed the delta pipeline's
    dirty-key hint, so untouched tensors are re-referenced at the metadata
    level without ever materializing their bytes.  ``None`` means unknown
    (everything is treated as dirty) — always safe, never required.
    """

    def __init__(
        self,
        arrays: Optional[Dict[str, np.ndarray]] = None,
        *,
        hot_keys: Tuple[str, ...] = (),
        restore_hook: Optional[Callable[["CowArrayState"], None]] = None,
    ):
        self._arrays: Dict[str, np.ndarray] = dict(arrays or {})
        self._shared: Dict[str, "_SharedCell"] = {
            k: _SharedCell(refs=1) for k in self._arrays
        }
        # Guards the (array, cell) pairs: an async warm privatizes on the
        # warm thread while the owner forks, writes or releases.
        self._lock = threading.RLock()
        self.hot_keys = tuple(hot_keys)
        self.restore_hook = restore_hook
        self.cow_faults = 0           # inline (critical-path) CoW copies
        self.warmed_copies = 0        # copies absorbed by async-warm
        self._released = False
        self._dirty: Optional[Set[str]] = None   # None = unknown lineage
        self._dirty_base: Optional[int] = None   # ckpt the set is relative to

    # -- reads ---------------------------------------------------------
    def get(self, key: str) -> np.ndarray:
        return self._arrays[key]

    def keys(self):
        return self._arrays.keys()

    # -- writes (CoW) ----------------------------------------------------
    def _privatize(self, key: str, *, warm: bool = False) -> None:
        with self._lock:
            cell = self._shared[key]
            with cell.lock:
                if cell.refs > 1:
                    cell.refs -= 1
                    self._arrays[key] = self._arrays[key].copy()
                    self._shared[key] = _SharedCell(refs=1)
                    if warm:
                        self.warmed_copies += 1
                    else:
                        self.cow_faults += 1

    def _note_write(self, key: str) -> None:
        if self._dirty is not None:
            self._dirty.add(key)

    def set(self, key: str, value: np.ndarray) -> None:
        self._note_write(key)
        with self._lock:
            if key in self._arrays:
                self._privatize(key)
                self._arrays[key] = np.asarray(value)
            else:
                self._arrays[key] = np.asarray(value)
                self._shared[key] = _SharedCell(refs=1)

    def mutate(self, key: str, fn: Callable[[np.ndarray], None]) -> None:
        """In-place mutation with a CoW fault if the array is shared."""
        self._note_write(key)
        self._privatize(key)
        fn(self._arrays[key])

    # -- dirty tracking --------------------------------------------------
    def reset_dirty_tracking(self, base_ckpt: Optional[int] = None) -> None:
        self._dirty = set()
        self._dirty_base = base_ckpt

    def invalidate_dirty_tracking(self) -> None:
        self._dirty = None
        self._dirty_base = None

    def dirty_tracking_base(self) -> Optional[int]:
        return self._dirty_base if self._dirty is not None else None

    def dirty_fraction_hint(self) -> Optional[float]:
        """Byte-weighted upper bound on the dirty fraction since the last
        mark-clean (a key counts fully dirty after one element write);
        None when tracking is invalid.  Feeds the adaptive mode selector."""
        if self._dirty is None:
            return None
        total = sum(a.nbytes for a in self._arrays.values())
        if total <= 0:
            return 0.0
        dirty = sum(
            self._arrays[k].nbytes for k in self._dirty if k in self._arrays
        )
        return min(dirty / total, 1.0)

    # -- ForkableState ---------------------------------------------------
    def fork(self) -> "CowArrayState":
        clone = CowArrayState.__new__(CowArrayState)
        with self._lock:
            # one consistent snapshot of the (array, cell) pairs, and the
            # refs taken on exactly the cells the clone holds
            clone._arrays = dict(self._arrays)
            clone._shared = dict(self._shared)
            for cell in clone._shared.values():
                with cell.lock:
                    cell.refs += 1
        clone._lock = threading.RLock()
        clone.hot_keys = self.hot_keys
        clone.restore_hook = self.restore_hook
        clone.cow_faults = 0
        clone.warmed_copies = 0
        clone._released = False
        clone._dirty = None if self._dirty is None else set(self._dirty)
        clone._dirty_base = self._dirty_base
        return clone

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
            for cell in self._shared.values():
                with cell.lock:
                    cell.refs -= 1
            self._arrays.clear()
            self._shared.clear()

    def warm(self) -> None:
        for key in self.hot_keys:
            if key in self._arrays:
                self._privatize(key, warm=True)

    def dump_payload(self) -> Dict[str, np.ndarray]:
        return {k: np.ascontiguousarray(v) for k, v in self._arrays.items()}

    # -- DeltaEncodable --------------------------------------------------
    def delta_generation(self, chunk_bytes: int) -> DeltaGeneration:
        """Chunked views for multi-chunk arrays, digest path for the rest."""
        views: Dict[str, ChunkedView] = {}
        extras: Dict[str, np.ndarray] = {}
        for key, arr in self._arrays.items():
            arr = np.ascontiguousarray(arr)
            if arr.nbytes >= chunk_bytes:
                views[key] = ChunkedView.from_host_array(arr, chunk_bytes)
            else:
                extras[key] = arr
        dirty = None if self._dirty is None else frozenset(self._dirty)
        return DeltaGeneration(views=views, extras=extras, dirty_keys=dirty)

    # -- footprint accounting (Table 3 analogue) -------------------------
    def resident_bytes(self) -> int:
        """Bytes attributable to this clone: private arrays + shared/refs."""
        total = 0.0
        for key, cell in self._shared.items():
            total += self._arrays[key].nbytes / max(cell.refs, 1)
        return int(total)


@dataclass
class _SharedCell:
    refs: int
    lock: threading.Lock = field(default_factory=threading.Lock)


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_device_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A contiguous tensor on ``device`` from a tensor or a numpy array
    (bit for bit, bfloat16 included; see ``convert.tensor_from_numpy``)."""
    if not isinstance(value, torch.Tensor):
        from .convert import tensor_from_numpy

        value = tensor_from_numpy(value)
    return value.to(device).contiguous()


class CowTensorState:
    """Device-side ForkableState over a dict of torch tensors.

    The counterpart of :class:`CowArrayState` for device memory, with the
    same CoW, fork, warm and dirty-tracking semantics: fork shares every
    tensor by reference (refcounted); the first write to a shared tensor
    clones it on the device (the CoW fault); ``warm`` pre-clones the
    declared hot set.  ``delta_generation`` exposes each tensor as a
    zero-copy ``(n, chunk_bytes)`` uint8 grid on its device (a padded copy
    only for a ragged tail), so dumps diff on the card.

    Writes go through :meth:`set` or :meth:`mutate` only.  A dump's parent
    generation is a view of a template's tensor; writing into ``get(key)``
    directly would skip the CoW fault and change that parent in place.

    ``device=None`` means the card; pass ``device="cpu"`` to run on the CPU
    (the kernels' plain versions).
    """

    def __init__(
        self,
        tensors: Optional[Dict[str, Any]] = None,
        *,
        hot_keys: Tuple[str, ...] = (),
        device: Any = None,
        restore_hook: Optional[Callable[["CowTensorState"], None]] = None,
    ):
        self.device = resolve_device(device)
        self._tensors: Dict[str, torch.Tensor] = {
            k: as_device_tensor(v, self.device) for k, v in (tensors or {}).items()
        }
        self._shared: Dict[str, _SharedCell] = {k: _SharedCell(refs=1) for k in self._tensors}
        # Guards the (tensor, cell) pairs: an async warm privatizes on the
        # warm thread while the owner forks, writes or releases.
        self._lock = threading.RLock()
        self.hot_keys = tuple(hot_keys)
        self.restore_hook = restore_hook
        self.cow_faults = 0           # inline (critical-path) CoW clones
        self.warmed_copies = 0        # clones absorbed by async-warm
        self._released = False
        self._dirty: Optional[Set[str]] = None   # None = unknown lineage
        self._dirty_base: Optional[int] = None   # ckpt the set is relative to

    # -- reads ---------------------------------------------------------
    def get(self, key: str) -> torch.Tensor:
        """The tensor under ``key``; read it, never write into it."""
        return self._tensors[key]

    def keys(self):
        return self._tensors.keys()

    # -- writes (CoW) ----------------------------------------------------
    def _privatize(self, key: str, *, warm: bool = False) -> None:
        with self._lock:
            cell = self._shared[key]
            with cell.lock:
                if cell.refs > 1:
                    cell.refs -= 1
                    self._tensors[key] = self._tensors[key].clone()
                    self._shared[key] = _SharedCell(refs=1)
                    if warm:
                        self.warmed_copies += 1
                    else:
                        self.cow_faults += 1

    def _note_write(self, key: str) -> None:
        if self._dirty is not None:
            self._dirty.add(key)

    def set(self, key: str, value: Any) -> None:
        self._note_write(key)
        value = as_device_tensor(value, self.device)
        with self._lock:
            if key in self._tensors:
                self._privatize(key)
            else:
                self._shared[key] = _SharedCell(refs=1)
            self._tensors[key] = value

    def mutate(self, key: str, fn: Callable[[torch.Tensor], None]) -> None:
        """In-place mutation with a CoW fault if the tensor is shared."""
        self._note_write(key)
        self._privatize(key)
        fn(self._tensors[key])

    # -- dirty tracking --------------------------------------------------
    def reset_dirty_tracking(self, base_ckpt: Optional[int] = None) -> None:
        self._dirty = set()
        self._dirty_base = base_ckpt

    def invalidate_dirty_tracking(self) -> None:
        self._dirty = None
        self._dirty_base = None

    def dirty_tracking_base(self) -> Optional[int]:
        return self._dirty_base if self._dirty is not None else None

    def dirty_fraction_hint(self) -> Optional[float]:
        """Byte-weighted upper bound on the dirty fraction since the last
        mark-clean; None when tracking is invalid."""
        if self._dirty is None:
            return None
        total = sum(t.nbytes for t in self._tensors.values())
        if total <= 0:
            return 0.0
        dirty = sum(self._tensors[k].nbytes for k in self._dirty if k in self._tensors)
        return min(dirty / total, 1.0)

    # -- ForkableState ---------------------------------------------------
    def fork(self) -> "CowTensorState":
        clone = CowTensorState.__new__(CowTensorState)
        clone.device = self.device
        with self._lock:
            # one consistent snapshot of the (tensor, cell) pairs, and the
            # refs taken on exactly the cells the clone holds
            clone._tensors = dict(self._tensors)
            clone._shared = dict(self._shared)
            for cell in clone._shared.values():
                with cell.lock:
                    cell.refs += 1
        clone._lock = threading.RLock()
        clone.hot_keys = self.hot_keys
        clone.restore_hook = self.restore_hook
        clone.cow_faults = 0
        clone.warmed_copies = 0
        clone._released = False
        clone._dirty = None if self._dirty is None else set(self._dirty)
        clone._dirty_base = self._dirty_base
        return clone

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
            for cell in self._shared.values():
                with cell.lock:
                    cell.refs -= 1
            self._tensors.clear()
            self._shared.clear()

    def warm(self) -> None:
        for key in self.hot_keys:
            if key in self._tensors:
                self._privatize(key, warm=True)

    def dump_payload(self) -> Dict[str, torch.Tensor]:
        return dict(self._tensors)

    # -- DeltaEncodable --------------------------------------------------
    def delta_generation(self, chunk_bytes: int) -> DeltaGeneration:
        """Device byte grids for multi-chunk tensors, digest path for the
        rest."""
        views: Dict[str, ChunkedView] = {}
        extras: Dict[str, torch.Tensor] = {}
        for key, t in self._tensors.items():
            if t.nbytes >= chunk_bytes:
                views[key] = _tensor_view(t, chunk_bytes)
            else:
                extras[key] = t
        dirty = None if self._dirty is None else frozenset(self._dirty)
        return DeltaGeneration(views=views, extras=extras, dirty_keys=dirty)

    def resident_bytes(self) -> int:
        """Bytes attributable to this clone: private tensors + shared/refs."""
        total = 0.0
        for key, cell in self._shared.items():
            total += self._tensors[key].nbytes / max(cell.refs, 1)
        return int(total)


def _tensor_view(t: torch.Tensor, chunk_bytes: int) -> ChunkedView:
    """A tensor as a lazy ``(n, chunk_bytes)`` uint8 grid on its device:
    a zero-copy view, or a zero-padded copy when the tail row is ragged."""
    nbytes = int(t.nbytes)
    n_chunks = -(-nbytes // chunk_bytes)
    pad = n_chunks * chunk_bytes - nbytes

    def build() -> torch.Tensor:
        flat = t.reshape(-1).view(torch.uint8)
        if pad == 0:
            return flat.view(n_chunks, chunk_bytes)
        grid = torch.zeros((n_chunks, chunk_bytes), dtype=torch.uint8, device=t.device)
        grid.view(-1)[:nbytes] = flat
        return grid

    return ChunkedView(
        shape=tuple(t.shape),
        dtype=dtype_str(t.dtype),
        nbytes=nbytes,
        chunk_bytes=chunk_bytes,
        n_chunks=n_chunks,
        trailing_pad=pad,
        grid_fn=build,
    )


# --------------------------------------------------------------------------
# Dump images (the CRIU-image analogue)
# --------------------------------------------------------------------------
@dataclass
class DumpImage:
    """A durable, delta-encoded state image in the chunk store.

    Self-contained: holds a full chunk map per tensor with unchanged chunks
    *shared* with the parent image (so restore never walks an image chain,
    while storage stays proportional to the delta)."""

    image_id: int
    parent_id: Optional[int]
    entries: Dict[str, TensorMeta]
    dirtied_chunks: int
    dump_bytes: int          # physical bytes this image added
    wall_ms: float
    mode: str = "digest"     # "delta" | "copy" | "digest" | "legacy"
    # adaptive-selection telemetry (None when no prediction/parent applied;
    # process-local observability — deliberately not persisted)
    predicted_dirty_frac: Optional[float] = None
    actual_dirty_frac: Optional[float] = None
    # streaming accounting (zeros when the dump ran synchronously)
    streamed: bool = False
    stream_windows: int = 0
    stream_window_bytes: int = 0     # the (possibly EWMA-adapted) budget used
    encode_ms: float = 0.0   # diff dispatch / host compare stage
    drain_ms: float = 0.0    # device→host fetch + copy + hash stage (pool)
    commit_ms: float = 0.0   # store folds + metadata stage (caller)
    shard_parts: int = 0     # per-part tasks run (0 = no sharded tensors)


class DeltaCRStats:
    def __init__(self) -> None:
        self.dumps = 0
        self.dump_dirty_chunks = 0
        self.dump_bytes = 0
        self.fast_restores = 0
        self.slow_restores = 0
        self.evictions = 0
        # pipeline accounting
        self.delta_dumps = 0          # dumps through the kernel pipeline
        self.clean_keys = 0           # tensors re-referenced metadata-only
        self.kernel_keys = 0          # tensors diffed on device
        self.full_keys = 0            # tensors fully materialized
        # streaming accounting
        self.streamed_dumps = 0       # dumps that went through the stream engine
        self.stream_windows = 0       # total windows streamed
        self.cancelled_dumps = 0      # dumps rolled back mid-stream
        # shard-native accounting (gather-free dumps of mesh-sharded state)
        self.sharded_dumps = 0        # dumps containing >=1 sharded tensor
        self.shard_parts = 0          # per-part encode/drain tasks run
        # fault-domain accounting (self-healing dump path)
        self.dump_retries = 0         # encode attempts retried after rollback
        self.dump_failures = 0        # dumps that failed loudly (ticket aborted)
        self.fallback_dumps = 0       # delta/digest dumps degraded to legacy
        self.degraded_dumps = 0       # dumps that skipped delta in degraded mode
        self.deadline_trips = 0       # per-dump deadlines exceeded
        # adaptive-mode accounting
        self.mode_dumps: Dict[str, int] = {}  # landed mode -> dump count
        self.pred_err_sum = 0.0       # Σ|predicted - actual| dirty fraction
        self.pred_err_n = 0           # dumps with both prediction and actual
        self.lock = threading.Lock()


@dataclass
class _EncodeOutcome:
    """Result of one (possibly retried / degraded) encode: what landed."""

    entries: Dict[str, TensorMeta]
    dirtied: int
    mode: str                                 # "delta" | "copy" | "digest" | "legacy"
    anchor_views: Optional[Dict[str, ChunkedView]] = None
    clean_keys: int = 0
    kernel_keys: int = 0
    full_keys: int = 0
    res: Optional[EncodeResult] = None
    # adaptive-selection telemetry, stamped by _encode_with_recovery
    pred_frac: Optional[float] = None         # selector's predicted dirty frac
    hint_frac: Optional[float] = None         # raw state hint fed to predict()
    fell_back: bool = False                   # primary failed, legacy landed


# --------------------------------------------------------------------------
# DeltaCR
# --------------------------------------------------------------------------
class DeltaCR:
    """Coordinates the template pool and async delta dumps for one sandbox.

    All dump behavior is configured by a single frozen :class:`DumpPolicy`
    (``DeltaCR(store, policy=DumpPolicy.latency())``); the historical loose
    keywords (``dump_mode=``, ``dump_retries=``, ...) still work through a
    deprecation shim that folds them into a policy.

    ``policy.mode`` selects the serialization strategy:

    * ``"auto"``  — **adaptive**: per dump, a :class:`ModeSelector` predicts
      the dirty fraction from the state's dirty-key hint blended with an
      EWMA of measured fractions for this sandbox lineage, then picks the
      cheapest path — the kernel delta pipeline at low dirty fractions, a
      straight full-grid copy (no diff kernel) past the measured crossover,
      digest for non-:class:`DeltaEncodable` states.  Until the predictor
      has calibration evidence it behaves exactly like ``"delta"``.
    * ``"delta"`` — always the kernel pipeline for :class:`DeltaEncodable`
      states (on-device diff, O(delta) device→host), digest otherwise.
    * ``"digest"`` — per-chunk digest delta (hash once, 16-byte parent
      compare); no kernels.
    * ``"legacy"`` — the original full-serialize path (``tobytes`` + full
      byte comparison per chunk); kept as the benchmark baseline.
    """

    def __init__(
        self,
        store: Optional[ChunkStore] = None,
        *,
        policy: Optional[DumpPolicy] = None,
        template_pool_size: int = 8,
        restore_fn: Optional[Callable[[Dict[str, Any]], ForkableState]] = None,
        async_warm: bool = True,
        chunk_bytes: int = 64 * 1024,
        pipeline: Optional[DeltaDumpPipeline] = None,
        **legacy_knobs: Any,
    ):
        if legacy_knobs:
            if policy is not None:
                raise TypeError(
                    "pass either policy= or the legacy dump keywords, not "
                    f"both (got legacy: {sorted(legacy_knobs)})"
                )
            # Deprecated loose keywords (dump_mode=, dump_retries=, ...)
            # fold into a DumpPolicy; unknown names raise TypeError exactly
            # like a normal bad keyword would.
            policy = DumpPolicy.from_legacy_kwargs(legacy_knobs)
        self.policy = policy if policy is not None else DumpPolicy()
        # NOTE: explicit None check — an *empty* ChunkStore is falsy (len 0),
        # and `store or ChunkStore(...)` would silently split the caller off
        # onto a private store.
        self.store = store if store is not None else ChunkStore(chunk_bytes=chunk_bytes)
        self.template_pool_size = int(template_pool_size)
        self.restore_fn = restore_fn
        self.async_warm = async_warm
        self.pipeline = pipeline
        if self.pipeline is None and self.policy.mode in ("auto", "delta"):
            engine = None
            if self.policy.stream:
                # Default engine: adaptive windowing — window budgets track
                # the measured bottleneck-stage throughput instead of a
                # fixed byte count.  An explicit stream_config is honored
                # verbatim (controlled A/B benchmarks pass fixed budgets).
                engine = ChunkStreamEngine(
                    self.policy.stream_config
                    if self.policy.stream_config is not None
                    else StreamConfig(adaptive=True)
                )
            self.pipeline = DeltaDumpPipeline(
                self.store,
                capacity_frac=self.policy.capacity_frac,
                max_generations=self.policy.max_generations,
                stream=engine,
                fused=self.policy.fused_kernel,
                fused_verify=self.policy.fused_verify,
            )
        # Per-dump adaptive mode selection (dump-worker thread only).
        self.selector = ModeSelector(self.policy)
        self._bind_policy_knobs(self.policy)
        # Degraded-mode state: touched only on the single dump-worker thread.
        self._delta_failures = 0
        self._degraded = False
        self._degraded_skips = 0
        # Supervised single worker, like the paper's GSD dump thread — FIFO
        # ordering preserved (delta chaining depends on it), dead workers
        # respawn with queued dumps intact.
        self._dump_worker = _SupervisedWorker("deltacr-dump")
        self._warm_executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="deltacr-warm")
        self._templates: "OrderedDict[int, ForkableState]" = OrderedDict()
        self._images: Dict[int, Future] = {}        # ckpt_id -> Future[DumpImage]
        self._cancels: Dict[int, threading.Event] = {}   # ckpt_id -> dump cancel
        self._lock = threading.RLock()
        # A KernelError raised by an async warm: held here and re-raised by
        # the next checkpoint(), restore() or wait_dumps() (see _safe_warm)
        self._warm_error: Optional[KernelError] = None
        self._warm_kernel_errors = 0
        # The lifecycle plane: every DumpImage is owned by the refcounted
        # ImageStore — dependents (in-flight child dumps, decodes, forked
        # sandboxes) hold references, and a dropped parent's chunks survive
        # exactly until the last dependent releases.  No wait_dumps()
        # convention anywhere in the reclaim paths.
        self.images = ImageStore(self.store, evict_hook=self._evict_generation)
        self.stats = DeltaCRStats()
        # Verified-read repair: a corrupt stored chunk can be re-derived from
        # any anchored generation grid row that still maps to it.
        self.store.attach_repair_source(self._repair_from_generations)

    # ------------------------------------------------------------- policy
    def _bind_policy_knobs(self, policy: DumpPolicy) -> None:
        """Mirror policy fields onto the historical attribute names — the
        fault-domain machinery (and a lot of external code) reads these."""
        self.dump_mode = policy.mode
        self.dump_retries = policy.retries
        self.retry_backoff_s = policy.retry_backoff_s
        self.dump_deadline_s = policy.deadline_s
        self.delta_fail_threshold = policy.delta_fail_threshold
        self.degraded_probe_every = policy.degraded_probe_every

    def apply_policy(self, policy: DumpPolicy) -> None:
        """Re-point this DeltaCR at a new :class:`DumpPolicy`.

        Selection, retry, deadline, degraded-mode, predictor, and fused-path
        knobs take effect on the next dump (the selector restarts with empty
        calibration).  Pipeline *topology* — stream engine, capacity,
        generation budget — is fixed at construction; changing those fields
        here only affects behavior if a pipeline exists for the new mode.
        """
        if not isinstance(policy, DumpPolicy):
            raise TypeError(f"expected DumpPolicy, got {type(policy).__name__}")
        self.policy = policy
        self.selector = ModeSelector(policy)
        self._bind_policy_knobs(policy)
        if self.pipeline is not None:
            self.pipeline.fused = policy.fused_kernel
            self.pipeline.fused_verify = policy.fused_verify

    @property
    def _dump_executor(self) -> _SupervisedWorker:
        """Legacy alias: tests/benchmarks stall or flush the FIFO dump queue
        by submitting barrier tasks; the supervised worker keeps the same
        submit()/Future interface."""
        return self._dump_worker

    def _evict_generation(self, image_id: int) -> None:
        """ImageStore hook: a dying/dropped image releases its generation
        anchor (the dump fork pinning device memory for O(delta) chaining)."""
        if self.pipeline is not None:
            self.pipeline.evict(image_id)

    # ------------------------------------------------------------- qos gate
    def attach_dump_gate(self, gate: DumpGate) -> None:
        """Install a scheduler-owned QoS gate on the streaming engine.

        Dump windows then pass through the scheduler's bounded-in-flight /
        priority-demotion policy; a no-op when this DeltaCR has no stream
        engine (non-auto dump modes, stream=False)."""
        if self.pipeline is not None and self.pipeline.stream is not None:
            self.pipeline.stream.gate = gate

    def dump_gate(self) -> Optional[DumpGate]:
        if self.pipeline is not None and self.pipeline.stream is not None:
            return self.pipeline.stream.gate
        return None

    # ---------------------------------------------------------- checkpoint
    def checkpoint(
        self,
        state: ForkableState,
        ckpt_id: int,
        parent_ckpt: Optional[int] = None,
        *,
        dump: bool = True,
        priority: str = "bg",
    ) -> None:
        """Fork a template at the quiesce point and submit the async dump.

        Synchronous work is the fork only (the paper's ~9 ms stash fork);
        serialization runs on the background worker, masked by inference.

        Transactional: a template-fork failure raises here with nothing
        registered — no ticket, no template, no dump queued.  A kernel
        failure of an earlier async warm is raised here first.
        """
        self._raise_warm_error()
        faults.fire("template.fork")
        template = state.fork()
        with self._lock:
            if dump:
                # The dump holds its *own* fork: LRU eviction may release the
                # pool template before the background dump runs, and a dump
                # source must survive until serialization completes.
                dump_src = template.fork()
                # The dirty-key hint is only valid relative to the checkpoint
                # it was reset at.  A *branch* dump (parent differs from the
                # session's tracking base, e.g. re-checkpointing from an
                # older tree node) must treat every key as dirty, or clean
                # keys would wrongly re-reference the branch parent's chunks.
                if dirty_base(dump_src) != parent_ckpt:
                    mark_unknown(dump_src)
                # The parent image is resolved *inside* the worker: the dump
                # queue is single-worker FIFO, so the parent dump has always
                # completed by the time this task runs (never blocks).
                parent_fut = self._images.get(parent_ckpt) if parent_ckpt is not None else None
                cancel = threading.Event()
                self._cancels[ckpt_id] = cancel
                ticket = self.images.begin(ckpt_id)
                # The in-flight dump holds a lineage reference on the parent
                # image: the parent checkpoint (template, anchor, chunks) can
                # be reclaimed at any time and this dump still delta-encodes
                # and commits bit-identically; the ref releases on commit,
                # failure, or cancel.
                parent_ref = (
                    self.images.acquire(parent_ckpt)
                    if parent_fut is not None and parent_ckpt is not None
                    else None
                )
                # the worker re-enters the caller's trace context, and its
                # ``dump.queue`` span starts here
                fut = self._dump_worker.submit(
                    self._do_dump, ckpt_id, ticket, dump_src, parent_fut,
                    parent_ref, priority, cancel, (trace.current(), time.perf_counter_ns()),
                )
                fut.add_done_callback(
                    lambda _f, c=ckpt_id: self._cancels.pop(c, None)
                )
                self._images[ckpt_id] = fut
            self._admit_template(ckpt_id, template)
        # The session is now bit-identical to checkpoint ckpt_id: its write
        # tracking restarts, keyed to ckpt_id, so the *next* dump's
        # dirty-key hint is exact iff it dumps against this checkpoint.
        mark_clean(state, ckpt_id)

    def _admit_template(self, ckpt_id: int, template: ForkableState) -> None:
        self._templates[ckpt_id] = template
        self._templates.move_to_end(ckpt_id)
        while len(self._templates) > self.template_pool_size:
            evict_id, evicted = self._templates.popitem(last=False)  # LRU
            evicted.release()
            with self.stats.lock:
                self.stats.evictions += 1

    # ------------------------------------------------------------ dump path
    def _do_dump(
        self,
        ckpt_id: int,
        ticket: DumpTicket,
        dump_src: ForkableState,
        parent_fut: Optional[Future],
        parent_ref,
        priority: str,
        cancel: threading.Event,
        queued: Tuple[Tuple[Optional[int], Optional[int]], int],
    ) -> DumpImage:
        """The dump on the worker; ``queued`` is the submitter's trace
        context and submission time: ``dump.queue`` spans the wait behind
        earlier dumps, ``dump.run`` the dump up to its commit."""
        ctx, t_submit = queued
        with trace.scope(*ctx):
            trace.record("dump.queue", t_submit, ckpt=ckpt_id)
            with trace.span("dump.run", ckpt=ckpt_id):
                try:
                    return self._dump_image(
                        ckpt_id, ticket, dump_src, parent_fut, priority, cancel)
                finally:
                    # lineage ref off: if the parent checkpoint was dropped
                    # while this dump ran, its chunks are returned here, not
                    # before
                    self.images.release(parent_ref)

    def _dump_image(
        self,
        ckpt_id: int,
        ticket: DumpTicket,
        dump_src: ForkableState,
        parent_fut: Optional[Future],
        priority: str,
        cancel: Optional[threading.Event],
    ) -> DumpImage:
        if cancel is not None and cancel.is_set():
            # dropped while still queued: resolve transactionally — release
            # the fork, never materialize a dead image
            dump_src.release()
            self.images.abort(ticket)
            with self.stats.lock:
                self.stats.cancelled_dumps += 1
            raise StreamCancelled(f"checkpoint {ckpt_id}: dump cancelled while queued")
        parent: Optional[DumpImage] = None
        if parent_fut is not None:
            try:
                parent = parent_fut.result(timeout=60.0)  # FIFO: already done
            except Exception:
                parent = None  # parent dump failed: fall back to a full image
        t0 = time.perf_counter()
        bytes_before = self.store.stats.bytes_written
        try:
            out = self._encode_with_recovery(ckpt_id, dump_src, parent, priority, cancel)
        except StreamCancelled:
            # dropped mid-dump (drop_checkpoint): the pipeline already rolled
            # back every chunk reference; the dump fork is all that remains
            dump_src.release()
            self.images.abort(ticket)
            with self.stats.lock:
                self.stats.cancelled_dumps += 1
            raise
        except BaseException:
            # Loud, transactional failure (retries and the legacy fallback
            # exhausted, or an injected WorkerKilled): every encode attempt
            # rolled back its own chunk references — resolve the ticket so
            # no half-image survives, then re-raise to the dump future.
            dump_src.release()
            self.images.abort(ticket)
            with self.stats.lock:
                self.stats.dump_failures += 1
            raise
        entries, dirtied = out.entries, out.dirtied
        mode = out.mode
        anchor_views = out.anchor_views
        clean, kernel, full = out.clean_keys, out.kernel_keys, out.full_keys
        res = out.res
        wall_ms = (time.perf_counter() - t0) * 1e3
        # Measured dirty fraction: chunks actually written over total chunks
        # in the image.  Only meaningful against a parent (a root image
        # writes everything by construction) — the selector's calibration
        # and the prediction-error stats are gated the same way.
        total_chunks = sum(len(m.chunk_ids) for m in entries.values())
        actual_frac = (
            dirtied / total_chunks if (parent is not None and total_chunks) else None
        )
        self.selector.observe(
            mode=mode,
            hint=out.hint_frac,
            actual=actual_frac,
            wall_ms=wall_ms,
            fell_back=out.fell_back,
        )
        image_id = self.images.allocate_image_id()
        image = DumpImage(
            image_id=image_id,
            parent_id=parent.image_id if parent else None,
            entries=entries,
            dirtied_chunks=dirtied,
            dump_bytes=self.store.stats.bytes_written - bytes_before,
            wall_ms=wall_ms,
            mode=mode,
            predicted_dirty_frac=out.pred_frac,
            actual_dirty_frac=actual_frac,
            streamed=bool(res is not None and res.streamed),
            stream_windows=res.windows if res is not None else 0,
            stream_window_bytes=res.window_bytes if res is not None else 0,
            encode_ms=res.encode_ms if res is not None else 0.0,
            drain_ms=res.drain_ms if res is not None else 0.0,
            commit_ms=res.commit_ms if res is not None else 0.0,
            shard_parts=res.shard_parts if res is not None else 0,
        )
        # Ownership transfers to the ImageStore.  When the checkpoint was
        # dropped mid-dump, commit() resolves it transactionally: the image
        # is freed the moment its last dependent releases (possibly now) and
        # no anchor may be registered for it.
        alive = self.images.commit(ticket, image)
        if anchor_views is not None and alive:
            # The dump fork anchors this generation's (lazy) device/host
            # views so the next checkpoint diffs against them in place; the
            # pipeline's LRU releases it.
            assert self.pipeline is not None
            self.pipeline.register(image_id, anchor_views, anchor=dump_src)
            if not self.images.is_live(ckpt_id):
                # dropped between commit and register: never leak the anchor
                self.pipeline.evict(image_id)
        else:
            dump_src.release()
        with self.stats.lock:
            self.stats.dumps += 1
            self.stats.dump_dirty_chunks += dirtied
            self.stats.dump_bytes += image.dump_bytes
            if mode in ("delta", "copy"):
                self.stats.delta_dumps += 1     # dumps through the pipeline
            self.stats.mode_dumps[mode] = self.stats.mode_dumps.get(mode, 0) + 1
            if actual_frac is not None and out.pred_frac is not None:
                self.stats.pred_err_sum += abs(actual_frac - out.pred_frac)
                self.stats.pred_err_n += 1
            self.stats.clean_keys += clean
            self.stats.kernel_keys += kernel
            self.stats.full_keys += full
            if image.streamed:
                self.stats.streamed_dumps += 1
                self.stats.stream_windows += image.stream_windows
            if image.shard_parts:
                self.stats.sharded_dumps += 1
                self.stats.shard_parts += image.shard_parts
        return image

    # ---------------------------------------------------- self-healing encode
    def _encode_with_recovery(
        self,
        ckpt_id: int,
        dump_src: ForkableState,
        parent: Optional[DumpImage],
        priority: str,
        cancel: Optional[threading.Event],
    ) -> _EncodeOutcome:
        """Encode with bounded retries, a per-dump deadline, and graceful
        degradation: primary path (delta pipeline, full-grid copy, or digest)
        first, and after it exhausts its retries the legacy full path — so a
        checkpoint lands unless even full serialization fails, in which case
        the caller aborts the ticket loudly.  A :class:`KernelError` (a
        kernel that does not build or launch) takes neither the retries nor
        the legacy path: it fails the dump at once.  Every failed attempt has
        rolled back its own chunk references before the next one starts.

        Mode ``"auto"`` picks the primary *per dump*: the selector predicts
        the dirty fraction (state hint × calibrated ratio, blended with the
        lineage EWMA) and chooses delta below the crossover, the full-grid
        copy path above it.  An uncalibrated predictor never overrides the
        delta default — the first dumps of a lineage behave exactly like
        forced ``"delta"``, and only observed evidence flips later dumps."""
        deadline = (
            time.monotonic() + self.dump_deadline_s
            if self.dump_deadline_s is not None
            else None
        )
        delta_capable = (
            self.dump_mode in ("auto", "delta")
            and self.pipeline is not None
            and hasattr(dump_src, "delta_generation")
        )
        hint = dirty_fraction_hint(dump_src)
        pred: Optional[float] = None
        if self.dump_mode == "auto":
            if self.policy.predictor and parent is not None:
                # Parent-less dumps write everything regardless of mode —
                # predicting for them would only poison the calibration.
                pred = self.selector.predict(hint)
                choice = self.selector.choose(
                    delta_capable=delta_capable, hint=hint, pred=pred
                )
            else:
                choice = "delta" if delta_capable else "digest"
        elif self.dump_mode == "delta":
            choice = "delta" if delta_capable else "digest"
        elif self.dump_mode == "digest":
            choice = "digest"
        else:
            choice = "legacy"
        primary: Optional[Tuple[str, Callable[[], _EncodeOutcome]]] = None
        if choice in ("delta", "copy"):
            if not self._skip_delta_while_degraded():
                use_base = choice == "delta"
                primary = (
                    choice,
                    lambda: self._delta_attempt(
                        dump_src, parent, priority, cancel, deadline,
                        use_base=use_base,
                    ),
                )
            # else: degraded — go straight to the legacy full path below,
            # probing the pipeline again every degraded_probe_every dumps
        elif choice == "digest":
            primary = (
                "digest",
                lambda: self._digest_attempt(ckpt_id, dump_src, parent, cancel),
            )
        fell_back = False
        if primary is not None:
            what, attempt = primary
            try:
                out = self._retrying(attempt, what=what, deadline=deadline, cancel=cancel)
            except (StreamCancelled, KernelError):
                # a kernel that fails to build or launch is a broken build
                # or device, not a transient fault: never a reason to land
                # the dump on the host's legacy path
                raise
            except Exception as exc:
                if what in ("delta", "copy"):
                    self._note_delta_failure(parent)
                with self.stats.lock:
                    self.stats.fallback_dumps += 1
                last_error = exc
                fell_back = True
            else:
                if what in ("delta", "copy"):
                    self._note_delta_ok()
                out.pred_frac = pred
                out.hint_frac = hint
                return out
        else:
            last_error = None
        # Degradation target: the legacy full path has no device kernels, no
        # stream engine, no delta chain — minimum moving parts.  It ignores
        # the (already blown) deadline: the goal now is to *land*.  If it
        # also fails, raise the legacy error chained on the primary one.
        try:
            out = self._retrying(
                lambda: self._legacy_attempt(ckpt_id, dump_src, parent, cancel),
                what="legacy", deadline=None, cancel=cancel,
            )
        except StreamCancelled:
            raise
        except Exception as exc:
            if last_error is not None:
                raise exc from last_error
            raise
        out.pred_frac = pred
        out.hint_frac = hint
        out.fell_back = fell_back
        return out

    def _retrying(
        self,
        attempt: Callable[[], _EncodeOutcome],
        *,
        what: str,
        deadline: Optional[float],
        cancel: Optional[threading.Event],
    ) -> _EncodeOutcome:
        """Run ``attempt`` up to ``1 + dump_retries`` times with exponential
        backoff.  Each attempt is transactional (rolls back its chunk refs on
        failure), so retrying is always safe.  A blown deadline stops the
        retry loop — the caller degrades instead of burning more wall time."""
        attempts = self.dump_retries + 1
        last: Optional[Exception] = None
        for i in range(attempts):
            if cancel is not None and cancel.is_set():
                raise StreamCancelled(f"dump cancelled before {what} attempt {i + 1}")
            try:
                faults.fire("dump.worker")
                return attempt()
            except (StreamCancelled, KernelError):
                raise
            except Exception as exc:
                last = exc
                if deadline is not None and time.monotonic() >= deadline:
                    with self.stats.lock:
                        self.stats.deadline_trips += 1
                    break
                if i + 1 < attempts:
                    with self.stats.lock:
                        self.stats.dump_retries += 1
                    time.sleep(self.retry_backoff_s * (2 ** i))
        assert last is not None
        raise last

    def _delta_attempt(
        self,
        dump_src: ForkableState,
        parent: Optional[DumpImage],
        priority: str,
        cancel: Optional[threading.Event],
        deadline: Optional[float],
        *,
        use_base: bool = True,
    ) -> _EncodeOutcome:
        gen = dump_src.delta_generation(self.store.chunk_bytes)  # type: ignore[attr-defined]
        deadline_evt: Optional[threading.Event] = None
        timer: Optional[threading.Timer] = None
        eff_cancel: Any = cancel
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DumpTimeout("dump deadline exceeded before delta encode")
            # The deadline rides the stream's transactional cancel plumbing:
            # when the timer fires mid-stream, encode_generation unwinds via
            # StreamCancelled with every chunk reference rolled back, exactly
            # as a user drop would — we just rename the exception.
            deadline_evt = threading.Event()
            timer = threading.Timer(remaining, deadline_evt.set)
            timer.daemon = True
            timer.start()
            eff_cancel = _EitherEvent(cancel, deadline_evt)
        try:
            res = self.pipeline.encode_generation(  # type: ignore[union-attr]
                gen, parent, cancel=eff_cancel, priority=priority,
                use_base=use_base,
            )
        except StreamCancelled:
            if cancel is not None and cancel.is_set():
                raise                      # a real drop: transactional cancel
            if deadline_evt is not None and deadline_evt.is_set():
                raise DumpTimeout(
                    "dump deadline exceeded mid-stream (attempt rolled back)"
                ) from None
            raise
        finally:
            if timer is not None:
                timer.cancel()
        return _EncodeOutcome(
            entries=res.entries,
            dirtied=res.dirtied,
            mode="delta" if use_base else "copy",
            anchor_views=gen.views,
            clean_keys=res.clean_keys,
            kernel_keys=res.kernel_keys,
            full_keys=res.full_keys,
            res=res,
        )

    def _digest_attempt(
        self,
        ckpt_id: int,
        dump_src: ForkableState,
        parent: Optional[DumpImage],
        cancel: Optional[threading.Event],
    ) -> _EncodeOutcome:
        entries: Dict[str, TensorMeta] = {}
        dirtied = 0
        try:
            for name, arr in dump_src.dump_payload().items():
                if cancel is not None and cancel.is_set():
                    raise StreamCancelled(
                        f"checkpoint {ckpt_id}: digest dump cancelled "
                        f"after {len(entries)} tensors"
                    )
                pm = parent.entries.get(name) if parent is not None else None
                meta, n_dirty = digest_encode_array(self.store, arr, pm)
                entries[name] = meta
                dirtied += n_dirty
        except BaseException:
            # transactional: return every chunk reference this attempt took
            # (digest_encode_array rolls back its own partial tensor)
            self.store.decref_many(
                cid for m in entries.values() for cid in m.chunk_ids
            )
            raise
        return _EncodeOutcome(entries=entries, dirtied=dirtied, mode="digest")

    def _legacy_attempt(
        self,
        ckpt_id: int,
        dump_src: ForkableState,
        parent: Optional[DumpImage],
        cancel: Optional[threading.Event],
    ) -> _EncodeOutcome:
        if cancel is not None and cancel.is_set():
            raise StreamCancelled(f"checkpoint {ckpt_id}: legacy dump cancelled")
        entries, dirtied = self._legacy_encode(dump_src.dump_payload(), parent)
        return _EncodeOutcome(entries=entries, dirtied=dirtied, mode="legacy")

    # --------------------------------------------------- degraded-mode state
    # (all three helpers run only on the single dump-worker thread)
    def _skip_delta_while_degraded(self) -> bool:
        if not self._degraded:
            return False
        self._degraded_skips += 1
        if self._degraded_skips % self.degraded_probe_every == 0:
            return False                 # probe: try the delta path again
        with self.stats.lock:
            self.stats.degraded_dumps += 1
        return True

    def _note_delta_ok(self) -> None:
        self._delta_failures = 0
        self._degraded = False
        self._degraded_skips = 0

    def _note_delta_failure(self, parent: Optional[DumpImage]) -> None:
        self._delta_failures += 1
        if self._delta_failures >= self.delta_fail_threshold:
            self._degraded = True
        # The generation this dump diffed against may itself be the poison
        # (a corrupt anchor grid reproduces the failure on every retry):
        # invalidate it so the next delta dump re-bases on a fresh full
        # materialization instead of the suspect anchor.
        if parent is not None and self.pipeline is not None:
            self.pipeline.evict(parent.image_id)

    def _legacy_encode(
        self, payload: Dict[str, np.ndarray], parent: Optional[DumpImage]
    ) -> Tuple[Dict[str, TensorMeta], int]:
        """The seed's O(full state) path: serialize everything, byte-compare
        every chunk against the parent.  Benchmark baseline — and the
        degradation target when the delta/digest paths fail, so it rolls
        back transactionally like every other attempt."""
        entries: Dict[str, TensorMeta] = {}
        dirtied = 0
        cb = self.store.chunk_bytes
        taken: List[int] = []            # every chunk ref this attempt holds
        try:
            for name, arr in payload.items():
                raw = host_bytes(arr).tobytes()
                shape, dtype = tuple(arr.shape), dtype_str(arr.dtype)
                prev_ids: Tuple[int, ...] = ()
                if parent is not None:
                    pm = parent.entries.get(name)
                    if pm is not None and pm.shape == shape and pm.dtype == dtype:
                        prev_ids = pm.chunk_ids
                ids = []
                for idx, off in enumerate(range(0, max(len(raw), 1), cb)):
                    piece = raw[off : off + cb]
                    if idx < len(prev_ids) and self.store.get(prev_ids[idx]) == piece:
                        self.store.incref(prev_ids[idx])
                        ids.append(prev_ids[idx])
                    else:
                        ids.append(self.store.put(piece))
                        dirtied += 1
                    taken.append(ids[-1])
                entries[name] = TensorMeta(shape, dtype, tuple(ids))
        except BaseException:
            self.store.decref_many(taken)
            raise
        return entries, dirtied

    # -------------------------------------------------------------- restore
    def has_template(self, ckpt_id: int) -> bool:
        with self._lock:
            return ckpt_id in self._templates

    def restore(self, ckpt_id: int) -> Tuple[ForkableState, str]:
        """Return a fresh session state for ``ckpt_id``.

        Fast path: fork the live template (O(metadata)).  Slow path: rebuild
        from the dump image — via ``kernels.delta_apply`` over the nearest
        materialized base generation when available — then re-inject the
        rebuilt state as a template so future restores take the fast path.
        A kernel failure of an earlier async warm is raised here first.
        The ``cr.restore`` span names the path; a slow one holds
        ``cr.restore.image_wait`` and ``cr.restore.decode``.
        """
        with trace.span("cr.restore", ckpt=ckpt_id) as sp:
            state, path = self._restore(ckpt_id)
            sp.set(path=path)
            return state, path

    def _restore(self, ckpt_id: int) -> Tuple[ForkableState, str]:
        self._raise_warm_error()
        with self._lock:
            template = self._templates.get(ckpt_id)
            if template is not None:
                self._templates.move_to_end(ckpt_id)  # LRU touch
                faults.fire("template.fork")
                new_state = template.fork()
                with self.stats.lock:
                    self.stats.fast_restores += 1
                # Lineage no longer matches whatever the caller dumps against
                # next; StateManager re-marks clean when it knows the parent.
                mark_unknown(new_state)
                if self.async_warm:
                    self._warm_executor.submit(self._safe_warm, new_state)
                return new_state, "fast"
            fut = self._images.get(ckpt_id)
        if fut is None:
            raise KeyError(f"checkpoint {ckpt_id}: no template and no dump image")
        with trace.span("cr.restore.image_wait", ckpt=ckpt_id):
            image = fut.result()  # may wait for the background dump to land
        if self.restore_fn is None:
            raise RuntimeError("slow-path restore requires restore_fn")
        # Decode under dependent references: a concurrent drop of this
        # checkpoint (or of the delta parent) defers the chunk frees until
        # the decode finishes — never a read from freed storage.
        image_ref = self.images.acquire_image(image.image_id)
        if image_ref is None:
            raise KeyError(f"checkpoint {ckpt_id}: image was dropped")
        parent_ref = self.images.acquire_image(image.parent_id)
        try:
            with trace.span("cr.restore.decode", ckpt=ckpt_id):
                if self.pipeline is not None:
                    parent_image = self.images.get(image.parent_id)
                    payload = self.pipeline.decode(image, parent_image)
                else:
                    payload = {
                        name: read_meta_array(self.store, meta)
                        for name, meta in image.entries.items()
                    }
        finally:
            self.images.release(parent_ref)
            self.images.release(image_ref)
        rebuilt = self.restore_fn(payload)
        mark_unknown(rebuilt)
        with self._lock:
            # Re-inject as template (paper: restored process is frozen and
            # returned to the pool).
            self._admit_template(ckpt_id, rebuilt.fork())
        with self.stats.lock:
            self.stats.slow_restores += 1
        new_state = rebuilt
        if self.async_warm:
            self._warm_executor.submit(self._safe_warm, new_state)
        return new_state, "slow"

    def _safe_warm(self, state: ForkableState) -> None:
        """Run a state's warm on the warm thread.  Warm is best-effort (plain
        CoW stays correct), so its failures are dropped, except a
        :class:`KernelError`: a kernel that does not build or launch is kept
        and re-raised by the next checkpoint(), restore() or wait_dumps(),
        never hidden."""
        try:
            state.warm()
        except KernelError as exc:
            with self._lock:
                self._warm_kernel_errors += 1
                if self._warm_error is None:
                    self._warm_error = exc
        except Exception:
            pass

    def _raise_warm_error(self) -> None:
        with self._lock:
            exc, self._warm_error = self._warm_error, None
        if exc is not None:
            raise exc

    # --------------------------------------------------------------- admin
    def dump_future(self, ckpt_id: int) -> Optional[Future]:
        with self._lock:
            return self._images.get(ckpt_id)

    def wait_dumps(self, timeout: Optional[float] = None) -> None:
        self._raise_warm_error()
        with self._lock:
            futs = list(self._images.values())
        for fut in futs:
            try:
                fut.result(timeout=timeout)
            except StreamCancelled:
                continue            # dropped mid-wait: done by cancellation

    def release_dump_anchor(self, ckpt_id: int) -> bool:
        """Release the pipeline generation anchored by this checkpoint's dump.

        The dump worker retains its fork as the diff/restore base for future
        O(delta) chaining — which also keeps the forked tensors (device
        memory for a CowTensorState) referenced.  A *suspended* session has no upcoming
        child dumps, so the scheduler releases the anchor once the durable
        image has landed: later dumps against this checkpoint fall back to
        the digest/full path and restores decode from store chunks — both
        correct, just not O(delta)-chained."""
        with self._lock:
            fut = self._images.get(ckpt_id)
        if fut is None or self.pipeline is None:
            return False
        try:
            image = fut.result(timeout=60.0)
        except Exception:
            return False
        self.pipeline.evict(image.image_id)
        return True

    def evict_template(self, ckpt_id: int) -> bool:
        with self._lock:
            template = self._templates.pop(ckpt_id, None)
        if template is None:
            return False
        template.release()
        with self.stats.lock:
            self.stats.evictions += 1
        return True

    def drop_checkpoint(self, ckpt_id: int) -> None:
        """Reclaim all storage for a checkpoint (GC of unreachable nodes).

        Entirely non-blocking.  A dump still queued or streaming is
        *cancelled* rather than awaited: the pipeline rolls back every chunk
        reference it took, so dropping a fresh fan-out node costs at most
        one window of wasted work instead of a full dump plus its decref
        walk.  A landed image is handed to the ImageStore: its generation
        anchor is evicted immediately, and its chunks are returned now — or,
        if a dependent child dump is still in flight against it, exactly
        when that dump commits or aborts.  No caller ever needs to
        ``wait_dumps()`` before reclaiming."""
        self.evict_template(ckpt_id)
        with self._lock:
            fut = self._images.pop(ckpt_id, None)
            cancel = self._cancels.pop(ckpt_id, None)
        if cancel is not None and fut is not None and not fut.done():
            cancel.set()
        self.images.drop(ckpt_id)

    def adopt_image(self, ckpt_id: int, image: DumpImage) -> None:
        """Install a recovered durable image for ``ckpt_id`` (restart
        recovery: the persistence plane rebuilt the image's chunk references
        in the store; restores and child dumps then see it exactly like an
        image this process dumped itself)."""
        self.images.adopt(ckpt_id, image)
        fut: Future = Future()
        fut.set_result(image)
        with self._lock:
            self._images[ckpt_id] = fut

    def template_count(self) -> int:
        with self._lock:
            return len(self._templates)

    # ----------------------------------------------------- repair and health
    def _repair_from_generations(self, cid: int, digest: bytes, pad: int) -> Optional[bytes]:
        """ChunkStore repair source: re-derive a corrupt chunk's bytes from
        any anchored generation grid row that still maps to it.

        The anchor grids are independent copies of the tensor bytes (the
        dump fork's pages), so a bit flipped in the store's copy is absent
        there.  Rows are chunk-padded exactly like stored data, so the
        stored digest is recomputable directly; the store re-verifies the
        candidate before healing."""
        if self.pipeline is None:
            return None
        for image_id, name, idx in self.images.find_chunk(cid):
            rec = self.pipeline.record_for(image_id)
            if rec is None:
                continue
            try:
                view = rec.views.get(name)
                if view is None or idx >= view.n_chunks:
                    continue
                row_fn = getattr(view, "row_bytes", None)
                if row_fn is not None:   # sharded view: single-row part fetch
                    row = row_fn(idx)
                    if row is None:
                        continue
                else:
                    row = host_bytes(view.grid[idx]).tobytes()
            except Exception:
                continue        # anchor unreadable: try the next location
            finally:
                self.pipeline.release_record(rec)
            if chunk_digest(row, 0) == digest:
                return row
        return None

    def health(self) -> Dict[str, Any]:
        """One snapshot of the fault-domain state: retry/fallback/deadline
        counters, degraded flag, supervision restarts, and verified-read
        repair stats.  Cheap enough to poll."""
        with self.stats.lock:
            h: Dict[str, Any] = {
                "dumps": self.stats.dumps,
                "dump_retries": self.stats.dump_retries,
                "dump_failures": self.stats.dump_failures,
                "fallback_dumps": self.stats.fallback_dumps,
                "degraded_dumps": self.stats.degraded_dumps,
                "deadline_trips": self.stats.deadline_trips,
                "cancelled_dumps": self.stats.cancelled_dumps,
                # adaptive-mode observability
                "mode_histogram": dict(self.stats.mode_dumps),
                "dirty_pred_mae": (
                    self.stats.pred_err_sum / self.stats.pred_err_n
                    if self.stats.pred_err_n
                    else None
                ),
                "dirty_pred_samples": self.stats.pred_err_n,
                # shard-native dump observability
                "sharded_dumps": self.stats.sharded_dumps,
                "shard_parts": self.stats.shard_parts,
            }
        if self.stats.sharded_dumps:
            # per-rank fetch accounting (process-wide; reported once this
            # engine has run a sharded dump)
            from ..dist import shard_dump as _sd

            h["shards"] = _sd.fetch_stats()
        h["selector"] = self.selector.snapshot()
        if self.pipeline is not None:
            h["fused_checksum_mismatches"] = self.pipeline.fused_checksum_mismatches
        h["degraded"] = self._degraded
        h["warm_kernel_errors"] = self._warm_kernel_errors
        h["worker_deaths"] = self._dump_worker.deaths
        h["worker_restarts"] = self._dump_worker.restarts
        rs = self.store.repair_stats.snapshot()
        h["verified_gets"] = rs.verified_gets
        h["chunk_mismatches"] = rs.mismatches
        h["chunk_repairs"] = rs.repaired
        h["chunk_quarantines"] = rs.quarantined
        h["quarantined_chunks"] = len(self.store.quarantined_ids())
        if self.pipeline is not None and self.pipeline.stream is not None:
            h["drain_pool_restarts"] = self.pipeline.stream.pool_restarts
        return h

    def shutdown(self) -> None:
        self._dump_worker.shutdown(wait=True)
        self._warm_executor.shutdown(wait=True)
        if self.pipeline is not None:
            self.pipeline.shutdown()
