"""Async double-buffered device→host chunk-streaming engine for delta dumps.

The PR-1 pipeline made dump *bytes* O(delta) but still ran the per-tensor
stages — on-device diff, device→host copy, hash + store put — serially on
the dump worker.  This module overlaps them: an encode plan is split into
fixed-byte-budget *windows*, and while window *k* is being copied to the
host and written into the :class:`~repro_torch.core.chunk_store.ChunkStore` on a
background drain thread, the caller thread is already dispatching the
``kernels.delta_encode`` diff (or the host numpy compare) for window *k+1*.
With the default depth of two in-flight windows this is classic ping-pong
staging: dump wall-clock approaches ``max(encode, drain)`` per window
instead of ``encode + drain``.

On the GPU the encode stage is a pure async launch (kernels are queued on
the current CUDA stream) and the encode stage also queues the small
control copies into pinned host memory, so the device never idles waiting
for PCIe.  For host grids the numpy compare and the drain's gather + blake2b + memcpy both spend
their time in GIL-releasing C loops, so the two threads genuinely overlap.

QoS: every window passes through a *gate* before its encode is dispatched.
:class:`DumpGate` bounds the number of in-flight windows (backpressure for
suspend storms) and supports scheduler-driven **priority demotion**: while
the serving scheduler reports runnable sessions, background-priority dump
windows wait (bounded) so dump DMA never head-of-line-blocks decode.  The
scheduler owns the gate and flips ``set_runnable`` per step; dumps with
``priority="fg"`` (a restore blocking on durability) bypass demotion.

Cancellation: a cancel event is checked at window boundaries on both
threads.  The engine reports what completed; the caller (the delta
pipeline) rolls back every chunk reference it acquired, leaving the store
exactly as it was — the transactional-dump property the fault-tolerant
sandboxing line of work motivates.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import faults

__all__ = [
    "ChunkStreamEngine",
    "DumpGate",
    "GateStats",
    "StreamCancelled",
    "StreamConfig",
    "StreamStats",
    "WindowItem",
    "pack_windows",
]


class StreamCancelled(RuntimeError):
    """A streamed dump was cancelled mid-flight and fully rolled back."""


@dataclass
class StreamConfig:
    """Knobs for the streaming engine.

    ``window_bytes`` is the per-window budget of *grid* bytes (the tensor
    bytes the encode stage reads), not the bytes moved — windows are packed
    so each stage does comparable work and the ping-pong stays balanced.
    ``min_windows`` keeps tiny dumps on the synchronous path: below two
    windows there is nothing to overlap and the thread handoff would only
    add latency.  ``drain_workers`` sizes the drain pool: the drain stage is
    dominated by GIL-releasing C loops (blake2b, memcpy, host DMA waits), so
    two workers overlap two windows' hashing on top of overlapping with the
    encode stage; ``max_inflight`` (encode-ahead + draining windows) bounds
    total staging memory at ``max_inflight × window_bytes``.

    **Adaptive windowing** (``adaptive=True``): instead of the fixed byte
    budget, each dump's window size is derived from an EWMA of the
    *measured* bottleneck-stage throughput of previous dumps, targeting
    ``target_window_ms`` of bottleneck work per window — fast hosts get
    bigger windows (less per-window glue), slow or contended hosts get
    smaller ones (finer-grained overlap, bounded staging latency), clamped
    to ``[min_window_bytes, max_window_bytes]``.  The first dump seeds with
    ``window_bytes``.  Windowing only moves stage *boundaries*: streamed
    images stay bit-identical whatever budget is chosen, and the budget a
    dump actually used is reported in :attr:`StreamStats.window_bytes`.
    """

    window_bytes: int = 4 << 20
    max_inflight: int = 3            # staging depth (encode-ahead + drains)
    min_windows: int = 2             # fewer → run synchronously
    drain_workers: int = 2           # parallel window drains (hash/DMA-bound)
    enabled: bool = True
    # -- adaptive windowing ----------------------------------------------
    adaptive: bool = False           # EWMA-sized windows (DeltaCR default: on)
    target_window_ms: float = 8.0    # bottleneck-stage work per window
    min_window_bytes: int = 1 << 20
    max_window_bytes: int = 32 << 20
    ewma_alpha: float = 0.3          # weight of the newest dump's measurement


@dataclass
class StreamStats:
    """Per-dump stage accounting (the fig12 overlap-efficiency numerator)."""

    windows: int = 0
    items: int = 0
    encode_ms: float = 0.0           # caller thread: diff dispatch / compare
    drain_ms: float = 0.0            # drain pool: fetch + copy + hash (pure)
    commit_ms: float = 0.0           # caller thread: store puts + metadata
    wall_ms: float = 0.0
    demoted_windows: int = 0
    window_bytes: int = 0            # the budget this dump's windows used
    shard_items: int = 0             # per-shard part items (sharded dumps)

    @property
    def stage_sum_ms(self) -> float:
        return self.encode_ms + self.drain_ms + self.commit_ms

    @property
    def overlap_efficiency(self) -> float:
        """sum-of-stages over wall: 1.0 = no overlap, >1 = real overlap."""
        return self.stage_sum_ms / self.wall_ms if self.wall_ms > 0 else 1.0

    @property
    def overlap_ms(self) -> float:
        """Wall time hidden by the ping-pong: stage work that ran while
        another stage held the clock.  0 for a fully serial dump."""
        return max(0.0, self.stage_sum_ms - self.wall_ms)


@dataclass
class GateStats:
    acquires: int = 0
    demotions: int = 0               # windows that waited on runnable sessions
    demote_wait_ms: float = 0.0


class DumpGate:
    """Scheduler-driven QoS gate for dump windows.

    Two mechanisms, both per-window:

    * **Bounded in-flight windows** — a semaphore of ``max_inflight`` slots;
      a slot is held from encode dispatch until the drain stage finishes, so
      a suspend storm can queue arbitrarily many dumps without ever holding
      more than ``max_inflight`` windows of staging memory or DMA.
    * **Priority demotion** — while the scheduler has runnable sessions
      (``set_runnable(n > 0)``), background-priority acquires wait up to
      ``demote_max_ms`` (woken early when the count drops to zero), yielding
      the device/host bus to decode.  The wait is bounded, so dumps always
      make progress; foreground acquires skip it entirely.
    """

    def __init__(
        self,
        max_inflight: int = 2,
        *,
        demote_poll_ms: float = 2.0,
        demote_max_ms: float = 50.0,
    ):
        self._slots = threading.BoundedSemaphore(max(1, int(max_inflight)))
        self.max_inflight = max(1, int(max_inflight))
        self.demote_poll_ms = float(demote_poll_ms)
        self.demote_max_ms = float(demote_max_ms)
        self._cv = threading.Condition()
        self._runnable = 0
        self._stats_lock = threading.Lock()
        self.stats = GateStats()

    # -- scheduler side ---------------------------------------------------
    def set_runnable(self, n: int) -> None:
        """Scheduler hint: ``n`` sessions are decode-ready right now."""
        with self._cv:
            self._runnable = int(n)
            if self._runnable == 0:
                self._cv.notify_all()   # promote waiting background windows

    def runnable(self) -> int:
        with self._cv:
            return self._runnable

    # -- dump side --------------------------------------------------------
    def acquire(self, priority: str = "bg") -> None:
        """Block until this window may run.  Demotion happens *before* the
        slot is taken so a demoted background window never starves a
        foreground dump of staging capacity."""
        if priority == "bg":
            t0 = time.monotonic()
            demoted = False
            max_s = self.demote_max_ms / 1e3
            with self._cv:
                while self._runnable > 0:
                    waited = time.monotonic() - t0
                    if waited >= max_s:
                        break
                    demoted = True
                    self._cv.wait(min(self.demote_poll_ms / 1e3, max_s - waited))
            if demoted:
                with self._stats_lock:
                    self.stats.demotions += 1
                    self.stats.demote_wait_ms += (time.monotonic() - t0) * 1e3
        self._slots.acquire()
        with self._stats_lock:
            self.stats.acquires += 1

    def release(self) -> None:
        self._slots.release()


@dataclass
class WindowItem:
    """One tensor's work, split into the three pipeline stages.

    ``encode`` runs on the caller thread (device diff dispatch or host
    compare — the stage that must stay ordered with the generation's device
    program).  ``drain`` runs on the drain pool and receives ``encode``'s
    result (device handles or dirty-row indices); it must be *pure* — fetch,
    copy, hash, no shared-state mutation — so workers spend their time in
    GIL-releasing C loops and never convoy on locks.  ``commit`` runs back
    on the caller thread with ``drain``'s result and performs all store
    mutation; single-threaded commits keep chunk-id assignment deterministic
    and make cancellation rollback trivial.
    """

    key: str
    weight: int
    encode: Callable[[], Any] = field(repr=False)
    drain: Callable[[Any], Any] = field(repr=False)
    commit: Callable[[Any], Any] = field(repr=False)


def pack_windows(items: Sequence[WindowItem], window_bytes: int) -> List[List[WindowItem]]:
    """Greedy in-order packing into windows of ≤ ``window_bytes`` weight.

    Order-preserving so streamed results are deterministic; an oversized
    item gets a window of its own (never split — a tensor's diff is one
    dispatch)."""
    windows: List[List[WindowItem]] = []
    cur: List[WindowItem] = []
    cur_w = 0
    for it in items:
        if cur and cur_w + it.weight > window_bytes:
            windows.append(cur)
            cur, cur_w = [], 0
        cur.append(it)
        cur_w += it.weight
    if cur:
        windows.append(cur)
    return windows


class ChunkStreamEngine:
    """Runs windowed two-stage work with bounded-depth overlap.

    One engine per :class:`DeltaDumpPipeline`; DeltaCR's dump worker stays
    the single producer, so at most one dump streams at a time and its
    windows ping-pong between the encode thread and the small drain pool.
    """

    def __init__(self, config: Optional[StreamConfig] = None, *, gate: Optional[DumpGate] = None):
        self.cfg = config if config is not None else StreamConfig()
        # Externally attachable: the serving scheduler replaces this with its
        # own QoS gate (see Scheduler.__init__).
        self.gate = gate if gate is not None else DumpGate(self.cfg.max_inflight)
        self._drain = self._new_pool()
        self._shut = False
        self.pool_restarts = 0           # drain pools respawned by supervision
        # Cumulative overlap accounting across completed streamed dumps —
        # the double-buffer validation surface: the fused encode path starts
        # its device→host fetches at encode time, so the drain stage's wall
        # should hide behind encode/commit and push aggregate efficiency >1.
        self.dumps_streamed = 0
        self._stage_sum_ms = 0.0
        self._wall_sum_ms = 0.0
        # EWMA of the bottleneck stage's ms-per-MiB over completed dumps;
        # None until the first successful streamed dump seeds it.  Touched
        # only by DeltaCR's single dump worker — no lock needed.
        self._ewma_ms_per_mib: Optional[float] = None

    # ------------------------------------------------------- window budget
    def window_budget(self) -> int:
        """The byte budget the *next* dump's windows will be packed with.

        Fixed ``cfg.window_bytes`` unless adaptive windowing is on and at
        least one dump has been measured, in which case the budget targets
        ``cfg.target_window_ms`` of bottleneck-stage work per window."""
        cfg = self.cfg
        if not cfg.adaptive or self._ewma_ms_per_mib is None:
            return cfg.window_bytes
        budget = int(cfg.target_window_ms / self._ewma_ms_per_mib * (1 << 20))
        return max(cfg.min_window_bytes, min(cfg.max_window_bytes, budget))

    def _observe(self, stats: StreamStats, total_weight: int) -> None:
        """Fold one completed dump's stage timings into the EWMA."""
        if not self.cfg.adaptive or total_weight <= 0:
            return
        bottleneck_ms = max(stats.encode_ms, stats.drain_ms, stats.commit_ms)
        if bottleneck_ms <= 0.0:
            return
        ms_per_mib = bottleneck_ms / (total_weight / (1 << 20))
        if self._ewma_ms_per_mib is None:
            self._ewma_ms_per_mib = ms_per_mib
        else:
            a = self.cfg.ewma_alpha
            self._ewma_ms_per_mib = a * ms_per_mib + (1 - a) * self._ewma_ms_per_mib

    def overlap_efficiency(self) -> float:
        """Aggregate sum-of-stages over wall across completed streamed dumps
        (1.0 = serial, >1 = stages genuinely overlapped).  The fused-path
        double-buffer test asserts on this; health endpoints may poll it."""
        if self._wall_sum_ms <= 0:
            return 1.0
        return self._stage_sum_ms / self._wall_sum_ms

    # ------------------------------------------------------------------ api
    def should_stream(self, items: Sequence[WindowItem]) -> bool:
        # Eligibility uses the FIXED seed budget, not the adaptive one: if a
        # grown adaptive budget could demote dumps to the synchronous path,
        # the EWMA (updated only by streamed dumps) could never shrink back
        # — a one-way ratchet that would permanently disable overlap.
        if not self.cfg.enabled or self._shut or not items:
            return False
        return len(pack_windows(items, self.cfg.window_bytes)) >= self.cfg.min_windows

    def stream(
        self,
        items: Sequence[WindowItem],
        results: Dict[str, Any],
        *,
        cancel: Optional[threading.Event] = None,
        priority: str = "bg",
    ) -> StreamStats:
        """Run all items through encode→drain→commit with windowed overlap.

        The caller thread encodes window *k+1* and commits window *k-1*
        while the drain pool fetches/hashes windows in between; a gate slot
        is held from encode until commit, so at most ``depth`` windows of
        staging bytes are alive.  Committed per-key results land in
        ``results`` (caller-owned, so a failure/cancellation still leaves
        the caller holding everything that committed — required for
        rollback).  Returns stage stats; raises :class:`StreamCancelled` if
        the cancel event tripped (the caller rolls back ``results`` and
        re-raises or recovers).
        """
        budget = self.window_budget()
        total_weight = sum(it.weight for it in items) if self.cfg.adaptive else 0
        if self.cfg.adaptive:
            # floor first, then cap: the min_windows guarantee must win, or
            # an oversized floor could collapse a streamable dump into one
            # window — the degeneration this guard exists to prevent (the
            # EWMA only updates on streamed dumps, so losing the windows
            # would also freeze the budget)
            budget = max(budget, self.cfg.min_window_bytes)
            budget = min(budget, max(1, total_weight // max(self.cfg.min_windows, 1)))
        windows = pack_windows(items, budget)
        stats = StreamStats(
            windows=len(windows),
            items=len(items),
            window_bytes=budget,
            shard_items=sum(1 for it in items if "#shard" in it.key),
        )
        gate = self.gate
        # never dispatch more windows than the gate can admit, or the commit
        # loop could wait on a slot the caller itself is holding
        depth = max(1, min(self.cfg.max_inflight, getattr(gate, "max_inflight", 1 << 30)))
        pending: deque = deque()        # (window, Future) in dispatch order
        t_wall = time.perf_counter()
        cancelled = False
        error: Optional[BaseException] = None
        try:
            for window in windows:
                while len(pending) >= depth and error is None and not cancelled:
                    cancelled = not self._commit_window(pending.popleft(), results, stats, cancel, gate)
                if error is not None or cancelled or (cancel is not None and cancel.is_set()):
                    cancelled = cancelled or (cancel is not None and cancel.is_set())
                    break
                gate_stats = getattr(gate, "stats", None)   # gates are duck-typed
                demote_before = gate_stats.demotions if gate_stats is not None else 0
                gate.acquire(priority)
                if gate_stats is not None:
                    stats.demoted_windows += gate_stats.demotions - demote_before
                try:
                    t0 = time.perf_counter()
                    encoded = [(it, it.encode()) for it in window]
                    stats.encode_ms += (time.perf_counter() - t0) * 1e3
                except BaseException as e:          # encode failed: slot back
                    gate.release()
                    error = e
                    break
                pending.append((window, self._submit_drain(encoded, cancel)))
            while pending and error is None and not cancelled:
                cancelled = not self._commit_window(pending.popleft(), results, stats, cancel, gate)
        except BaseException as e:
            error = error if error is not None else e
        finally:
            # error/cancel path: drain remaining futures and give slots back
            for _window, fut in pending:
                try:
                    fut.result()
                except BaseException as e:
                    error = error if error is not None else e
                gate.release()
            stats.wall_ms = (time.perf_counter() - t_wall) * 1e3
        if error is not None:
            raise error
        if cancelled or (cancel is not None and cancel.is_set()):
            raise StreamCancelled(
                f"dump stream cancelled after {len(results)}/{len(items)} tensors"
            )
        self.dumps_streamed += 1
        self._stage_sum_ms += stats.stage_sum_ms
        self._wall_sum_ms += stats.wall_ms
        self._observe(stats, total_weight)
        return stats

    def _commit_window(self, entry, results, stats, cancel, gate) -> bool:
        """Caller-thread commit of the oldest in-flight window; returns
        False when the cancel event tripped (nothing further is committed)."""
        window, fut = entry
        try:
            drained, drain_ms = fut.result()
            stats.drain_ms += drain_ms
            t0 = time.perf_counter()
            for item, raw in zip(window, drained):
                if cancel is not None and cancel.is_set():
                    return False
                results[item.key] = item.commit(raw)
            stats.commit_ms += (time.perf_counter() - t0) * 1e3
            return len(drained) == len(window)      # short drain = cancelled
        finally:
            gate.release()

    def _new_pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=max(1, self.cfg.drain_workers), thread_name_prefix="stream-drain"
        )

    def _submit_drain(self, encoded, cancel):
        """Supervised submit: a drain pool that died (an injected worker
        kill, an interpreter-level failure that broke the executor) is
        respawned and the window re-submitted — the engine never wedges on a
        dead pool.  Per-window *task* failures still flow through the
        window's future into the caller's transactional error path."""
        try:
            return self._drain.submit(self._drain_window, encoded, cancel)
        except RuntimeError:
            if self._shut:
                raise
            self._drain = self._new_pool()
            self.pool_restarts += 1
            return self._drain.submit(self._drain_window, encoded, cancel)

    @staticmethod
    def _drain_window(encoded, cancel):
        """Drain-pool body: pure per-item fetch/copy/hash, no shared state."""
        # fault seam: an injected drain failure (FaultError or WorkerKilled)
        # surfaces through this window's future and fails the dump
        # transactionally — the caller's rollback + DeltaCR's retry are what
        # get exercised
        faults.fire("stream.drain")
        out = []
        t0 = time.perf_counter()
        for item, enc in encoded:
            if cancel is not None and cancel.is_set():
                break                                # partial window: no commit
            out.append(item.drain(enc))
        return out, (time.perf_counter() - t0) * 1e3

    def shutdown(self) -> None:
        self._shut = True
        self._drain.shutdown(wait=True)
