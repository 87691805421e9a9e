"""Streaming dump engine: window parity vs the synchronous pipeline,
cancellation rollback (transactional dumps), DumpGate QoS semantics, and
scheduler-driven demotion / suspend coalescing."""
import pytest

pytest.importorskip("torch")

import threading
import time

import numpy as np

from repro_torch.core import (
    ChunkStore,
    CowArrayState,
    DeltaCR,
    DumpGate,
    StreamCancelled,
    StreamConfig,
)
from repro_torch.core.stream import ChunkStreamEngine, WindowItem, pack_windows


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _mk_state(seed=0, n_keys=10, elems=16384):
    rng = np.random.default_rng(seed)
    arrays = {f"t{i}": rng.standard_normal(elems).astype(np.float32) for i in range(n_keys)}
    arrays["odd"] = rng.standard_normal(777).astype(np.float32)   # padded tail
    return CowArrayState(arrays)


def _mk_cr(stream: bool, **kw):
    return DeltaCR(
        store=ChunkStore(chunk_bytes=4096),
        restore_fn=_restore,
        chunk_bytes=4096,
        stream=stream,
        stream_config=StreamConfig(window_bytes=24 * 1024, min_windows=2),
        **kw,
    )


def _run_chain(cr, n_ckpts=4, grow=True):
    s = _mk_state(seed=1)
    cr.checkpoint(s, 1, None)
    rng = np.random.default_rng(5)
    for step in range(2, n_ckpts + 1):
        for i in range(0, 10, 2):
            lo = int(rng.integers(0, 16000))
            s.mutate(f"t{i}", lambda a, lo=lo, v=step: a.__setitem__(slice(lo, lo + 64), float(v)))
        s.mutate("odd", lambda a, v=step: a.__setitem__(slice(0, 8), float(v)))
        if grow and step == 3:  # window-boundary class: a tensor grows rows
            s.set("t1", rng.standard_normal(20000).astype(np.float32))
        cr.checkpoint(s, step, step - 1)
    cr.wait_dumps()
    return s


def _entry_fingerprint(cr, ckpt):
    image = cr.dump_future(ckpt).result()
    out = {}
    for name, meta in image.entries.items():
        chunks = tuple(cr.store.get(cid) for cid in meta.chunk_ids)
        out[name] = (meta.shape, meta.dtype, meta.trailing_pad, meta.digests, chunks)
    return out, image


# ---------------------------------------------------------------------------
# window parity vs the synchronous pipeline
# ---------------------------------------------------------------------------


def test_streamed_images_identical_to_sync():
    """Every checkpoint's TensorMeta set (shapes, digests, pads, raw chunk
    bytes) must be bit-identical whether the dump streamed or ran
    synchronously — window boundaries are invisible in the image."""
    cr_sync = _mk_cr(stream=False)
    cr_str = _mk_cr(stream=True)
    _run_chain(cr_sync)
    _run_chain(cr_str)
    streamed_any = False
    for ckpt in range(1, 5):
        fp_sync, img_sync = _entry_fingerprint(cr_sync, ckpt)
        fp_str, img_str = _entry_fingerprint(cr_str, ckpt)
        assert not img_sync.streamed
        streamed_any = streamed_any or img_str.streamed
        assert fp_sync == fp_str
        assert img_sync.dirtied_chunks == img_str.dirtied_chunks
    assert streamed_any, "window config should have engaged the stream engine"
    assert cr_str.store.stats.bytes_written == cr_sync.store.stats.bytes_written
    assert cr_str.stats.streamed_dumps >= 1
    cr_sync.shutdown()
    cr_str.shutdown()


def test_adaptive_windowing_images_identical_to_sync():
    """EWMA-sized windows only move stage boundaries: images must stay
    bit-identical to the synchronous pipeline, dump for dump."""
    cr_sync = _mk_cr(stream=False)
    cr_adapt = DeltaCR(
        store=ChunkStore(chunk_bytes=4096),
        restore_fn=_restore,
        chunk_bytes=4096,
        stream=True,
        stream_config=StreamConfig(
            window_bytes=24 * 1024,
            min_windows=2,
            adaptive=True,
            target_window_ms=0.05,      # tiny target: forces real adaptation
            min_window_bytes=8 * 1024,
            max_window_bytes=1 << 20,
        ),
    )
    _run_chain(cr_sync)
    _run_chain(cr_adapt)
    for ckpt in range(1, 5):
        fp_sync, _ = _entry_fingerprint(cr_sync, ckpt)
        fp_adapt, _ = _entry_fingerprint(cr_adapt, ckpt)
        assert fp_sync == fp_adapt
    assert cr_adapt.store.stats.bytes_written == cr_sync.store.stats.bytes_written
    cr_sync.shutdown()
    cr_adapt.shutdown()


def test_adaptive_windowing_tracks_measured_rate():
    """The engine's window budget follows the EWMA of the bottleneck-stage
    throughput, clamped to the configured bounds, and every streamed dump
    reports the budget it actually used."""
    cfg = StreamConfig(
        window_bytes=64 * 1024,
        adaptive=True,
        target_window_ms=4.0,
        min_window_bytes=16 * 1024,
        max_window_bytes=256 * 1024,
        ewma_alpha=0.5,
        min_windows=1,
    )
    eng = ChunkStreamEngine(cfg)
    assert eng.window_budget() == cfg.window_bytes        # unseeded: fixed seed

    def mk_items(n):
        # the drain does a measurable slice of real work so the EWMA sees a
        # nonzero bottleneck-stage time
        return [
            WindowItem(key=f"k{i}", weight=32 * 1024,
                       encode=lambda: None,
                       drain=lambda e: sum(range(20_000)),
                       commit=lambda d: d)
            for i in range(n)
        ]

    out = {}
    stats = eng.stream(mk_items(8), out)
    assert stats.window_bytes == cfg.window_bytes          # first dump: seed budget
    assert eng._ewma_ms_per_mib is not None and eng._ewma_ms_per_mib > 0
    budget = eng.window_budget()
    assert cfg.min_window_bytes <= budget <= cfg.max_window_bytes
    # a fast workload (near-zero stage times) drives the budget to the clamp
    stats2 = eng.stream(mk_items(8), {})
    assert stats2.window_bytes == budget                   # reported = used
    assert eng.window_budget() <= cfg.max_window_bytes
    # stats stay observable through DeltaCR images as well
    eng.shutdown()

    cr = DeltaCR(
        store=ChunkStore(chunk_bytes=4096),
        restore_fn=_restore,
        chunk_bytes=4096,
        stream=True,
        stream_config=StreamConfig(window_bytes=24 * 1024, min_windows=2, adaptive=True),
    )
    _run_chain(cr)
    streamed = [cr.dump_future(c).result() for c in range(1, 5)]
    assert any(img.streamed and img.stream_window_bytes > 0 for img in streamed)
    cr.shutdown()


def test_fixed_windowing_budget_is_constant():
    cfg = StreamConfig(window_bytes=32 * 1024, adaptive=False, min_windows=1)
    eng = ChunkStreamEngine(cfg)
    items = [
        WindowItem(key=f"k{i}", weight=16 * 1024,
                   encode=lambda: None, drain=lambda e: e, commit=lambda d: d)
        for i in range(6)
    ]
    eng.stream(items, {})
    assert eng.window_budget() == cfg.window_bytes         # no drift when fixed
    eng.shutdown()


def test_streamed_slow_restore_roundtrip():
    cr = _mk_cr(stream=True, template_pool_size=1)
    s = _run_chain(cr)
    want = {k: s.get(k).copy() for k in s.keys()}
    for ckpt in list(cr._templates):
        cr.evict_template(ckpt)
    restored, path = cr.restore(4)
    assert path == "slow"
    for k in want:
        np.testing.assert_array_equal(restored.get(k), want[k])
    cr.shutdown()


def test_tiny_dumps_stay_synchronous():
    """Below min_windows the stream engine must not engage (thread handoff
    would only add latency to a millisecond dump)."""
    cr = DeltaCR(store=ChunkStore(chunk_bytes=4096), restore_fn=_restore, chunk_bytes=4096)
    s = CowArrayState({"x": np.zeros(2048, np.float32)})
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    assert not cr.dump_future(1).result().streamed
    cr.shutdown()


def test_device_grid_streaming_parity():
    """The TPU-shaped path: device-backed grids stream through the
    delta_encode dispatch → async fetch → commit stages and produce the
    same image as the synchronous run (including a capacity overflow that
    downgrades to the full path inside drain)."""
    import jax.numpy as jnp

    from repro_torch.core import DeltaDumpPipeline
    from repro_torch.core.delta_pipeline import ChunkedView, DeltaGeneration
    from repro_torch.core.stream import ChunkStreamEngine

    n, cb = 16, 256
    def dev_view(arr):
        grid = jnp.asarray(arr.reshape(n, cb))
        return ChunkedView(
            shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes,
            chunk_bytes=cb, n_chunks=n, trailing_pad=0, grid_fn=lambda g=grid: g,
        )

    def gen_pair(seed, overflow_key=None):
        rng = np.random.default_rng(seed)
        bases, nexts = {}, {}
        for i in range(6):
            base = rng.integers(0, 255, size=n * cb, dtype=np.uint8)
            nxt = base.copy()
            if f"x{i}" == overflow_key:
                nxt[: 12 * cb] = 9          # 12 dirty > capacity 4
            else:
                nxt[: 2 * cb] = 7           # 2 dirty <= capacity
            bases[f"x{i}"] = base
            nexts[f"x{i}"] = nxt
        return bases, nexts

    def run(streamed):
        store = ChunkStore(chunk_bytes=cb)
        engine = None
        if streamed:
            from repro_torch.core import StreamConfig
            engine = ChunkStreamEngine(StreamConfig(window_bytes=2 * n * cb, min_windows=2))
        pipe = DeltaDumpPipeline(store, capacity_frac=0.25, stream=engine)
        bases, nexts = gen_pair(3, overflow_key="x2")
        res1 = pipe.encode_generation(
            DeltaGeneration(views={k: dev_view(v) for k, v in bases.items()}), None
        )

        class _Img:
            image_id = 1
            entries = res1.entries

        pipe.register(1, {k: dev_view(v) for k, v in bases.items()}, anchor=None)
        res2 = pipe.encode_generation(
            DeltaGeneration(views={k: dev_view(v) for k, v in nexts.items()}), _Img
        )
        payloads = {
            k: store.get_array(m.chunk_ids, m.shape, np.uint8)
            for k, m in res2.entries.items()
        }
        out = (res2.streamed, res2.kernel_keys, res2.full_keys, res2.dirtied, payloads, nexts)
        if engine is not None:
            engine.shutdown()
        return out

    s_str, k_str, f_str, d_str, pl_str, want = run(True)
    s_syn, k_syn, f_syn, d_syn, pl_syn, _ = run(False)
    assert s_str and not s_syn
    assert (k_str, f_str, d_str) == (k_syn, f_syn, d_syn)
    assert f_str == 1                       # the overflow key went full-grid
    for k in want:
        np.testing.assert_array_equal(pl_str[k], want[k])
        np.testing.assert_array_equal(pl_syn[k], want[k])


def test_pack_windows_order_and_budget():
    items = [WindowItem(key=f"k{i}", weight=w, encode=lambda: None,
                        drain=lambda e: None, commit=lambda r: None)
             for i, w in enumerate([10, 10, 25, 100, 5, 5])]
    windows = pack_windows(items, 30)
    assert [[it.key for it in w] for w in windows] == [
        ["k0", "k1"], ["k2"], ["k3"], ["k4", "k5"]]
    assert [it.key for w in windows for it in w] == [it.key for it in items]


# ---------------------------------------------------------------------------
# cancellation: transactional rollback
# ---------------------------------------------------------------------------


class _CancelAfter:
    """Gate shim that trips a cancel event after N window acquires."""

    def __init__(self, cancel: threading.Event, after: int):
        self.cancel = cancel
        self.after = after
        self.count = 0

    def acquire(self, priority="bg"):
        self.count += 1
        if self.count > self.after:
            self.cancel.set()

    def release(self):
        pass


def test_cancel_mid_stream_leaves_store_consistent():
    """A cancelled dump must roll back every chunk reference it took —
    puts, dedupe hits AND clean-key/parent increfs — leaving the store
    byte-identical to its pre-dump state."""
    cr = _mk_cr(stream=True)
    s = _mk_state(seed=2)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    parent = cr.dump_future(1).result()

    # second generation: a few dirty keys, the rest clean (hint-driven)
    s2 = s.fork()
    s2.reset_dirty_tracking(1)
    for i in range(0, 6):
        s2.mutate(f"t{i}", lambda a, i=i: a.__setitem__(slice(0, 128), float(i + 40)))
    gen = s2.delta_generation(cr.store.chunk_bytes)

    snap = cr.store.stats.snapshot()
    cancel = threading.Event()
    engine = cr.pipeline.stream
    old_gate = engine.gate
    engine.gate = _CancelAfter(cancel, after=1)
    try:
        with pytest.raises(StreamCancelled):
            cr.pipeline.encode_generation(gen, parent, cancel=cancel)
    finally:
        engine.gate = old_gate
    after = cr.store.stats.snapshot()
    assert after.chunks_alive == snap.chunks_alive
    assert after.physical_bytes == snap.physical_bytes
    assert after.logical_bytes == snap.logical_bytes
    # the parent image must still decode exactly (its refs were untouched)
    for name, meta in parent.entries.items():
        got = cr.store.get_array(meta.chunk_ids, meta.shape, np.dtype(meta.dtype))
        np.testing.assert_array_equal(got, s.get(name))
    # and a fresh (uncancelled) dump of the same generation still works
    res = cr.pipeline.encode_generation(gen, parent)
    assert set(res.entries) == set(parent.entries)
    cr.pipeline._rollback(res.entries)   # drop the manual image's refs
    cr.shutdown()


def test_drop_checkpoint_cancels_queued_dump():
    """Dropping a checkpoint whose dump has not run yet cancels it: the
    worker rolls back instead of dumping a dead node, and the store ends
    byte-identical to before the checkpoint."""
    cr = _mk_cr(stream=True)
    s = _mk_state(seed=6)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    snap = cr.store.stats.snapshot()
    # stall the dump worker so ckpt 2's dump is still queued when dropped
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    s.mutate("t0", lambda a: a.__setitem__(slice(0, 64), 5.0))
    cr.checkpoint(s, 2, 1)
    # drop_checkpoint is non-blocking: it flags the cancel and returns
    # immediately; unstall the worker and drain the FIFO to observe the
    # (pre-cancelled) dump resolve transactionally
    cr.drop_checkpoint(2)
    gate.set()
    cr._dump_executor.submit(lambda: None).result(timeout=30)
    after = cr.store.stats.snapshot()
    assert cr.stats.cancelled_dumps == 1
    assert after.chunks_alive == snap.chunks_alive
    assert after.physical_bytes == snap.physical_bytes
    assert after.logical_bytes == snap.logical_bytes
    # the dropped ckpt is gone; ckpt 1 still restores
    with pytest.raises(KeyError):
        cr.restore(2)
    restored, _ = cr.restore(1)
    np.testing.assert_array_equal(restored.get("t1"), s.get("t1"))
    cr.shutdown()


def test_cancel_before_start_rolls_back_sync_path_too():
    cr = _mk_cr(stream=False)
    s = _mk_state(seed=3)
    gen = s.delta_generation(cr.store.chunk_bytes)
    snap = cr.store.stats.snapshot()
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(StreamCancelled):
        cr.pipeline.encode_generation(gen, None, cancel=cancel)
    after = cr.store.stats.snapshot()
    assert (after.chunks_alive, after.physical_bytes) == (snap.chunks_alive, snap.physical_bytes)
    cr.shutdown()


# ---------------------------------------------------------------------------
# DumpGate QoS semantics
# ---------------------------------------------------------------------------


def test_gate_demotes_bg_while_runnable():
    gate = DumpGate(max_inflight=2, demote_poll_ms=1.0, demote_max_ms=15.0)
    gate.set_runnable(3)
    t0 = time.perf_counter()
    gate.acquire("bg")
    waited_ms = (time.perf_counter() - t0) * 1e3
    assert gate.stats.demotions == 1
    assert waited_ms >= 5.0, "bg window should have waited for the demotion bound"
    # foreground dumps bypass demotion entirely
    t0 = time.perf_counter()
    gate.acquire("fg")
    assert (time.perf_counter() - t0) * 1e3 < 10.0
    assert gate.stats.demotions == 1
    gate.release()
    gate.release()


def test_gate_promotes_when_scheduler_runs_dry():
    gate = DumpGate(max_inflight=1, demote_poll_ms=2.0, demote_max_ms=5000.0)
    gate.set_runnable(2)
    done = threading.Event()

    def worker():
        gate.acquire("bg")
        gate.release()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.02)
    assert not done.is_set(), "bg acquire should be demoted while runnable>0"
    gate.set_runnable(0)                       # promote: wakes the waiter
    assert done.wait(2.0)
    t.join()
    assert gate.stats.demotions == 1


def test_gate_bounds_inflight_windows():
    gate = DumpGate(max_inflight=2)
    gate.acquire("fg")
    gate.acquire("fg")
    blocked = threading.Event()
    got = threading.Event()

    def third():
        blocked.set()
        gate.acquire("fg")
        got.set()

    t = threading.Thread(target=third)
    t.start()
    blocked.wait(1.0)
    time.sleep(0.02)
    assert not got.is_set(), "third window must wait for a free slot"
    gate.release()
    assert got.wait(2.0)
    t.join()
    gate.release()
    gate.release()


# ---------------------------------------------------------------------------
# scheduler wiring: demotion + suspend coalescing (no model needed)
# ---------------------------------------------------------------------------

_PAGES_PER_SESSION = 2


class _FakePool:
    def __init__(self, total):
        self.total = total
        self.used = 0
        self.lock = threading.Lock()

    def free_pages(self):
        with self.lock:
            return self.total - self.used


class _Cell:
    def __init__(self, pool):
        self.pool = pool
        self.refs = 0
        self.lock = threading.Lock()

    def incref(self):
        with self.lock:
            if self.refs == 0:
                with self.pool.lock:
                    self.pool.used += _PAGES_PER_SESSION
            self.refs += 1

    def decref(self):
        with self.lock:
            self.refs -= 1
            if self.refs == 0:
                with self.pool.lock:
                    self.pool.used -= _PAGES_PER_SESSION


class _FakeSession:
    """ForkableState + DeltaEncodable wrapper with page accounting: forks
    share the page cell (CoW), the last release returns the pages."""

    def __init__(self, pool, inner, cell=None):
        self._inner = inner
        self._cell = cell if cell is not None else _Cell(pool)
        self._cell.incref()
        self.tokens = []

    def fork(self):
        return _FakeSession(None, self._inner.fork(), self._cell)

    def release(self):
        self._inner.release()
        self._cell.decref()

    def warm(self):
        self._inner.warm()

    def dump_payload(self):
        return self._inner.dump_payload()

    def delta_generation(self, chunk_bytes):
        return self._inner.delta_generation(chunk_bytes)

    def reset_dirty_tracking(self, base=None):
        self._inner.reset_dirty_tracking(base)

    def invalidate_dirty_tracking(self):
        self._inner.invalidate_dirty_tracking()

    def dirty_tracking_base(self):
        return self._inner.dirty_tracking_base()

    def mutate(self, *a, **kw):
        self._inner.mutate(*a, **kw)


class _FakeEngine:
    def __init__(self, pool):
        self.pool = pool
        self._n = 0

    def new_session(self, prompt, sampling):
        rng = np.random.default_rng(len(prompt) + self._n)
        self._n += 1
        inner = CowArrayState(
            {f"t{i}": rng.standard_normal(16384).astype(np.float32) for i in range(8)}
        )
        return _FakeSession(self.pool, inner)

    def step(self, sessions):
        for i, s in enumerate(sessions):
            s.mutate("t0", lambda a, i=i: a.__setitem__(slice(0, 16), float(i)))
        return [0] * len(sessions)


def _mk_sched(cfg=None, pool_pages=64):
    from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

    pool = _FakePool(pool_pages)
    eng = _FakeEngine(pool)
    cr = DeltaCR(
        store=ChunkStore(chunk_bytes=4096),
        restore_fn=lambda p: _FakeSession(pool, _restore(p)),
        chunk_bytes=4096,
        stream_config=StreamConfig(window_bytes=24 * 1024, min_windows=2),
    )
    cfg = cfg if cfg is not None else SchedulerConfig(
        dump_demote_poll_ms=1.0, dump_demote_max_ms=10.0
    )
    return Scheduler(eng, cr, cfg), cr, pool


def test_scheduler_config_not_shared_between_instances():
    from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

    s1, cr1, _ = _mk_sched()
    s2, cr2, _ = _mk_sched()
    assert s1.cfg is not s2.cfg                  # regression: shared default
    s1.cfg.max_batch = 99
    assert s2.cfg.max_batch != 99
    assert SchedulerConfig().max_batch != 99
    cr1.shutdown()
    cr2.shutdown()


def test_scheduler_demotes_dumps_while_sessions_runnable():
    sched, cr, pool = _mk_sched()
    assert sched.gate is cr.dump_gate(), "scheduler gate must be installed on DeltaCR"
    sids = [sched.submit([1, 2, 3]) for _ in range(3)]
    assert sched.step()                          # runnable hint -> 3
    assert sched.gate.runnable() == 3
    sched.suspend(sids[0])                       # bg dump: windows demote
    cr.wait_dumps()
    assert sched.gate.stats.demotions >= 1
    img = cr.dump_future(sched.handles[sids[0]].ckpt_id).result()
    assert img.streamed and img.mode == "delta"
    # scheduler runs dry -> hint clears, later dumps aren't demoted
    for sid in sids[1:]:
        sched.suspend(sid)
    assert sched.step() == {}
    assert sched.gate.runnable() == 0
    cr.shutdown()


def test_suspend_storm_coalesces_and_drains():
    sched, cr, pool = _mk_sched()
    sids = [sched.submit([1, 2, 3]) for _ in range(4)]
    sched.step()
    free_before_storm = pool.free_pages()
    # stall the dump worker so the storm provably doesn't block on dumps
    release = threading.Event()
    cr._dump_executor.submit(release.wait)
    t0 = time.perf_counter()
    sched.suspend_many(sids[:3])
    storm_ms = (time.perf_counter() - t0) * 1e3
    assert storm_ms < 1000.0                     # never waited on the stalled worker
    assert all(sched.handles[s].state == "suspended" for s in sids[:3])
    assert len(sched._pending_evict) == 3        # evictions deferred
    for sid in sids[:3]:                         # templates still resident
        assert cr.has_template(sched.handles[sid].ckpt_id)
    release.set()
    cr.wait_dumps()
    sched.step()                                 # drain: evict + free pages
    assert sched._pending_evict == []
    for sid in sids[:3]:
        assert not cr.has_template(sched.handles[sid].ckpt_id)
    assert pool.free_pages() == free_before_storm + 3 * _PAGES_PER_SESSION
    # suspended sessions restore exactly (slow path: template was evicted)
    sched.resume(sids[0])
    assert sched.handles[sids[0]].state == "active"
    cr.shutdown()


def test_checkpoint_burst_fanout():
    from repro_torch.search.fanout import checkpoint_burst

    cr = _mk_cr(stream=True)
    template = _mk_state(seed=7)
    cr.checkpoint(template, 1, None)
    children = [template.fork() for _ in range(4)]
    for i, c in enumerate(children):
        c.mutate("t0", lambda a, i=i: a.__setitem__(slice(0, 32), float(i)))
    futs, submit_ms = checkpoint_burst(cr, children, [10, 11, 12, 13], 1, wait=True)
    assert len(futs) == 4
    for i, fut in enumerate(futs):
        img = fut.result()
        assert img.mode == "delta"
        got = cr.store.get_array(
            img.entries["t0"].chunk_ids,
            img.entries["t0"].shape,
            np.dtype(img.entries["t0"].dtype),
        )
        assert got[0] == float(i)
    cr.shutdown()
