"""ImageStore lifecycle plane: refcounted image lineage, reclaim-while-dump-
in-flight (no wait_dumps convention), transactional dump cancellation."""
import pytest

pytest.importorskip("torch")

import inspect
import threading
import time

import numpy as np

from repro_torch.core import (
    ChunkStore,
    CowArrayState,
    DeltaCR,
    DeltaFS,
    Sandbox,
    SandboxTree,
    StateManager,
    StreamConfig,
    reachability_gc,
)
from repro_torch.core import sandbox_tree as sandbox_tree_mod
from repro_torch.core import state_manager as state_manager_mod
from repro_torch.core.image_store import ImageStore
from repro_torch.core.stream import ChunkStreamEngine


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _mk_state(seed=0, n_keys=8, elems=8192):
    rng = np.random.default_rng(seed)
    arrays = {f"t{i}": rng.standard_normal(elems).astype(np.float32) for i in range(n_keys)}
    return CowArrayState(arrays)


def _mk_cr(**kw):
    return DeltaCR(
        store=ChunkStore(chunk_bytes=4096),
        restore_fn=_restore,
        chunk_bytes=4096,
        **kw,
    )


def _drain(cr):
    """Wait for the dump FIFO to go idle without touching futures."""
    cr._dump_executor.submit(lambda: None).result(timeout=60)


# ---------------------------------------------------------------------------
# the tentpole: parent reclaim while a dependent child dump is in flight
# ---------------------------------------------------------------------------

def test_parent_reclaim_during_inflight_child_dump_bit_identical():
    """Drop the parent checkpoint (image + template) while the child's delta
    dump is still queued: the dump's lineage ref keeps the parent's chunks
    alive, the child commits, and its restore is bit-identical — no
    wait_dumps() anywhere."""
    cr = _mk_cr(template_pool_size=1)
    s = _mk_state(seed=1)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    parent_image = cr.images.image_for(1)
    assert parent_image is not None
    parent_chunks = [
        cid for meta in parent_image.entries.values() for cid in meta.chunk_ids
    ]
    # mutate a slice of one tensor; the child dump deltas against ckpt 1
    s.mutate("t0", lambda a: a.__setitem__(slice(0, 256), 3.25))
    expect = {k: s.get(k).copy() for k in s.keys()}
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)          # stall: child dump stays queued
    cr.checkpoint(s, 2, 1)
    t0 = time.perf_counter()
    cr.drop_checkpoint(1)                        # reclaim the parent NOW
    drop_ms = (time.perf_counter() - t0) * 1e3
    assert drop_ms < 1000.0                      # non-blocking (no dump wait)
    assert not cr.has_template(1)
    # the parent's image is deregistered but its chunks are pinned by the
    # in-flight dump's lineage reference
    assert not cr.images.is_live(1)
    assert cr.images.deferred_count() == 1
    for cid in parent_chunks:
        assert cid in cr.store
    gate.set()
    _drain(cr)
    # the child dump committed as a delta against the (dropped) parent
    child = cr.images.image_for(2)
    assert child is not None and child.mode == "delta"
    # parent's deferred free resolved: chunks only the parent held are gone
    assert cr.images.deferred_count() == 0
    cr.images.debug_validate()
    # restore is bit-identical, and every chunk digest verifies
    cr.evict_template(2)                         # force the slow path
    restored, path = cr.restore(2)
    assert path == "slow"
    for key, want in expect.items():
        np.testing.assert_array_equal(restored.get(key), want)
    for meta in child.entries.items():
        name, m = meta
        if m.digests:
            for cid, d in zip(m.chunk_ids, m.digests):
                assert cr.store.digest_of(cid) == d
    cr.shutdown()


def test_parent_chunks_freed_after_dependent_commits():
    """Once the dependent dump lands, the dropped parent's exclusive chunks
    are returned — deferred, not leaked."""
    cr = _mk_cr(template_pool_size=1)
    s = _mk_state(seed=2, n_keys=4)
    baseline = cr.store.stats.snapshot()
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    s.mutate("t1", lambda a: a.__setitem__(slice(0, 128), -1.0))
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    cr.checkpoint(s, 2, 1)
    cr.drop_checkpoint(1)
    gate.set()
    _drain(cr)
    # drop the child too: the store returns to its pre-checkpoint baseline
    cr.drop_checkpoint(2)
    assert cr.store.stats.chunks_alive == baseline.chunks_alive
    assert cr.store.stats.physical_bytes == baseline.physical_bytes
    cr.shutdown()


def test_state_manager_reclaim_mid_dump_via_tree():
    """The same invariant through the StateManager/SandboxTree reclaim path:
    GC a parent node while its child's dump is queued."""
    fs = DeltaFS(chunk_bytes=512)
    fs.write("repo/a", np.arange(512, dtype=np.int32))
    proc = CowArrayState({"heap": np.zeros(256, np.float32)})
    cr = DeltaCR(store=fs.store, restore_fn=_restore, template_pool_size=8)
    sm = StateManager(Sandbox(fs, proc), cr)
    c1 = sm.checkpoint()
    cr.wait_dumps()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 9.0))
    sm.sandbox.fs.write("repo/a", np.arange(512, dtype=np.int32) * 2)
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    c2 = sm.checkpoint()                 # child dump queued behind the stall
    sm.node(c1).terminal = True          # make c1 unreachable for GC
    sm.node(c1).expandable = False
    stats = {}
    reclaimed = reachability_gc(sm, keep_terminal_candidates=False, stats_out=stats)
    assert c1 in reclaimed
    assert stats["deferred_images"] == 1
    gate.set()
    _drain(cr)
    heap_now = sm.sandbox.proc.get("heap").copy()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(1, -5.0))
    assert sm.restore(c2) in ("fast", "slow")
    np.testing.assert_array_equal(sm.sandbox.proc.get("heap"), heap_now)
    np.testing.assert_array_equal(
        sm.sandbox.fs.read("repo/a"), np.arange(512, dtype=np.int32) * 2
    )
    cr.shutdown()


def test_no_wait_dumps_in_reclaim_sources():
    """The acceptance criterion, encoded: no wait_dumps() call anywhere in
    the StateManager or SandboxTree sources (docstrings may describe the
    retired convention)."""
    assert ".wait_dumps(" not in inspect.getsource(state_manager_mod)
    assert ".wait_dumps(" not in inspect.getsource(sandbox_tree_mod)


# ---------------------------------------------------------------------------
# satellite: drop_checkpoint cancels queued/mid-stream dumps transactionally
# ---------------------------------------------------------------------------

class _SlowDrainEngine(ChunkStreamEngine):
    """Fake-slow drain stage: signals when the first window drains, then
    holds every drain until released — a dump is reliably mid-stream."""

    def __init__(self, config):
        super().__init__(config)
        self.started = threading.Event()
        self.release = threading.Event()

    def _drain_window(self, encoded, cancel):  # type: ignore[override]
        self.started.set()
        self.release.wait(timeout=30)
        return ChunkStreamEngine._drain_window(encoded, cancel)


def test_drop_cancels_mid_stream_dump_with_slow_drain():
    """Regression (ROADMAP item): dropping a checkpoint whose dump is
    mid-stream cancels via the transactional StreamCancelled rollback
    instead of completing into a dead image."""
    from repro_torch.core.delta_pipeline import DeltaDumpPipeline

    store = ChunkStore(chunk_bytes=4096)
    engine = _SlowDrainEngine(StreamConfig(window_bytes=16 * 1024, min_windows=2))
    pipeline = DeltaDumpPipeline(store, stream=engine)
    cr = DeltaCR(store=store, restore_fn=_restore, pipeline=pipeline)
    s = _mk_state(seed=3, n_keys=12, elems=4096)
    snap = store.stats.snapshot()
    cr.checkpoint(s, 1, None)
    assert engine.started.wait(timeout=30)       # dump is mid-stream
    cr.drop_checkpoint(1)                        # returns immediately
    engine.release.set()
    _drain(cr)
    assert cr.stats.cancelled_dumps == 1
    # transactional: the store is byte-identical to before the dump
    assert store.stats.chunks_alive == snap.chunks_alive
    assert store.stats.physical_bytes == snap.physical_bytes
    assert store.stats.logical_bytes == snap.logical_bytes
    assert cr.images.image_for(1) is None
    with pytest.raises(KeyError):
        cr.restore(1)
    cr.shutdown()


def test_drop_cancels_queued_digest_dump():
    """The digest (non-pipeline) path also resolves a dropped dump
    transactionally instead of completing into a dead image."""
    cr = DeltaCR(
        store=ChunkStore(chunk_bytes=4096), restore_fn=_restore, dump_mode="digest"
    )
    s = _mk_state(seed=4, n_keys=6)
    snap = cr.store.stats.snapshot()
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    cr.checkpoint(s, 1, None)
    cr.drop_checkpoint(1)
    gate.set()
    _drain(cr)
    assert cr.stats.cancelled_dumps == 1
    assert cr.store.stats.chunks_alive == snap.chunks_alive
    assert cr.store.stats.physical_bytes == snap.physical_bytes
    cr.shutdown()


# ---------------------------------------------------------------------------
# ImageStore unit semantics
# ---------------------------------------------------------------------------

def test_image_store_ref_tokens_survive_id_recycling():
    """A dependent's token pins the record it acquired, even when the ckpt
    id is recycled for a new dump."""
    from repro_torch.core.deltacr import DumpImage
    from repro_torch.core.deltafs import TensorMeta

    chunks = ChunkStore(chunk_bytes=64)
    store = ImageStore(chunks)
    cid = chunks.put(b"x" * 64)
    t1 = store.begin(7)
    img1 = DumpImage(
        image_id=store.allocate_image_id(),
        parent_id=None,
        entries={"a": TensorMeta((64,), "uint8", (cid,))},
        dirtied_chunks=1,
        dump_bytes=64,
        wall_ms=0.0,
    )
    assert store.commit(t1, img1)
    ref = store.acquire(7)
    assert ref is not None
    # recycle ckpt 7 for a new dump: the old image is detached, not freed
    t2 = store.begin(7)
    assert chunks.refs(cid) == 1                 # old image still holds its chunk
    store.abort(t2)
    store.release(ref)                           # last dependent out: freed now
    assert cid not in chunks
    assert store.stats.deferred_frees == 0       # begin-detach, not drop-defer


def test_image_store_drop_defers_until_release():
    from repro_torch.core.deltacr import DumpImage
    from repro_torch.core.deltafs import TensorMeta

    chunks = ChunkStore(chunk_bytes=64)
    store = ImageStore(chunks)
    cid = chunks.put(b"y" * 64)
    t = store.begin(1)
    img = DumpImage(
        image_id=store.allocate_image_id(),
        parent_id=None,
        entries={"a": TensorMeta((64,), "uint8", (cid,))},
        dirtied_chunks=1,
        dump_bytes=64,
        wall_ms=0.0,
    )
    store.commit(t, img)
    ref = store.acquire(1)
    assert store.drop(1)
    assert not store.is_live(1)
    assert cid in chunks                         # deferred on the dependent
    assert store.deferred_count() == 1
    store.release(ref)
    assert cid not in chunks
    assert store.stats.deferred_frees == 1
    assert store.deferred_count() == 0


def test_sandbox_tree_children_hold_image_refs():
    """A forked child holds an explicit ImageStore ref on its base image;
    the ref moves with the child's base as it checkpoints and is released
    on teardown."""
    fs = DeltaFS(chunk_bytes=256)
    fs.write("repo/base", np.arange(64, dtype=np.int32))
    proc = CowArrayState({"heap": np.zeros(32, np.float32)})
    cr = DeltaCR(store=fs.store, restore_fn=_restore, template_pool_size=8)
    sm = StateManager(Sandbox(fs, proc), cr)
    base = sm.checkpoint()
    cr.wait_dumps()
    tree = SandboxTree(sm)
    child = tree.fork(base, 1)[0]
    rec = tree._children[child.sandbox_id]
    assert rec.image_ref is not None
    ck = tree.checkpoint(child.sandbox_id)
    cr.wait_dumps()
    rec = tree._children[child.sandbox_id]
    assert rec.image_ref is not None and rec.base_ckpt == ck
    tree.release(child.sandbox_id)
    # all dependent refs returned: dropping every node empties the store
    sm.restore(base)
    sm.reclaim(ck)
    _drain(cr)
    cr.images.debug_validate()
    cr.shutdown()


def test_image_store_lineage_children_query():
    """Parent→child delta edges are queryable from the live image set."""
    cr = _mk_cr()
    s = _mk_state(seed=9, n_keys=3)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    s.mutate("t0", lambda a: a.__setitem__(0, 1.5))
    cr.checkpoint(s, 2, 1)
    s.mutate("t1", lambda a: a.__setitem__(0, 2.5))
    cr.checkpoint(s, 3, 1)
    cr.wait_dumps()
    parent = cr.images.image_for(1)
    kids = cr.images.children(parent.image_id)
    assert kids == sorted(
        cr.images.image_for(c).image_id for c in (2, 3)
    )
    assert cr.images.children(cr.images.image_for(3).image_id) == []
    cr.shutdown()
