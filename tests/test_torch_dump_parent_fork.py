"""A child's dump diffs against a fork of its parent's template.

``DeltaCR.checkpoint`` carries a fork of the parent checkpoint's template
to the dump, which diffs against it when the parent's generation has left
the pipeline's cache.  The JAX package drains such a dump in full; the
images must come out the same, chunk id for chunk id and digest for
digest, with only the bytes moved differing.  The carried fork holds the
parent's pages until the dump ends, and has to give them back on every
exit of the dump.
"""
import pytest

pytest.importorskip("torch")

import json
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from repro.core.deltacr import CowArrayState as JCowArrayState
from repro.core.deltacr import DeltaCR as JDeltaCR
from repro.core.chunk_store import chunk_digest as j_chunk_digest
from repro.core.delta_pipeline import mark_clean as j_mark_clean
from repro.core.policy import DumpPolicy as JDumpPolicy
from repro_torch import trace
from repro_torch.core import CowArrayState, DeltaCR, DumpPolicy, faults, state_from_numpy
from repro_torch.core.chunk_store import chunk_digest
from repro_torch.core.delta_pipeline import DeltaDumpPipeline, mark_clean
from repro_torch.core.stream import StreamCancelled
from repro_torch.serve import PagedSession, PagePool
from test_torch_deltacr import CHUNK, JnpGridState, _image_view, t_write_bytes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the parent's generation leaves a cache of one at the next dump
POLICY = {"mode": "delta", "max_generations": 1}


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def _arrays(rng):
    return {
        "heap": rng.standard_normal(1500).astype(np.float32),     # ragged tail
        "ids": rng.integers(0, 1 << 30, 700, dtype=np.int32),
        "tiny": rng.integers(0, 9, 5, dtype=np.int64),            # digest path
    }


def _host_write(state, key, lo, data):
    state.mutate(key, lambda a: a.reshape(-1).view(np.uint8).__setitem__(
        slice(lo, lo + len(data)), data))


class _Twin:
    """One checkpoint tree driven through both packages: host arrays
    (``CowArrayState`` in both) or device grids (the JAX package's jnp
    grids against the port's ``CowTensorState`` on the CPU)."""

    def __init__(self, kind, seed):
        arrays = _arrays(np.random.default_rng(seed))
        kw = dict(chunk_bytes=CHUNK, template_pool_size=8, async_warm=False)
        if kind == "array":
            copy = lambda p: {k: np.array(v, copy=True) for k, v in p.items()}  # noqa: E731
            self.j = JDeltaCR(restore_fn=lambda p: JCowArrayState(copy(p)),
                              policy=JDumpPolicy(**POLICY), **kw)
            self.t = DeltaCR(restore_fn=lambda p: CowArrayState(copy(p)),
                             policy=DumpPolicy(**POLICY), **kw)
            self.js, self.ts = JCowArrayState(copy(arrays)), CowArrayState(copy(arrays))
        else:
            self.j = JDeltaCR(restore_fn=JnpGridState, policy=JDumpPolicy(**POLICY), **kw)
            self.t = DeltaCR(restore_fn=lambda p: state_from_numpy(p, device="cpu"),
                             policy=DumpPolicy(**POLICY), **kw)
            self.js, self.ts = JnpGridState(arrays), state_from_numpy(arrays, device="cpu")
        self.kind = kind

    def write(self, key, lo, data):
        if self.kind == "array":
            _host_write(self.js, key, lo, data)
            _host_write(self.ts, key, lo, data)
        else:
            self.js.write_bytes(key, lo, data)
            t_write_bytes(self.ts, key, lo, data)

    def checkpoint(self, c, parent):
        """Checkpoint both sides and land the dumps; returns the port's
        counters and the change of its ``full_keys`` over this dump."""
        full0 = self.t.stats.full_keys
        run = trace.new_run()
        self.j.checkpoint(self.js, c, parent)
        self.j.wait_dumps()
        with trace.scope(run):
            self.t.checkpoint(self.ts, c, parent)
        self.t.wait_dumps()
        return trace.snapshot(run)["counters"], self.t.stats.full_keys - full0

    def restore(self, c):
        self.js.release()
        self.ts.release()
        self.js, jpath = self.j.restore(c)
        self.ts, tpath = self.t.restore(c)
        j_mark_clean(self.js, c)
        mark_clean(self.ts, c)
        assert jpath == tpath == "fast"

    def assert_same_images(self, ckpts):
        for c in ckpts:
            ji, ti = self.j.dump_future(c).result(), self.t.dump_future(c).result()
            assert _image_view(self.t.store, ti, chunk_digest) == _image_view(
                self.j.store, ji, j_chunk_digest), f"image {c}"
            for name, meta in ti.entries.items():
                jm = ji.entries[name]
                assert meta.digests == jm.digests, f"image {c}: {name}"
            assert (ti.mode, ti.dirtied_chunks) == (ji.mode, ji.dirtied_chunks), f"image {c}"

    def shutdown(self):
        self.j.shutdown()
        self.t.shutdown()


NBYTES = {"heap": 6000, "ids": 2800}


def _write(twin, rng, key):
    lo = int(rng.integers(0, NBYTES[key] - 40))
    twin.write(key, lo, rng.integers(0, 256, 40, dtype=np.uint8))


def _parent_then_sibling(twin, rng):
    """Root R (1); its child P (2); P's sibling S (3), whose dump pushes
    P's generation out of the cache; then P restored fast and written."""
    twin.checkpoint(1, None)
    _write(twin, rng, "heap")
    twin.checkpoint(2, 1)
    twin.restore(1)
    _write(twin, rng, "ids")
    twin.checkpoint(3, 1)
    twin.restore(2)
    _write(twin, rng, "heap")


@pytest.mark.parametrize("kind", ["array", "tensor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_child_dump_diffs_against_the_carried_fork(kind, seed):
    """P's generation is gone from the cache of one; the dump of its child
    C diffs against the fork of P's template that the checkpoint carried,
    drains no key in full, and its image equals the JAX package's full
    drain of the same checkpoint."""
    rng = np.random.default_rng(100 + seed)
    twin = _Twin(kind, seed)
    try:
        _parent_then_sibling(twin, rng)
        assert 2 not in twin.t.pipeline.anchored_ids()
        counters, full = twin.checkpoint(4, 2)
        assert full == 0
        assert counters.get("dump.with_parent") == 1
        assert counters.get("dump.parent_fork") == 1
        assert counters.get("dump.base_miss", 0) == 0
        assert twin.j.stats.full_keys > twin.t.stats.full_keys    # the reference drained
        twin.assert_same_images([1, 2, 3, 4])
    finally:
        twin.shutdown()


@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_without_the_parents_template_the_dump_drains_in_full(kind):
    """P's template evicted before C's checkpoint: nothing is carried and
    the dump drains in full, as the JAX package's does."""
    rng = np.random.default_rng(7)
    twin = _Twin(kind, 3)
    try:
        _parent_then_sibling(twin, rng)
        twin.j.evict_template(2)
        twin.t.evict_template(2)
        counters, full = twin.checkpoint(4, 2)
        assert full >= 1
        assert counters.get("dump.with_parent") == 1
        assert counters.get("dump.base_miss") == 1
        assert counters.get("dump.parent_fork", 0) == 0
        twin.assert_same_images([1, 2, 3, 4])
    finally:
        twin.shutdown()


def test_a_digest_mode_parent_image_is_never_diffed_against():
    """The carried fork serves only a parent image the pipeline made: a
    parent dumped by another path drains its child in full."""
    arrays = _arrays(np.random.default_rng(5))
    cr = DeltaCR(restore_fn=lambda p: CowArrayState(dict(p)), chunk_bytes=CHUNK,
                 policy=DumpPolicy(**POLICY), async_warm=False)
    try:
        s = CowArrayState({k: v.copy() for k, v in arrays.items()})
        cr.apply_policy(DumpPolicy(**{**POLICY, "mode": "digest"}))
        cr.checkpoint(s, 1, None)
        cr.wait_dumps()
        cr.apply_policy(DumpPolicy(**POLICY))
        _host_write(s, "heap", 8, np.full(16, 3, np.uint8))
        run = trace.new_run()
        with trace.scope(run):
            cr.checkpoint(s, 2, 1)
        cr.wait_dumps()
        assert cr.dump_future(1).result().mode == "digest"
        counters = trace.snapshot(run)["counters"]
        assert counters.get("dump.parent_fork", 0) == 0 and counters.get("dump.base_miss") == 1
    finally:
        cr.shutdown()


def test_a_copy_mode_parent_image_is_diffed_against():
    """A parent image recorded as ``"copy"`` (the JAX package's
    straight-copy mode, as a snapshot it saved brings one to a recovered
    engine) is a pipeline image: its child diffs against the carried fork."""
    arrays = _arrays(np.random.default_rng(5))
    cr = DeltaCR(restore_fn=lambda p: CowArrayState(dict(p)), chunk_bytes=CHUNK,
                 policy=DumpPolicy(**POLICY), async_warm=False)
    try:
        s = CowArrayState({k: v.copy() for k, v in arrays.items()})
        cr.checkpoint(s, 1, None)
        cr.wait_dumps()
        cr.dump_future(1).result().mode = "copy"
        _host_write(s, "heap", 8, np.full(16, 3, np.uint8))
        run = trace.new_run()
        with trace.scope(run):
            cr.checkpoint(s, 2, 1)
        cr.wait_dumps()
        counters = trace.snapshot(run)["counters"]
        assert counters.get("dump.parent_fork") == 1 and counters.get("dump.base_miss", 0) == 0
        assert cr.dump_future(2).result().mode == "delta"
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# the carried fork's lifecycle over a paged session
# ---------------------------------------------------------------------------
PSZ = 4


def _tiny_pool():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.models.qwen3 import port_config

    cfg = json.loads((ROOT / "bench/tests/data/configs/qwen3-tiny.json").read_text())
    return PagePool(port_config(cfg), num_pages=96, page_size=PSZ,
                    max_pages_per_session=24, device="cpu")


def _append(sess, rng, n):
    """``n`` positions of random K/V written into the session, as a decode
    step writes them (planned CoW copies, dirty pages noted)."""
    pool = sess.pool
    sess.ensure_writable(extra_tokens=n)
    for pos in range(sess.seq_len, sess.seq_len + n):
        page, slot = int(sess.table[pos // PSZ]), pos % PSZ
        for skey, tag in pool.attn_tags:
            for pools in (pool.pools_k, pool.pools_v):
                t = pools[skey][tag]
                t[:, page, slot] = torch.from_numpy(
                    rng.standard_normal(t[:, page, slot].shape).astype(np.float32))
    sess.seq_len += n
    sess.tokens += [int(x) for x in rng.integers(0, 256, n)]
    sess.extras["last_logits"] = torch.from_numpy(rng.standard_normal(256).astype(np.float32))


class _Tree:
    """R (1) from a 37-position root; P (2) and its sibling S (3), two
    positions each, S's dump pushing P's generation out of the cache; then
    a session C restored fast from P and written, ready for its checkpoint
    4.  P's last page is part-full, so C copies it on write and only P's
    template holds it."""

    def __init__(self, **policy):
        self.pool = pool = _tiny_pool()
        rng = self.rng = np.random.default_rng(11)
        root = PagedSession(pool)
        _append(root, rng, 37)
        self.base_free, self.base_refs = pool.free_pages(), pool.refs.copy()
        self.cr = cr = DeltaCR(
            restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
            policy=DumpPolicy(**{**POLICY, **policy}), async_warm=False)
        self.live = [root]
        cr.checkpoint(root, 1, None)
        for c in (2, 3):
            s, _ = cr.restore(1)
            mark_clean(s, 1)
            _append(s, rng, 2)
            cr.checkpoint(s, c, 1)
            cr.wait_dumps()
            s.release()
        assert 2 not in cr.pipeline.anchored_ids()
        self.child, _ = cr.restore(2)
        mark_clean(self.child, 2)
        _append(self.child, rng, 2)
        self.live.append(self.child)

    def parent_tail(self):
        """The page only P's template holds (its part-full last page,
        which C copied on write)."""
        t = self.cr._templates[2]
        return int(t.table[t.n_pages - 1])

    def checkpoint_child(self):
        """C's checkpoint; asserts it carried a fork of P's template."""
        tail = self.parent_tail()
        before = int(self.pool.refs[tail])
        self.cr.checkpoint(self.child, 4, 2)
        assert int(self.pool.refs[tail]) == before + 1          # the carried fork

    def stall(self):
        """Holds the dump worker until the returned event is set."""
        gate = threading.Event()
        self.cr._dump_executor.submit(gate.wait)
        return gate

    def assert_baseline(self):
        """Every checkpoint dropped and every session but the root released:
        the pool's free pages and refcounts are those before the first
        checkpoint."""
        cr = self.cr
        for c in (1, 2, 3, 4):
            cr.drop_checkpoint(c)
        for s in self.live[1:]:
            s.release()
        cr.wait_dumps()
        cr.pipeline.clear()
        assert self.pool.free_pages() == self.base_free
        np.testing.assert_array_equal(self.pool.refs, self.base_refs)


def test_carried_fork_released_on_commit():
    tree = _Tree()
    try:
        run = trace.new_run()
        with trace.scope(run):
            tree.checkpoint_child()
        tree.cr.wait_dumps()
        counters = trace.snapshot(run)["counters"]
        assert counters.get("dump.parent_fork") == 1 and counters.get("dump.base_miss", 0) == 0
        assert tree.cr.stats.full_keys == 2          # R's first dump only: K and V
        tree.assert_baseline()
    finally:
        tree.cr.shutdown()


def test_carried_fork_released_when_dropped_while_queued():
    tree = _Tree()
    try:
        gate = tree.stall()
        tree.checkpoint_child()
        fut = tree.cr.dump_future(4)
        tree.cr.drop_checkpoint(4)
        gate.set()
        with pytest.raises(StreamCancelled):
            fut.result(timeout=60)
        assert tree.cr.stats.cancelled_dumps == 1
        tree.assert_baseline()
    finally:
        tree.cr.shutdown()


def test_carried_fork_released_when_cancelled_mid_stream(monkeypatch):
    """The checkpoint is dropped once the dump has planned its keys against
    the carried fork's grids, before the first is encoded."""
    tree = _Tree()
    real = DeltaDumpPipeline._run_sync
    calls = []

    def dropped_first(pipeline, tasks, *args):
        calls.append(len(tasks))
        tree.cr.drop_checkpoint(4)
        return real(pipeline, tasks, *args)

    monkeypatch.setattr(DeltaDumpPipeline, "_run_sync", dropped_first)
    try:
        tree.checkpoint_child()
        fut = tree.cr.dump_future(4)
        with pytest.raises(StreamCancelled):
            fut.result(timeout=60)
        assert calls and calls[0] >= 2          # K and V were planned
        assert tree.cr.stats.cancelled_dumps == 1
        monkeypatch.setattr(DeltaDumpPipeline, "_run_sync", real)
        tree.assert_baseline()
    finally:
        tree.cr.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(120)
@pytest.mark.parametrize("action", ["raise", "kill"])
def test_carried_fork_released_when_the_dump_fails(action):
    """Every attempt fails at the worker's fault point: the dump fails
    after its retries and the legacy path ("raise"), or the worker dies
    and respawns ("kill")."""
    tree = _Tree(retries=1, retry_backoff_s=0.0)
    try:
        with faults.inject(faults.FaultPlan().add("dump.worker", times=0, action=action)):
            tree.checkpoint_child()
            fut = tree.cr.dump_future(4)
            with pytest.raises(faults.FaultError):
                fut.result(timeout=60)
        h = tree.cr.health()
        assert h["dump_failures"] == 1
        assert h["worker_restarts"] == int(action == "kill")
        tree.assert_baseline()
    finally:
        tree.cr.shutdown()


def test_carried_fork_released_at_shutdown():
    """``shutdown`` while the dump waits behind a stalled worker: the queue
    drains, and the dump gives the fork back as it commits."""
    tree = _Tree()
    gate = tree.stall()
    tree.checkpoint_child()
    stopper = threading.Thread(target=tree.cr.shutdown)
    stopper.start()
    gate.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    assert tree.cr.dump_future(4).result(timeout=0).mode == "delta"
    tree.assert_baseline()


@pytest.mark.parametrize("K,cap,padded", [(516, 512, False), (5, 4, False), (5, 8, True)])
def test_kernel_pair_is_padded_only_past_its_rows(K, cap, padded):
    """The device plans hand the kernels the grids' own first K rows, with
    no O(state) copy, unless the planned capacity exceeds K; then both are
    zero-padded to the pow2 row count, as the plans are computed."""
    K2 = 1 << (K - 1).bit_length()
    old = torch.zeros((K + 3, 64), dtype=torch.uint8)
    new = torch.ones((K, 64), dtype=torch.uint8)
    o, n = DeltaDumpPipeline._padded_pair(old, new, K, K2, cap)
    assert o.shape == n.shape == ((K2 if padded else K), 64)
    assert (o.data_ptr() == old.data_ptr() and n.data_ptr() == new.data_ptr()) != padded
    if padded:
        assert int(o[K:].sum()) == int(n[K:].sum()) == 0
