"""The sandbox tree and GC of the port: every case of the JAX package's
``tests/test_sandbox_tree.py`` on the port, with ``CowTensorState`` on the
CPU as the process state, and a differential that drives one seeded list of
forks, writes, checkpoints, commits, releases and GC passes through both
packages and compares their snapshot trees, images, chunk-store statistics
and restored bytes.
"""
import pytest

pytest.importorskip("torch")

import threading

import numpy as np
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core import (
    CheckpointError,
    CowTensorState,
    DeltaCR,
    DeltaFS,
    NamespaceView,
    Sandbox,
    SandboxTree,
    StateManager,
    reachability_gc,
)

torch.set_num_threads(1)


def _mk(template_pool=16, chunk_bytes=256):
    fs = DeltaFS(chunk_bytes=chunk_bytes)
    fs.write("repo/base", np.arange(256, dtype=np.int32))
    proc = CowTensorState({"heap": np.zeros(64, np.float32)}, device="cpu")
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: CowTensorState(p, device="cpu"),
        template_pool_size=template_pool,
    )
    sm = StateManager(Sandbox(fs, proc), cr)
    return sm, fs, cr


# ---------------------------------------------------------------------------
# fork: bit-identical reads, isolated writes, shared chunk bytes
# ---------------------------------------------------------------------------

def test_fork_reads_bit_identical_to_checkpoint():
    sm, fs, cr = _mk()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 7.0))
    c1 = sm.checkpoint()
    # trunk moves on; children must still observe c1 exactly
    fs.write("repo/base", np.zeros(256, np.int32))
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 99.0))
    tree = SandboxTree(sm)
    for child in tree.fork(c1, 3):
        np.testing.assert_array_equal(child.fs.read("repo/base"), np.arange(256, dtype=np.int32))
        assert child.proc.get("heap")[0] == 7.0
    tree.release_all()
    cr.shutdown()


def test_fork_writes_mutually_isolated():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    kids = tree.fork(c1, 4)
    for i, child in enumerate(kids):
        child.fs.write("repo/base", np.full(256, i, np.int32))
        child.fs.write(f"only/{i}", np.full(8, i, np.int8))
        child.proc.mutate("heap", lambda h, i=i: h.__setitem__(0, float(i)))
    for i, child in enumerate(kids):
        assert child.fs.read("repo/base")[0] == i          # own write
        assert child.proc.get("heap")[0] == float(i)
        for j in range(4):
            assert child.fs.exists(f"only/{j}") == (i == j)  # no cross-child visibility
    # the trunk never saw any child write
    assert fs.read("repo/base")[0] == 0 and fs.read("repo/base")[255] == 255
    assert sm.sandbox.proc.get("heap")[0] == 0.0
    tree.release_all()
    cr.shutdown()


def test_fork_shares_frozen_chunk_bytes():
    """Forking must not copy: ChunkStore accounting is flat across a fan-out."""
    sm, fs, cr = _mk()
    fs.write("repo/big", np.arange(64 * 256, dtype=np.int32))   # many chunks
    c1 = sm.checkpoint()
    cr.wait_dumps()                       # async dump must not move the baseline
    st = fs.store.stats
    phys, logical, written = st.physical_bytes, st.logical_bytes, st.bytes_written
    tree = SandboxTree(sm)
    kids = tree.fork(c1, 8)
    assert st.physical_bytes == phys                     # zero bytes copied
    assert st.logical_bytes == logical                   # zero chunk refs taken
    assert st.bytes_written == written
    # a child dirtying one chunk adds exactly one chunk of physical bytes
    arr = kids[0].fs.read("repo/big")
    arr[0] += 1
    dirtied = kids[0].fs.write("repo/big", arr)
    assert dirtied == 1
    assert st.physical_bytes == phys + fs.store.chunk_bytes
    tree.release_all()
    assert st.physical_bytes == phys                     # child delta freed
    fs.debug_validate()
    cr.shutdown()


def test_release_returns_store_to_baseline():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    cr.wait_dumps()                       # async dump must not move the baseline
    tree = SandboxTree(sm)
    phys = fs.store.stats.physical_bytes
    kids = tree.fork(c1, 3)
    for i, child in enumerate(kids):
        child.fs.write(f"scratch/{i}", np.full(1024, i, np.int32))
    assert fs.store.stats.physical_bytes > phys
    tree.release_all()
    assert fs.store.stats.physical_bytes == phys
    assert tree.live_count() == 0
    fs.debug_validate()
    cr.shutdown()


# ---------------------------------------------------------------------------
# child checkpoints join the shared snapshot tree
# ---------------------------------------------------------------------------

def test_child_checkpoint_restorable_from_trunk():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    child = tree.fork(c1, 1)[0]
    child.fs.write("repo/child", np.full(32, 5, np.int16))
    child.proc.mutate("heap", lambda h: h.__setitem__(1, 2.5))
    ck = tree.checkpoint(child.sandbox_id)
    tree.release(child.sandbox_id)
    assert sm.nodes[ck].parent_id == c1
    sm.restore(ck)
    np.testing.assert_array_equal(sm.sandbox.fs.read("repo/child"), np.full(32, 5, np.int16))
    assert sm.sandbox.proc.get("heap")[1] == 2.5
    cr.wait_dumps()
    cr.shutdown()


def test_checkpoint_many_rides_dump_queue():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    kids = tree.fork(c1, 4)
    for i, child in enumerate(kids):
        child.proc.mutate("heap", lambda h, i=i: h.__setitem__(0, float(i + 1)))
    cks = tree.checkpoint_many([k.sandbox_id for k in kids])
    assert len(set(cks)) == 4
    cr.wait_dumps()
    for i, ck in enumerate(cks):
        assert cr.dump_future(ck) is not None
        assert sm.nodes[ck].parent_id == c1
    tree.release_all()
    cr.shutdown()


def test_fork_replay_failure_leaks_nothing():
    """A failing LW replay must release the half-built child (proc, view)
    and every pin, so the base stays reclaimable and storage is unchanged."""
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    lw = sm.checkpoint(lightweight=True, actions=("boom",))
    tree = SandboxTree(sm)
    cr.wait_dumps()          # deterministic baseline: c1's async dump landed
    phys = fs.store.stats.physical_bytes
    # no action_applier installed -> replay raises CheckpointError
    with pytest.raises(CheckpointError):
        tree.fork(lw, 2)
    assert tree.live_count() == 0
    assert fs.store.stats.physical_bytes == phys
    assert not sm.pinned_ckpts()                    # every pin rolled back
    fs.debug_validate()
    cr.shutdown()


def test_fork_from_lightweight_replays():
    sm, fs, cr = _mk()
    applied = []

    def applier(sandbox, action):
        applied.append(action)
        sandbox.proc.set("marker", np.array([action]))

    sm.action_applier = applier
    sm.checkpoint()
    lw = sm.checkpoint(lightweight=True, actions=(42,))
    tree = SandboxTree(sm)
    child = tree.fork(lw, 1)[0]
    assert applied == [42]
    assert child.proc.get("marker")[0] == 42
    assert "marker" not in list(sm.sandbox.proc.keys())   # trunk untouched by fork
    tree.release_all()
    cr.shutdown()


# ---------------------------------------------------------------------------
# commit: Fork-Explore-Commit
# ---------------------------------------------------------------------------

def test_commit_promotes_winner_and_reclaims_losers():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    kids = tree.fork(c1, 3)
    cks = []
    for i, child in enumerate(kids):
        child.fs.write("repo/answer", np.full(16, i, np.int32))
        cks.append(tree.checkpoint(child.sandbox_id))
    kids[1].fs.write("repo/bonus", np.ones(8, np.int8))
    final = tree.commit(kids[1].sandbox_id)

    # trunk now IS the winner (last writes included via the final checkpoint)
    assert sm.current == final
    assert fs.read("repo/answer")[0] == 1
    assert fs.read("repo/bonus")[0] == 1
    # losers' snapshot storage reclaimed; winner lineage survives
    assert sm.nodes[cks[0]].reclaimed and sm.nodes[cks[2]].reclaimed
    assert not sm.nodes[cks[1]].reclaimed and not sm.nodes[final].reclaimed
    # no live children remain; restoring the winner chain still works
    assert tree.live_count() == 0
    sm.restore(cks[1])
    assert fs.read("repo/answer")[0] == 1 and not fs.exists("repo/bonus")
    fs.debug_validate()
    cr.wait_dumps()
    cr.shutdown()


def test_commit_frees_loser_storage():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    cr.wait_dumps()
    tree = SandboxTree(sm)
    kids = tree.fork(c1, 3)
    for i, child in enumerate(kids):
        child.fs.write("repo/fat", np.full(4096, i, np.int32))   # unique per child
        tree.checkpoint(child.sandbox_id)
    cr.wait_dumps()
    before = fs.store.stats.physical_bytes
    tree.commit(kids[0].sandbox_id)
    cr.wait_dumps()
    # two losers' unique layer + image bytes are gone
    assert fs.store.stats.physical_bytes < before
    fs.debug_validate()
    cr.shutdown()


def test_commit_unknown_sandbox_raises():
    sm, fs, cr = _mk()
    sm.checkpoint()
    tree = SandboxTree(sm)
    with pytest.raises(KeyError):
        tree.commit(12345)
    cr.shutdown()


# ---------------------------------------------------------------------------
# GC / reclaim pinning
# ---------------------------------------------------------------------------

def test_reclaim_refuses_pinned_checkpoint():
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    child = tree.fork(c1, 1)[0]
    with pytest.raises(CheckpointError):
        sm.reclaim(c1)
    tree.release(child.sandbox_id)
    sm.checkpoint()                     # move current off c1
    cr.wait_dumps()                     # c2's delta dump references c1's image
    sm.reclaim(c1)                      # now fine
    assert sm.nodes[c1].reclaimed
    cr.wait_dumps()
    cr.shutdown()


def test_reachability_gc_keeps_live_fork_bases():
    sm, fs, cr = _mk()
    root = sm.checkpoint()
    kids = []
    for i in range(3):
        sm.restore(root)
        sm.sandbox.proc.mutate("heap", lambda h, i=i: h.__setitem__(i, float(i)))
        kids.append(sm.checkpoint())
    # all children look dead to the search...
    for k in kids:
        sm.nodes[k].terminal = False
        sm.nodes[k].expandable = False
    sm.restore(root)
    tree = SandboxTree(sm)
    forked = tree.fork(kids[0], 1)[0]   # ...but one has a live fork on it
    cr.wait_dumps()
    reclaimed = reachability_gc(sm)
    assert kids[0] not in reclaimed     # pinned by the live sandbox
    assert kids[1] in reclaimed and kids[2] in reclaimed
    # the forked sandbox still reads its base fine after GC
    assert forked.fs.read("repo/base")[255] == 255
    tree.release_all()
    reclaimed = reachability_gc(sm)
    assert kids[0] in reclaimed         # unpinned: reclaimable now
    fs.debug_validate()
    cr.shutdown()


def test_release_during_checkpoint_is_deferred():
    """Releasing a child whose checkpoint is in its unlocked phase must not
    free the proc/view under the in-flight fork — teardown is deferred to
    the checkpoint's completion."""
    sm, fs, cr = _mk()
    c1 = sm.checkpoint()
    tree = SandboxTree(sm)
    child = tree.fork(c1, 1)[0]
    entry = tree._children[child.sandbox_id]
    entry.busy = True                      # simulate checkpoint phase 2
    tree.release(child.sandbox_id)
    assert not entry.alive and entry.deferred_release
    assert not child.fs.closed             # teardown deferred, state still live
    with tree._lock:
        deferred = tree._clear_busy(child.sandbox_id, entry)
    tree._teardown(deferred)
    assert child.fs.closed
    assert tree.live_count() == 0
    assert not sm.pinned_ckpts()
    fs.debug_validate()
    cr.shutdown()


# ---------------------------------------------------------------------------
# shared-layer refcounting under concurrency (thread-stress property test)
# ---------------------------------------------------------------------------

def test_layerstore_refcounting_thread_stress():
    """Multiple sandboxes fork/write/checkpoint/release against one
    LayerStore concurrently; invariants hold throughout and all transient
    storage is returned at the end."""
    sm, fs, cr = _mk(template_pool=32, chunk_bytes=128)
    base = sm.checkpoint()
    cr.wait_dumps()
    tree = SandboxTree(sm)
    baseline_phys = fs.store.stats.physical_bytes
    errors = []
    created_ckpts = []
    ckpt_lock = threading.Lock()
    n_threads, rounds = 4, 8

    def worker(tid: int):
        rng = np.random.default_rng(tid)
        try:
            for r in range(rounds):
                with ckpt_lock:
                    candidates = [base] + created_ckpts[-6:]
                    src = candidates[int(rng.integers(len(candidates)))]
                try:
                    child = tree.fork(src, 1)[0]
                except KeyError:
                    continue            # source raced with a reclaim: fine
                for w in range(int(rng.integers(1, 4))):
                    key = f"t{tid}/k{int(rng.integers(4))}"
                    child.fs.write(key, rng.integers(0, 255, size=200).astype(np.uint8))
                    child.proc.mutate("heap", lambda h: h.__setitem__(tid, float(r)))
                if rng.random() < 0.6:
                    ck = tree.checkpoint(child.sandbox_id, dump=bool(rng.random() < 0.5))
                    with ckpt_lock:
                        created_ckpts.append(ck)
                tree.debug_validate()   # no dangling chunks mid-flight
                tree.release(child.sandbox_id)
        except Exception as exc:  # pragma: no cover - failure reporting
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert tree.live_count() == 0
    cr.wait_dumps()
    fs.debug_validate()
    # every created checkpoint is restorable (no refcount went missing)...
    for ck in created_ckpts[-4:]:
        sm.restore(ck)
        fs.debug_validate()
    # ...and reclaiming everything returns the store to its baseline
    sm.restore(base)
    for ck in created_ckpts:
        if not sm.nodes[ck].reclaimed:
            sm.reclaim(ck)
    assert fs.store.stats.physical_bytes == baseline_phys
    fs.debug_validate()
    cr.shutdown()


# ---------------------------------------------------------------------------
# NamespaceView plumbing
# ---------------------------------------------------------------------------

def test_tree_requires_namespace_view():
    class FakeFS:
        pass

    proc = CowTensorState({"x": np.zeros(4)}, device="cpu")
    cr = DeltaCR(restore_fn=lambda p: CowTensorState(p, device="cpu"))
    sm = StateManager(Sandbox(FakeFS(), proc), cr)
    with pytest.raises(TypeError):
        SandboxTree(sm)
    cr.shutdown()


def test_closed_view_operations_fail_loudly():
    """Use-after-close must raise a clear error before touching the shared
    store — a write on a closed view would leak chunk references."""
    fs = DeltaFS(chunk_bytes=64)
    fs.write("a", np.arange(32, dtype=np.int8))
    cfg = fs.checkpoint()
    view = NamespaceView(fs.layers, base_config=cfg)
    view.close()
    puts_before = fs.store.stats.puts
    for op in (
        lambda: view.read("a"),
        lambda: view.write("a", np.zeros(32, np.int8)),
        lambda: view.delete("a"),
        lambda: view.exists("a"),
        lambda: view.keys(),
        lambda: view.checkpoint(),
        lambda: view.switch(cfg),
    ):
        with pytest.raises(RuntimeError, match="closed"):
            op()
    assert fs.store.stats.puts == puts_before      # nothing reached the store
    fs.release_config(cfg)
    fs.debug_validate()


def test_namespace_view_close_is_idempotent():
    fs = DeltaFS(chunk_bytes=64)
    fs.write("a", np.arange(32, dtype=np.int8))
    cfg = fs.checkpoint()
    view = NamespaceView(fs.layers, base_config=cfg)
    np.testing.assert_array_equal(view.read("a"), np.arange(32, dtype=np.int8))
    view.close()
    view.close()
    assert view.closed
    fs.release_config(cfg)
    fs.debug_validate()


# ---------------------------------------------------------------------------
# the two packages under one seeded op list
# ---------------------------------------------------------------------------

HEAP = 2048          # float32 elements: 32 chunks of 256 B


def _dump_inline(cr):
    """Make each checkpoint of ``cr`` return only once its dump has landed.
    The chunk store then sees its puts and the caller's frees in one order,
    the same in either package, so every statistic of the store (puts,
    dedupe hits, the high-water mark) is deterministic."""
    checkpoint = cr.checkpoint

    def inline(state, ckpt_id, *args, **kwargs):
        checkpoint(state, ckpt_id, *args, **kwargs)
        fut = cr.dump_future(ckpt_id)
        if fut is not None:
            fut.result()

    cr.checkpoint = inline


def _world(pkg, tensor: bool):
    """A trunk of both packages: the reference's host heap, or the port's
    ``CowTensorState`` on the CPU, over the same bytes."""
    fs = pkg.DeltaFS(chunk_bytes=256)
    fs.write("repo/base", np.arange(512, dtype=np.int32))
    heap = {"heap": np.zeros(HEAP, np.float32), "cursor": np.zeros(4, np.int64)}
    if tensor:
        proc = pkg.CowTensorState(heap, device="cpu")
        restore_fn = lambda p: pkg.CowTensorState(p, device="cpu")  # noqa: E731
    else:
        proc = pkg.CowArrayState(heap)
        restore_fn = lambda p: pkg.CowArrayState({k: v.copy() for k, v in p.items()})  # noqa: E731
    # No async warm: the reference's CowArrayState.fork can race a warm of
    # the same state on the warm thread and lose a refcount, which makes its
    # images nondeterministic (the port serializes the two; see
    # test_fork_racing_an_async_warm_keeps_refcounts).
    cr = pkg.DeltaCR(store=fs.store, restore_fn=restore_fn, template_pool_size=64,
                     async_warm=False)
    _dump_inline(cr)
    sm = pkg.StateManager(pkg.Sandbox(fs, proc), cr)

    def applier(sandbox, action):
        sandbox.proc.mutate("cursor", lambda c: c.__setitem__(1, int(action)))

    sm.action_applier = applier
    return sm, fs, cr


def _ops(seed: int, n: int = 40):
    """A seeded op list: forks of width 1-4, child fs and heap writes,
    checkpoints (full and lightweight), commits, releases and GC passes
    (the first op of a list with no live child forks instead)."""
    rng = np.random.default_rng(seed)
    kinds = ["fork", "write", "heap", "checkpoint", "lw", "release", "gc", "commit"]
    probs = [0.2, 0.18, 0.18, 0.16, 0.08, 0.08, 0.06, 0.06]
    seq = kinds + [str(k) for k in rng.choice(kinds, size=n - len(kinds), p=probs)]
    rng.shuffle(seq)            # every kind at least once, in a seeded order
    return [(k, int(rng.integers(1 << 30))) for k in seq]


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats(store):
    """Every statistic of the chunk store."""
    return dict(vars(store.stats))


def _drive(pkg, tensor: bool, ops):
    """Run ``ops`` through one package; every dump lands before the next op
    so both packages see the same generation cache.  Returns what the
    differential compares."""
    sm, fs, cr = _world(pkg, tensor)
    root = sm.checkpoint()
    cr.wait_dumps()
    tree = pkg.SandboxTree(sm)
    bases = [root]
    live = []           # sandbox ids in fork order
    trace = []
    for kind, arg in ops:
        rng = np.random.default_rng(arg)
        if kind == "fork" or not live:
            src = bases[int(rng.integers(len(bases)))]
            kids = tree.fork(src, int(rng.integers(1, 5)))
            live += [k.sandbox_id for k in kids]
            trace.append(("fork", src, [k.sandbox_id for k in kids]))
        elif kind == "write":
            sid = live[int(rng.integers(len(live)))]
            box = tree.sandbox(sid)
            key = f"repo/f{int(rng.integers(3))}"
            box.fs.write(key, rng.integers(0, 1 << 20, size=300).astype(np.int32))
            trace.append(("write", sid, key))
        elif kind == "heap":
            sid = live[int(rng.integers(len(live)))]
            lo = int(rng.integers(HEAP - 64))
            vals = rng.standard_normal(64).astype(np.float32)
            tree.sandbox(sid).proc.mutate(
                "heap", lambda h, lo=lo, v=vals: h.__setitem__(
                    slice(lo, lo + 64), torch.from_numpy(v) if isinstance(h, torch.Tensor) else v))
            trace.append(("heap", sid, lo))
        elif kind == "checkpoint":
            sid = live[int(rng.integers(len(live)))]
            ck = tree.checkpoint(sid)
            bases.append(ck)
            trace.append(("checkpoint", sid, ck))
        elif kind == "lw":
            sid = live[int(rng.integers(len(live)))]
            action = int(rng.integers(1, 100))
            tree.sandbox(sid).proc.mutate("cursor", lambda c, a=action: c.__setitem__(1, a))
            ck = tree.checkpoint_lightweight(sid, (action,))
            bases.append(ck)
            trace.append(("lw", sid, ck))
        elif kind == "release":
            sid = live.pop(int(rng.integers(len(live))))
            tree.release(sid)
            trace.append(("release", sid))
        elif kind == "gc":
            for node in sm.live_nodes():
                node.expandable = node.ckpt_id % 3 == 0
            trace.append(("gc", sorted(pkg.reachability_gc(sm))))
        elif kind == "commit":
            sid = live[int(rng.integers(len(live)))]
            final = tree.commit(sid)
            live = []
            bases = [final]
            trace.append(("commit", sid, final))
        cr.wait_dumps()
        bases = [b for b in bases if not sm.node(b).reclaimed]
        if not bases:
            bases = [sm.current]
        fs.debug_validate()
    tree.release_all()
    cr.wait_dumps()
    nodes = [(n.ckpt_id, n.parent_id, n.reclaimed, n.lightweight) for n in sm.nodes.values()]
    images = {}
    for n in sm.nodes.values():
        img = cr.images.image_for(n.ckpt_id)
        if img is not None:
            images[n.ckpt_id] = (img.mode, {k: (m.digests, m.trailing_pad)
                                            for k, m in sorted(img.entries.items())})
    stats = _stats(fs.store)
    restored = {}
    for n in list(sm.nodes.values()):
        if n.reclaimed:
            continue
        sm.restore(n.ckpt_id)
        proc = sm.sandbox.proc
        restored[n.ckpt_id] = (
            {k: _host(proc.get(k)).tobytes() for k in sorted(proc.keys())},
            {k: sm.sandbox.fs.read(k).tobytes() for k in sorted(sm.sandbox.fs.keys())},
        )
    cr.shutdown()
    return trace, nodes, images, stats, restored


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_ops_match_the_reference(seed):
    ops = _ops(seed)
    want = _drive(J, False, ops)
    got = _drive(T, True, ops)
    names = ["trace", "snapshot tree", "images", "chunk-store stats", "restores"]
    for name, g, w in zip(names, got, want):
        assert g == w, name
    # the run exercised what it claims to
    kinds = {t[0] for t in got[0]}
    assert {"fork", "checkpoint", "lw", "release", "gc", "commit"} <= kinds, kinds
    assert any(mode == "delta" for mode, _ in got[2].values())


def test_recency_gc_matches_the_reference():
    """``recency_gc`` keeps the newest nodes, the current one and the live
    forks' bases in both packages."""
    out = []
    for pkg, tensor in ((J, False), (T, True)):
        sm, fs, cr = _world(pkg, tensor)
        cks = [sm.checkpoint()]
        for i in range(6):
            sm.sandbox.proc.mutate("cursor", lambda c, i=i: c.__setitem__(0, i))
            cks.append(sm.checkpoint())
        cr.wait_dumps()
        tree = pkg.SandboxTree(sm)
        tree.fork(cks[1], 1)
        stats = {}
        reclaimed = pkg.recency_gc(sm, keep_last=2, stats_out=stats)
        tree.release_all()
        cr.wait_dumps()
        out.append((sorted(reclaimed), stats["live_images"], _stats(fs.store)))
        cr.shutdown()
    assert out[0] == out[1]
    assert out[1][0] == [1, 3, 4, 5]


# ---------------------------------------------------------------------------
# a fork racing an async warm of the same state
# ---------------------------------------------------------------------------

def _holders_consistent(states):
    """Every tensor (array) is held under one cell, whose refs count its
    holders."""
    cells = {}
    for s in states:
        data = s._tensors if hasattr(s, "_tensors") else s._arrays
        for k, t in data.items():
            ptr = t.data_ptr() if isinstance(t, torch.Tensor) else t.ctypes.data
            cells.setdefault((k, ptr), []).append(s._shared[k])
    return all(
        len({id(c) for c in cs}) == 1 and cs[0].refs == len(cs) for cs in cells.values()
    )


@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_fork_racing_an_async_warm_keeps_refcounts(kind):
    """A restored state is warmed on DeltaCR's warm thread while its owner
    forks it (a checkpoint, a tree fork).  The fork is held inside its
    refcount loop (on the first key's cell lock) while the warm privatizes
    the second key; the clone must still hold a ref on exactly the cells of
    the tensors it took."""
    data = {"k0": np.zeros(64, np.float32), "k1": np.ones(64, np.float32)}
    if kind == "tensor":
        tmpl = CowTensorState(data, hot_keys=("k1",), device="cpu")
    else:
        tmpl = T.CowArrayState(data, hot_keys=("k1",))
    state = tmpl.fork()                         # shares both cells with tmpl
    out = []
    held = state._shared["k0"].lock
    held.acquire()
    try:
        forker = threading.Thread(target=lambda: out.append(state.fork()))
        forker.start()
        forker.join(0.2)                        # parked on k0's cell lock
        warmer = threading.Thread(target=state.warm)
        warmer.start()
        warmer.join(0.2)
    finally:
        held.release()
    forker.join(10)
    warmer.join(10)
    assert not forker.is_alive() and not warmer.is_alive()
    assert state.warmed_copies == 1
    assert _holders_consistent([tmpl, state, out[0]])
    for s in (out[0], state):
        s.release()
    assert _holders_consistent([tmpl]) and tmpl._shared["k1"].refs == 1
