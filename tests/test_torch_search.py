"""The search package of the port: every case of the JAX package's
``tests/test_search.py`` on the port (heaps are ``CowTensorState`` on the
CPU), a differential that runs the serial MCTS over ``SyntheticAgentTask``
through both packages, and the archetype heap scatter against numpy's
fancy assignment where its indices repeat."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.search as JS
from repro_torch.core import (
    CowTensorState,
    DeltaCR,
    DeltaFS,
    Sandbox,
    SandboxTree,
    StateManager,
)
from repro_torch.search import (
    ARCHETYPES,
    MCTS,
    MCTSConfig,
    SyntheticAgentTask,
    build_sandbox_state,
    checkpoint_burst,
    fork_n,
    fork_sandboxes,
    rollout_fanout,
    staleness,
    sync_gpu_occupation,
)
from repro_torch.search.archetypes import Action, last_writes

torch.set_num_threads(1)


def _rig(archetype="tools", pool=16):
    spec = ARCHETYPES[archetype]
    fs = DeltaFS(chunk_bytes=4096)
    proc = build_sandbox_state(spec, fs, seed=0, device="cpu")
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: CowTensorState(p, device="cpu"),
        template_pool_size=pool,
    )
    sm = StateManager(Sandbox(fs, proc), cr)
    task = SyntheticAgentTask(spec)
    sm.action_applier = lambda sb, act: task.replay_action(sb, act)
    return sm, task, cr, fs


def test_mcts_explores_and_backtracks():
    sm, task, cr, fs = _rig()
    mcts = MCTS(sm, task, MCTSConfig(iterations=25, seed=1))
    st = mcts.run()
    cr.wait_dumps()
    assert st.iterations == 25
    assert st.restores > 5                  # real backtracking happened
    assert st.nodes > 10
    assert st.fast_restores + st.slow_restores == st.restores
    assert mcts.best_leaf() is not None
    fs.debug_validate()
    cr.shutdown()


def test_mcts_rollback_determinism():
    """Restoring a node and replaying the same action gives identical state —
    the paper's §2.2 determinism requirement."""
    sm, task, cr, fs = _rig()
    c0 = sm.checkpoint()
    action = task.propose_actions(sm.sandbox, 7)[0]
    task.apply_action(sm.sandbox, action)
    heap_a = sm.sandbox.proc.get("heap_0").clone()
    fs_a = sm.sandbox.fs.read("repo/file_0000").copy()
    sm.restore(c0)
    task.apply_action(sm.sandbox, action)
    assert torch.equal(heap_a, sm.sandbox.proc.get("heap_0"))
    np.testing.assert_array_equal(fs_a, sm.sandbox.fs.read("repo/file_0000"))
    cr.shutdown()


def test_mcts_lightweight_ratio():
    """Read-only actions route to LW checkpoints (paper: 62% route to LW)."""
    sm, task, cr, fs = _rig("sympy")        # readonly_prob = 0.75
    mcts = MCTS(sm, task, MCTSConfig(iterations=30, seed=2))
    st = mcts.run()
    assert st.lw_checkpoints > 0
    assert st.lw_checkpoints < st.checkpoints
    cr.shutdown()


def test_mcts_with_gc_stays_correct():
    sm, task, cr, fs = _rig(pool=4)
    mcts = MCTS(sm, task, MCTSConfig(iterations=30, gc_every=10, seed=3))
    mcts.run()
    cr.wait_dumps()
    # every live non-LW node is restorable after GC passes
    for node in sm.live_nodes():
        if not node.lightweight:
            sm.restore(node.ckpt_id)
    fs.debug_validate()
    cr.shutdown()


def test_parallel_mcts_explores_and_stays_consistent():
    sm, task, cr, fs = _rig()
    mcts = MCTS(sm, task, MCTSConfig(iterations=24, parallel_leaves=4, seed=5))
    st = mcts.run()
    cr.wait_dumps()
    assert st.iterations == 24
    assert st.forks >= 24                    # every leaf explored on a fork
    assert st.parallel_batches >= 6
    assert st.nodes > 10
    assert 0.0 <= st.best_value <= 1.0
    assert mcts.best_leaf() is not None
    assert mcts.tree is not None and mcts.tree.live_count() == 0
    fs.debug_validate()
    # the tree remains restorable after the parallel run
    for node in sm.live_nodes():
        if not node.lightweight:
            sm.restore(node.ckpt_id)
            break
    cr.shutdown()


def test_parallel_mcts_with_gc():
    sm, task, cr, fs = _rig(pool=8)
    mcts = MCTS(sm, task, MCTSConfig(iterations=24, parallel_leaves=4, gc_every=8, seed=6))
    mcts.run()
    cr.wait_dumps()
    for node in sm.live_nodes():
        if not node.lightweight:
            sm.restore(node.ckpt_id)
    fs.debug_validate()
    cr.shutdown()


def test_parallel_mcts_routes_readonly_to_lw():
    """The parallel driver honors use_lightweight exactly like the serial
    one: read-only actions become metadata-only markers, not full dumps."""
    sm, task, cr, fs = _rig("sympy")        # readonly_prob = 0.75
    mcts = MCTS(sm, task, MCTSConfig(iterations=24, parallel_leaves=4, seed=8))
    st = mcts.run()
    cr.wait_dumps()
    assert st.lw_checkpoints > 0
    assert st.lw_checkpoints < st.checkpoints
    # LW children are forkable/restorable (replay through the full ancestor)
    for node in sm.live_nodes():
        if node.lightweight and node.replay_actions:
            assert sm.restore(node.ckpt_id).endswith("+replay")
            break
    fs.debug_validate()
    cr.shutdown()


def test_mcts_time_budget_stops_early():
    sm, task, cr, fs = _rig()
    task.action_time_s = 0.02
    cfg = MCTSConfig(iterations=10_000, time_budget_s=0.3, seed=7)
    st = MCTS(sm, task, cfg).run()
    assert 0 < st.iterations < 10_000
    assert st.wall_s < 5.0
    cr.shutdown()


def test_rollout_fanout_over_sandbox_tree():
    sm, task, cr, fs = _rig()
    c0 = sm.checkpoint()
    tree = SandboxTree(sm)

    def rollout(sandbox, i):
        sandbox.fs.write("repo/rollout", np.full(8, i, np.int32))
        sandbox.proc.mutate("cursor", lambda c: c.__setitem__(0, i))
        return float(sandbox.fs.read("repo/rollout")[0])

    rewards, res = rollout_fanout(tree, 6, rollout, ckpt_id=c0, workers=3)
    assert sorted(rewards) == [float(i) for i in range(6)]
    assert tree.live_count() == 0
    # trunk untouched by any rollout
    assert not fs.exists("repo/rollout")
    assert res.n == 6 and len(res.fork_ms) == 6
    fs.debug_validate()
    cr.shutdown()


def test_rollout_fanout_failure_releases_children():
    """A raising rollout_fn must not leak forked sandboxes or pins."""
    sm, task, cr, fs = _rig()
    c0 = sm.checkpoint()
    tree = SandboxTree(sm)

    def exploding(sandbox, i):
        if i == 2:
            raise RuntimeError("rollout died")
        return 0.0

    with pytest.raises(RuntimeError):
        rollout_fanout(tree, 4, exploding, ckpt_id=c0)
    assert tree.live_count() == 0
    assert not sm.pinned_ckpts()
    fs.debug_validate()
    cr.shutdown()


def test_fork_sandboxes_requires_ckpt():
    sm, task, cr, fs = _rig()
    tree = SandboxTree(sm)
    with pytest.raises(ValueError):
        rollout_fanout(tree, 2, lambda s, i: 0.0)
    cr.shutdown()


def test_checkpoint_burst_per_state_parents():
    sm, task, cr, fs = _rig()
    c0 = sm.checkpoint()
    tree = SandboxTree(sm)
    kids, _ = fork_sandboxes(tree, c0, 3)
    for i, k in enumerate(kids):
        k.proc.mutate("cursor", lambda c, i=i: c.__setitem__(0, i + 1))
    ids = [sm.allocate_ckpt_id() for _ in kids]
    parents = [tree.base_ckpt(k.sandbox_id) for k in kids]
    futs, submit_ms = checkpoint_burst(
        cr, [k.proc for k in kids], ids, parents, wait=True
    )
    assert all(f is not None and f.done() for f in futs)
    with pytest.raises(ValueError):
        checkpoint_burst(cr, [kids[0].proc], [99], [1, 2])   # misaligned parents
    tree.release_all()
    cr.shutdown()


def test_fork_n_scaling():
    state = CowTensorState({"heap": torch.zeros(1 << 18)}, device="cpu")
    results = {}
    for n in (1, 4, 16, 64):
        children, res = fork_n(state, n)
        results[n] = res
        assert len(children) == n
        for c in children:
            c.release()
    # sub-linear per-fork cost: p50 roughly flat with N
    assert results[64].p50_ms < 50 * results[1].p50_ms + 1.0
    assert results[64].forks_per_s > 0


def test_rollout_fanout_rewards_and_teardown():
    state = CowTensorState({"heap": torch.zeros(1024)}, device="cpu")

    def rollout(child, i):
        child.mutate("heap", lambda h: h.__setitem__(0, float(i)))
        return float(child.get("heap")[0])

    rewards, res = rollout_fanout(state, 8, rollout)
    assert rewards == [float(i) for i in range(8)]
    # parent unaffected by any rollout (CoW isolation)
    assert state.get("heap")[0] == 0.0


def test_occupation_model():
    # paper Fig 7c: DeltaBox ~0.95-0.97 vs E2B ~0.3
    assert sync_gpu_occupation(0.05, 1.0, 1.0) > 0.95
    assert sync_gpu_occupation(4.5, 1.0, 1.0) < 0.35
    assert staleness(0.5, 1.0, 1.0) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# the two packages under one seed
# ---------------------------------------------------------------------------

def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def _search(pkg, search, archetype, iterations, seed):
    """The serial MCTS of one package over ``archetype``; returns what the
    differential compares, node by node."""
    spec = search.ARCHETYPES[archetype]
    fs = pkg.DeltaFS(chunk_bytes=4096)
    if pkg is J:
        proc = search.build_sandbox_state(spec, fs, seed=0)
        restore_fn = lambda p: J.CowArrayState({k: v.copy() for k, v in p.items()})  # noqa: E731
    else:
        proc = search.build_sandbox_state(spec, fs, seed=0, device="cpu")
        restore_fn = lambda p: CowTensorState(p, device="cpu")  # noqa: E731
    # No async warm: the reference's CowArrayState.fork can race a warm of
    # the same state and lose a refcount, which makes its images
    # nondeterministic (the port serializes the two).
    cr = pkg.DeltaCR(store=fs.store, restore_fn=restore_fn, template_pool_size=6,
                     async_warm=False)
    _dump_inline(cr)
    sm = pkg.StateManager(pkg.Sandbox(fs, proc), cr)
    task = search.SyntheticAgentTask(spec)
    sm.action_applier = lambda sb, act: task.replay_action(sb, act)
    mcts = search.MCTS(sm, task, search.MCTSConfig(iterations=iterations, gc_every=5, seed=seed))
    st = mcts.run()
    cr.wait_dumps()
    counters = {k: v for k, v in vars(st).items() if not k.startswith("time_") and k != "wall_s"}
    nodes = {
        n.ckpt_id: (n.parent_id, n.visits, n.value, n.reclaimed, n.lightweight, n.terminal,
                    [(a.seed, a.readonly) for a in n.replay_actions])
        for n in sm.nodes.values()
    }
    images = {}
    for n in sm.nodes.values():
        img = cr.images.image_for(n.ckpt_id)
        if img is not None:
            images[n.ckpt_id] = {k: m.digests for k, m in sorted(img.entries.items())}
    heaps = {}
    for n in list(sm.nodes.values()):
        if n.reclaimed:
            continue
        sm.restore(n.ckpt_id)
        proc = sm.sandbox.proc
        heaps[n.ckpt_id] = {k: _host(proc.get(k)).tobytes() for k in sorted(proc.keys())}
    stats = dict(vars(fs.store.stats))
    cr.shutdown()
    return counters, nodes, images, heaps, stats, mcts.best_leaf()


@pytest.mark.parametrize("archetype,iterations", [("tools", 20), ("django", 10)])
def test_serial_mcts_matches_the_reference(archetype, iterations):
    """Equal MCTSStats counters, visits and values per node, heap bytes and
    image digests per node, and every chunk-store statistic."""
    import repro_torch.core as T
    import repro_torch.search as TS

    want = _search(J, JS, archetype, iterations, seed=3)
    got = _search(T, TS, archetype, iterations, seed=3)
    names = ["MCTSStats counters", "nodes", "image digests", "heap bytes", "chunk-store stats",
             "best leaf"]
    for name, g, w in zip(names, got, want):
        assert g == w, name
    counters, nodes, images = got[:3]
    assert counters["restores"] > 0 and counters["nodes"] > 5
    assert sum(n[4] for n in nodes.values()) > 0 or archetype == "django"
    assert len(images) >= 3


def _heap_draws(spec, seed, keys):
    """The reference's heap draws of one action, replayed: per mutated key,
    the indices it scatters to."""
    rng = np.random.default_rng(seed)
    out = {}
    frac = spec.heap_dirty_fraction
    for key, size in keys:
        if key.startswith("heap_") and rng.random() < frac * 2:
            n = max(1, int(size * frac))
            out[key] = rng.integers(0, size, size=n)
            rng.standard_normal(n)
    return out


def test_heap_scatter_with_repeated_indices_matches_the_reference():
    """An action whose scatter repeats indices leaves the heap bytes that
    numpy's last-write-wins assignment leaves in the reference."""
    spec = ARCHETYPES["tools"]
    jfs, tfs = J.DeltaFS(chunk_bytes=4096), DeltaFS(chunk_bytes=4096)
    jproc = JS.build_sandbox_state(spec, jfs, seed=0)
    tproc = build_sandbox_state(spec, tfs, seed=0, device="cpu")
    keys = [(k, jproc.get(k).size) for k in jproc.keys()]
    # the first action seed (in the reference's own proposal stream) whose
    # draws repeat an index
    seed = next(
        a.seed
        for s in range(100)
        for a in JS.SyntheticAgentTask(spec).propose_actions(None, s)
        if any(np.unique(i).size < i.size for i in _heap_draws(spec, a.seed, keys).values())
    )
    JS.SyntheticAgentTask(spec).apply_action(
        J.Sandbox(jfs, jproc), JS.archetypes.Action(seed=seed, readonly=True))
    SyntheticAgentTask(spec).apply_action(Sandbox(tfs, tproc), Action(seed=seed, readonly=True))
    assert sorted(jproc.keys()) == sorted(tproc.keys())
    for k in jproc.keys():
        assert _host(tproc.get(k)).tobytes() == jproc.get(k).tobytes(), k
    assert int(tproc.get("cursor")[0]) == 1


def test_last_writes_is_numpy_fancy_assignment():
    rng = np.random.default_rng(0)
    for n, size in ((1, 4), (50, 8), (1000, 300), (4096, 1 << 20)):
        idx = rng.integers(0, size, size=n)
        vals = rng.standard_normal(n).astype(np.float32)
        want = np.zeros(size, np.float32)
        want[idx] = vals
        u_idx, u_vals = last_writes(idx, vals, size)
        assert np.unique(u_idx).size == u_idx.size
        got = torch.zeros(size)
        got[torch.from_numpy(u_idx)] = torch.from_numpy(u_vals)
        assert got.numpy().tobytes() == want.tobytes()


def test_build_sandbox_state_matches_the_reference():
    """Same repo files, same heap bytes and hot keys as the reference."""
    for name, spec in ARCHETYPES.items():
        if spec.heap_mb > 8:
            continue
        jfs, tfs = J.DeltaFS(chunk_bytes=4096), DeltaFS(chunk_bytes=4096)
        jproc = JS.build_sandbox_state(JS.ARCHETYPES[name], jfs, seed=5)
        tproc = build_sandbox_state(spec, tfs, seed=5, device="cpu")
        assert tproc.hot_keys == jproc.hot_keys
        assert tproc.device.type == "cpu"
        for k in jproc.keys():
            assert _host(tproc.get(k)).tobytes() == jproc.get(k).tobytes()
        assert sorted(tfs.keys()) == sorted(jfs.keys())
        for k in jfs.keys():
            assert tfs.read(k).tobytes() == jfs.read(k).tobytes()


def test_phase7_rehearsal_on_the_cpu():
    """``chip_smoke.py``'s phase 7 at a tiny size on the CPU: its gates
    (zero-copy forks, tail-page CoW counts, byte-identical slow restores
    decoding what a fast fork decodes, free pages back to their count,
    forks that move no chunk byte, every dump landed, the committed heap
    restored byte-identical, the losers' storage freed) run in tier-1."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.run_search_path(
        "cpu", config="qwen3-14b-tiny", num_pages=64, page_size=4, max_pages=16,
        prompt_len=9, iterations=4, rl_widths=(1, 4))
    search, rl = out["decode_search"], out["rl_fanout"]
    for driver in ("serial", "parallel"):
        assert search[driver]["nodes"] >= 4 and search[driver]["iterations"] == 4
        assert search[driver]["best_leaf"]["path"] == "slow"
    assert search["parallel"]["forks"] == 4
    assert search["first_divergent_writes"].get("1 copies", 0) > 0
    assert search["free_pages"] == 60 and search["dump_failures"] == 0
    assert len(search["fanout"]["streams"]) == 4
    assert sorted(rl["widths"]) == [1, 4] and rl["burst"]["children"] == 4
    assert rl["commit"]["loser_bytes_freed"] > 0
