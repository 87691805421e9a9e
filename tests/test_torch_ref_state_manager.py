"""StateManager: coupled protocol, failure handling, LW replay, isolation, GC."""
import numpy as np
import pytest

from repro_torch.core import (
    CheckpointError,
    CowArrayState,
    DeltaCR,
    DeltaFS,
    InferenceProxy,
    Sandbox,
    StateManager,
    reachability_gc,
    recency_gc,
)


def _mk(template_pool=8, fail_dump=None):
    fs = DeltaFS(chunk_bytes=256)
    fs.write("repo/f", np.arange(100, dtype=np.int32))
    proc = CowArrayState({"heap": np.zeros(100, np.float32)})
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: CowArrayState({k: v.copy() for k, v in p.items()}),
        template_pool_size=template_pool,
    )
    sb = Sandbox(fs, proc)
    sm = StateManager(sb, cr, fail_dump_for_test=fail_dump)
    return sm, sb, cr


def test_coupled_checkpoint_restore():
    sm, sb, cr = _mk()
    c1 = sm.checkpoint()
    sb.fs.write("repo/f", np.zeros(100, np.int32))
    sb.proc.mutate("heap", lambda h: h.__setitem__(0, 5.0))
    c2 = sm.checkpoint()
    sm.restore(c1)
    # both dimensions restored jointly — no mismatched (fs, proc) pair
    assert sb.fs.read("repo/f")[0] == 0 and sb.fs.read("repo/f")[99] == 99
    assert sb.proc.get("heap")[0] == 0.0
    sm.restore(c2)
    assert sb.fs.read("repo/f")[99] == 0
    assert sb.proc.get("heap")[0] == 5.0


def test_dump_failure_rolls_back_fs():
    """§4.3: a failed dump must not leave a half-registered checkpoint."""
    sm, sb, cr = _mk(fail_dump=lambda cid: cid == 2)
    c1 = sm.checkpoint()
    gens_before = sb.fs.checkpoint_gen
    keys_before = sb.fs.keys()
    with pytest.raises(CheckpointError):
        sm.checkpoint()
    assert 2 not in sm.nodes
    assert sb.fs.keys() == keys_before
    # sandbox still usable: next checkpoint succeeds
    c3 = sm.checkpoint()
    assert sm.restore(c1) in ("fast", "slow")


def test_dump_failure_preserves_upper_writes():
    """Regression: the abort rollback used to switch to ``config[:-1]``,
    silently discarding the just-frozen upper's writes — the live session
    then diverged from the filesystem.  Writes must survive the abort."""
    sm, sb, cr = _mk(fail_dump=lambda cid: cid == 2)
    c1 = sm.checkpoint()
    sb.fs.write("repo/dirty", np.full(16, 7, np.int32))        # upper-layer write
    sb.fs.write("repo/f", np.full(100, 3, np.int32))           # overwrite
    with pytest.raises(CheckpointError):
        sm.checkpoint()
    # every pre-abort write is still visible to the session
    assert sb.fs.read("repo/dirty")[0] == 7
    assert sb.fs.read("repo/f")[0] == 3
    # and the sandbox remains fully usable: checkpoint + restore round-trip
    c3 = sm.checkpoint()
    sm.restore(c1)
    assert not sb.fs.exists("repo/dirty")
    assert sb.fs.read("repo/f")[99] == 99
    sm.restore(c3)
    assert sb.fs.read("repo/dirty")[0] == 7 and sb.fs.read("repo/f")[0] == 3
    sb.fs.debug_validate()


def test_root_is_cached_and_correct():
    sm, sb, cr = _mk()
    assert sm.root() is None
    c1 = sm.checkpoint()
    ids = [sm.checkpoint() for _ in range(5)]
    assert sm.root().ckpt_id == c1
    # still the same object after restores / more checkpoints
    sm.restore(ids[0])
    sm.checkpoint()
    assert sm.root().ckpt_id == c1


def test_quiesce_required():
    sm, sb, cr = _mk()
    proxy = InferenceProxy(lambda p: p, latency_s=0.2)
    sb.proxy = proxy
    fut = proxy.submit(0, {"x": 1})
    with pytest.raises(CheckpointError):
        sm.checkpoint()
    fut.result()
    assert proxy.quiesced()
    sm.checkpoint()         # fine once quiesced
    proxy.stop()


def test_lightweight_checkpoint_replay():
    sm, sb, cr = _mk()
    applied = []

    def applier(sandbox, action):
        applied.append(action)
        sandbox.proc.set("marker", np.array([action]))

    sm.action_applier = applier
    c1 = sm.checkpoint()
    lw1 = sm.checkpoint(lightweight=True, actions=(10,))
    lw2 = sm.checkpoint(lightweight=True, actions=(20,))
    mode = sm.restore(lw2)
    assert mode.endswith("+replay")
    assert applied == [10, 20]          # replayed in order on the parent state
    assert sb.proc.get("marker")[0] == 20


def test_isolated_eval_undoes_side_effects():
    sm, sb, cr = _mk()
    sm.checkpoint()

    def noisy_eval(sandbox):
        sandbox.fs.write("repo/__pycache__", np.ones(4, np.int8))
        sandbox.proc.set("junk", np.ones(4))
        return 0.7

    v = sm.isolated_eval(noisy_eval)
    assert v == 0.7
    assert not sb.fs.exists("repo/__pycache__")
    assert "junk" not in list(sb.proc.keys())
    # transient pre-test node removed from the index tree
    assert all(not n.lightweight or n.replay_actions for n in sm.live_nodes())


def test_reachability_gc_keeps_selectable_nodes():
    sm, sb, cr = _mk()
    root = sm.checkpoint()
    kids = []
    for i in range(4):
        sm.restore(root)
        sb.proc.mutate("heap", lambda h, i=i: h.__setitem__(i, float(i)))
        kids.append(sm.checkpoint())
    # mark two exhausted+terminal, one exhausted only, one selectable
    sm.nodes[kids[0]].terminal = True
    sm.nodes[kids[0]].expandable = False
    sm.nodes[kids[1]].expandable = False          # dead branch
    sm.nodes[kids[2]].expandable = True
    cr.wait_dumps()
    reclaimed = reachability_gc(sm)
    assert kids[1] in reclaimed                    # unreachable: reclaimed
    assert kids[0] not in reclaimed                # terminal candidate kept
    assert kids[2] not in reclaimed                # still selectable
    # GC safety: every survivor restores fine
    for node in sm.live_nodes():
        if not node.lightweight:
            sm.restore(node.ckpt_id)


def test_recency_gc():
    sm, sb, cr = _mk()
    ids = [sm.checkpoint() for _ in range(10)]
    cr.wait_dumps()
    reclaimed = recency_gc(sm, keep_last=3)
    assert len(reclaimed) > 0
    assert ids[-1] not in reclaimed


def test_restore_determinism_across_paths():
    """Fast-path and slow-path restores must produce identical state."""
    sm, sb, cr = _mk(template_pool=1)
    sb.proc.mutate("heap", lambda h: h.__setitem__(0, 42.0))
    c1 = sm.checkpoint()
    fast, mode1 = cr.restore(1)
    assert mode1 == "fast"
    a_fast = fast.get("heap").copy()
    cr.checkpoint(sb.proc, 99, None)   # evict c1's template (pool=1)
    assert not cr.has_template(1)
    slow, mode2 = cr.restore(1)
    assert mode2 == "slow"
    np.testing.assert_array_equal(a_fast, slow.get("heap"))
