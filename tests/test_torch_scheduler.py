"""The serving scheduler and the decode search of the port.

The scheduler cases of the JAX package's ``tests/test_serve.py``, the
scheduler and divergent-fork cases of ``tests/test_decode_fork.py`` and
both cases of ``tests/test_system.py`` run on the port, and two
differentials drive both packages on the same weights (the JAX params
through numpy into ``convert.params_from_numpy``): one list of scheduler
submits, forks, steps, suspends and resumes, and a serial MCTS over
``DecodeSearchTask``.  Logits agree within 1e-4 (float32 tiny configs; the
packages sum in different orders), token streams and pool statistics
exactly.  Both packages' DeltaCRs run without async warm, so page
accounting does not depend on thread timing.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError

import jax
import numpy as np
import torch

import repro.core as J
import repro.search as JS
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import PagePool as JPagePool
from repro.serve import PagedSession as JPagedSession
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro_torch.configs import get_config
import repro_torch.core as T
from repro_torch.core import (
    DeltaCR,
    DeltaFS,
    DumpPolicy,
    Sandbox,
    SandboxTree,
    StateManager,
    reachability_gc,
    recover,
    save_state,
)
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.deltafs import read_meta_array
from repro_torch.models import Model
from repro_torch.search import MCTS, DecodeSearchTask, MCTSConfig, decode_fanout
from repro_torch.serve import (
    Engine,
    PagePool,
    PagedSession,
    SamplingParams,
    Scheduler,
    SchedulerConfig,
)

torch.set_num_threads(1)

TOL = 1e-4
ARCHS = ["olmo-1b-tiny", "qwen3-14b-tiny"]


def _build(name, key=0):
    cfg = get_config(name)
    jmodel = JModel(j_get_config(name))
    jparams = jmodel.init(jax.random.PRNGKey(key))
    tree = jax.tree.map(np.asarray, jparams)
    model = Model(cfg, device="cpu", params=params_from_numpy(tree, device="cpu"))
    return cfg, jmodel, jparams, model


@pytest.fixture(scope="module", params=ARCHS)
def rig(request):
    return _build(request.param)


def _pool(cfg, num_pages, max_pages=8, page_size=8):
    return PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device="cpu")


def _cr(pool, **kw):
    return DeltaCR(
        template_pool_size=8,
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        **kw,
    )


# ---------------------------------------------------------------------------
# the scheduler cases of the JAX package's tests/test_serve.py
# ---------------------------------------------------------------------------
def test_scheduler_continuous_batching_and_suspension(rig):
    """Continuous batching + DeltaCR-backed suspension under page pressure."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 14)
    eng = Engine(model, pool)
    cr = _cr(pool)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, min_free_pages=2,
                                               auto_suspend_free_pages=6))
    [sched.submit([1, 2, 3, 4, 5], SamplingParams(seed=i)) for i in range(4)]
    for _ in range(6):
        out = sched.step()
        assert out
    # page pressure: admitting more forces LRU suspension
    [sched.submit([9, 8, 7], SamplingParams(seed=10 + i)) for i in range(3)]
    assert sched.suspensions >= 1
    suspended = [h.sid for h in sched.handles.values() if h.state == "suspended"]
    assert suspended
    # suspended sessions hold no pages but resume with identical state
    target = suspended[0]
    sched.resume(target)
    h = sched.handles[target]
    assert h.state == "active" and h.session is not None
    # deterministic rollback: continue decoding fine
    for _ in range(2):
        sched.step()
    for sid in list(sched.handles):
        if sched.handles[sid].state != "finished":
            sched.finish(sid)
    cr.shutdown()


def test_scheduler_admits_forked_children(rig):
    """Externally forked sessions (SandboxTree children) join scheduling:
    they batch, suspend, and resume like scheduler-born sessions."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 32)
    eng = Engine(model, pool)
    cr = _cr(pool)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, min_free_pages=2,
                                               auto_suspend_free_pages=2))
    parent = sched.submit([1, 2, 3, 4, 5], SamplingParams(seed=0))
    sched.step()
    # fan-out forked outside the scheduler (what a SandboxTree child's proc is)
    ext = sched.handles[parent].session.fork()
    free_before = pool.free_pages()
    sid = sched.admit_forked(ext)
    assert pool.free_pages() == free_before           # adoption allocates nothing
    h = sched.handles[sid]
    assert h.state == "active" and h.session is ext
    out = sched.step()
    assert sid in out                                 # batches like any session
    # full lifecycle: suspend via DeltaCR, resume, finish
    sched.suspend(sid, keep_template=True)
    assert sched.handles[sid].state == "suspended"
    sched.resume(sid)
    assert sched.handles[sid].state == "active"
    for s in list(sched.handles):
        sched.finish(s)
    cr.shutdown()


def test_scheduler_dump_timeout_counted_and_eviction_deferred(rig):
    """A dump that misses dump_timeout_s is never swallowed: it is counted,
    the template survives until the dump lands, and the deferred eviction
    drains once it does."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 32)
    eng = Engine(model, pool)
    cr = _cr(pool)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, min_free_pages=2,
                                               dump_timeout_s=0.05))
    sid = sched.submit([1, 2, 3, 4, 5], SamplingParams(seed=0))
    sched.step()
    # wedge the FIFO dump worker so the suspend's dump cannot land in time
    gate = threading.Event()
    cr._dump_worker.submit(gate.wait, 30.0)
    sched.suspend(sid, urgent=True)
    h = sched.handles[sid]
    assert sched.dump_timeouts == 1               # counted, not swallowed
    assert h.state == "suspended"
    assert cr.has_template(h.ckpt_id)             # template NOT evicted early
    health = sched.health()
    assert health["scheduler_dump_timeouts"] == 1
    assert health["pending_evictions"] == 1
    gate.set()                                    # un-wedge: dump can land
    cr.wait_dumps()
    assert sched._drain_suspends(block=True) >= 1
    assert not cr.has_template(h.ckpt_id)         # deferred eviction landed
    sched.resume(sid)                             # slow path restores fine
    assert sched.handles[sid].state == "active"
    sched.finish(sid)
    cr.shutdown()


def test_scheduler_dump_timeout_policy_raise(rig):
    """dump_timeout_policy='raise' surfaces the timeout to the caller while
    still keeping the handle restorable (template alive, eviction queued)."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 32)
    eng = Engine(model, pool)
    cr = _cr(pool)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, min_free_pages=2,
                                               dump_timeout_s=0.05,
                                               dump_timeout_policy="raise"))
    sid = sched.submit([9, 8, 7], SamplingParams(seed=1))
    sched.step()
    gate = threading.Event()
    cr._dump_worker.submit(gate.wait, 30.0)
    with pytest.raises(FuturesTimeoutError):
        sched.suspend(sid, urgent=True)
    assert sched.dump_timeouts == 1
    h = sched.handles[sid]
    assert h.state == "suspended" and cr.has_template(h.ckpt_id)
    gate.set()
    cr.wait_dumps()
    sched._drain_suspends(block=True)
    sched.resume(sid)
    assert sched.handles[sid].state == "active"
    sched.finish(sid)
    cr.shutdown()


def test_scheduler_warm_pool_survives_restart(rig, tmp_path):
    """Persistence plane end-to-end: suspended sessions are checkpointed to
    the manifest on coalesced suspends; a fresh scheduler (fresh process
    analogue) recovers them and resumes byte-identical decoding."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 32)
    eng = Engine(model, pool)
    cr = _cr(pool)
    root = str(tmp_path / "warm-pool")
    sched = Scheduler(
        eng,
        cr,
        SchedulerConfig(max_batch=4, min_free_pages=2, auto_suspend_free_pages=2,
                        persist_path=root),
    )
    a = sched.submit([1, 2, 3, 4, 5], SamplingParams(seed=1))
    b = sched.submit([5, 4, 3], SamplingParams(seed=2))
    for _ in range(3):
        sched.step()
    tokens_a = list(sched.handles[a].session.tokens)
    sched.suspend(a)                      # coalesced: dump queued, evict deferred
    cr.wait_dumps()
    assert sched._drain_suspends() >= 1   # dump landed → manifest committed
    assert sched.plane is not None and sched.plane.last_seq() is not None
    # continue the survivor, then "crash": tear everything down
    sched.step()
    sched.finish(b)
    cr.shutdown()

    # fresh scheduler over the same engine/pool recovers the warm pool
    pool2 = _pool(cfg, 32)
    eng2 = Engine(model, pool2)
    restore2 = lambda p: PagedSession.restore_from_payload(pool2, p)  # noqa: E731
    sched2 = Scheduler.recover(eng2, root, restore_fn=restore2)
    recovered = [h for h in sched2.handles.values() if h.state == "suspended"]
    assert [h.sid for h in recovered] == [a]
    sched2.resume(a)
    h = sched2.handles[a]
    assert h.state == "active" and h.session is not None
    assert list(h.session.tokens) == tokens_a     # byte-identical rollback
    out = sched2.step()                           # and it decodes again
    assert a in out
    new_sid = sched2.submit([7, 7], SamplingParams(seed=3))
    assert new_sid > a                            # sid counter resumed past recovery
    for s in list(sched2.handles):
        if sched2.handles[s].state != "finished":
            sched2.finish(s)
    sched2.cr.shutdown()


def _warm_pool_world(port, rig, root):
    """The warm-pool restart of one package: what the suspended session
    held, what the recovered scheduler holds, and what it decodes."""
    cfg, jmodel, jparams, model = rig
    if port:
        mk_pool = lambda: _pool(cfg, 32)  # noqa: E731
        mk_eng = lambda pool: Engine(model, pool)  # noqa: E731
        restore_of = PagedSession.restore_from_payload
        S, SC, sp, DCR = Scheduler, SchedulerConfig, SamplingParams, DeltaCR
    else:
        mk_pool = lambda: JPagePool(j_get_config(cfg.name), num_pages=32, page_size=8,  # noqa: E731
                                    max_pages_per_session=8)
        mk_eng = lambda pool: JEngine(jmodel, jparams, pool)  # noqa: E731
        restore_of = JPagedSession.restore_from_payload
        S, SC, sp, DCR = JScheduler, JSchedulerConfig, JSamplingParams, J.DeltaCR
    pool = mk_pool()
    cr = DCR(template_pool_size=8, async_warm=False,
             restore_fn=lambda p: restore_of(pool, p))
    sched = S(mk_eng(pool), cr, SC(max_batch=4, min_free_pages=2, auto_suspend_free_pages=2,
                                   persist_path=root))
    a = sched.submit([1, 2, 3, 4, 5], sp(temperature=0.8, seed=1))
    b = sched.submit([5, 4, 3], sp(seed=2))
    for _ in range(3):
        sched.step()
    before = list(sched.handles[a].session.tokens)
    sched.suspend(a)
    cr.wait_dumps()
    sched._drain_suspends()
    # the doc's byte count carries timing floats (wall_ms, ...); the pack's
    # bytes and chunk count do not
    saved = {k: v for k, v in sched.health().items()
             if k.startswith("persist_") and k != "persist_last_bytes"}
    saved.update({k: sched.plane.last_save_stats[k] for k in ("pack_bytes", "new_chunks")})
    sched.finish(b)
    cr.shutdown()
    pool2 = mk_pool()
    sched2 = S.recover(mk_eng(pool2), root, restore_fn=lambda p: restore_of(pool2, p))
    handles = sorted((h.sid, h.state, h.ckpt_id) for h in sched2.handles.values())
    sched2.resume(a)
    after = list(sched2.handles[a].session.tokens)
    decoded = [sched2.step()[a] for _ in range(4)]
    sched2.finish(a)
    sched2.cr.shutdown()
    return before, saved, handles, after, decoded


def test_warm_pool_recovery_matches_the_reference(rig, tmp_path):
    """The same warm-pool restart in both packages, on the same weights and
    sampling: equal saved-plane health, recovered handles, resumed tokens
    and the tokens decoded after the resume."""
    want = _warm_pool_world(False, rig, str(tmp_path / "reference"))
    got = _warm_pool_world(True, rig, str(tmp_path / "port"))
    assert got == want
    assert want[1]["persist_saves"] == 1 and want[1]["persist_last_kind"] == "full"


def test_scheduler_config_matches_the_reference():
    """The port keeps every field of the reference's config, with the
    reference's defaults."""
    got = dataclasses.asdict(SchedulerConfig())
    want = dataclasses.asdict(JSchedulerConfig())
    assert got == want
    assert list(got) == list(want)


# ---------------------------------------------------------------------------
# the scheduler and divergent-fork cases of tests/test_decode_fork.py
# ---------------------------------------------------------------------------
def _mk_tree(pool, sess, *, dump=True):
    """Wrap a live session as the trunk of a SandboxTree."""
    # no async warm: deterministic block accounting
    cr = _cr(pool, async_warm=False, policy=DumpPolicy(stream=dump))
    fs = DeltaFS(chunk_bytes=256)
    sm = StateManager(Sandbox(fs, sess), cr)
    return SandboxTree(sm), sm, cr


def _decode_streams(eng, sessions, k):
    """k batched greedy steps; returns per-session token lists."""
    out = [[] for _ in sessions]
    for _ in range(k):
        for i, t in enumerate(eng.step(sessions)):
            out[i].append(int(t))
    return out


def test_divergent_forks_match_divergent_prefills(rig):
    """Force-feeding each child a different action (the search-step
    divergence) still matches a fresh prefill force-fed the same action."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 96, max_pages=16)
    eng = Engine(model, pool)
    n, k = 3, 4
    actions = [3, 7, 11]

    sess = eng.new_session(list(range(2, 13)))
    eng.generate(sess, 2)
    prefix = list(sess.tokens[:-1])
    tree, sm, cr = _mk_tree(pool, sess, dump=False)
    ck = sm.checkpoint(dump=False)

    kids = tree.fork(ck, n)
    for kid, a in zip(kids, actions):
        # overwrite the *pending* token: its K/V is not yet written, so this
        # is the cause of the first divergent write, not a write itself
        kid.proc.tokens[-1] = a
    forked = _decode_streams(eng, [kid.proc for kid in kids], k)
    assert len({tuple(s) for s in forked}) == n  # streams actually diverged

    fresh = [eng.new_session(prefix) for _ in range(n)]
    for f, a in zip(fresh, actions):
        f.tokens[-1] = a
    fresh_streams = _decode_streams(eng, fresh, k)

    assert forked == fresh_streams
    for f in fresh:
        f.release()
    tree.release_all()
    cr.shutdown()


def test_scheduler_fanout_matches_direct_decode(rig):
    """The whole serving loop — fork_sandboxes + admit_forked + continuous
    batching — lands the same tokens as direct batched engine stepping."""
    cfg, _, _, model = rig
    pool = _pool(cfg, 96, max_pages=16)
    eng = Engine(model, pool)
    n, k = 4, 5
    actions = [2, 5, 9, 13]

    sess = eng.new_session(list(range(1, 10)))
    eng.generate(sess, 2)
    prefix = list(sess.tokens[:-1])
    tree, sm, cr = _mk_tree(pool, sess, dump=False)
    ck = sm.checkpoint(dump=False)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=8, min_free_pages=2,
                                               auto_suspend_free_pages=2))

    streams, _, _ = decode_fanout(tree, ck, n, sched, k, actions=actions)

    fresh = [eng.new_session(prefix) for _ in range(n)]
    for f, a in zip(fresh, actions):
        f.tokens[-1] = a
    fresh_streams = _decode_streams(eng, fresh, k)

    assert streams == fresh_streams
    for f in fresh:
        f.release()
    tree.release_all()
    pool.debug_validate()
    cr.shutdown()


# ---------------------------------------------------------------------------
# the JAX package's tests/test_system.py
# ---------------------------------------------------------------------------
class LMTask:
    def __init__(self, engine, tokens_per_action=3):
        self.engine = engine
        self.n = tokens_per_action

    def propose_actions(self, sandbox, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return [int(s) for s in rng.integers(0, 1 << 30, size=2)]

    def apply_action(self, sandbox, action):
        sess = sandbox.proc
        sess.extras["rng_seed"] = np.asarray([action], np.int64)
        sess.extras["rng_counter"] = np.asarray([0], np.int64)
        for _ in range(self.n):
            self.engine.step([sess])
        sandbox.fs.write("repo/traj", np.asarray(sess.tokens, np.int64))

    replay_action = apply_action

    def evaluate(self, sandbox):
        return float(sandbox.proc.tokens[-1] % 97) / 97.0

    def is_terminal(self, sandbox):
        return sandbox.proc.seq_len > 64

    def is_readonly(self, action):
        return False


# ---------------------------------------------------------------------------
# the recovered-trunk case of tests/test_decode_fork.py (olmo)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def olmo_rig():
    return _build("olmo-1b-tiny")


def test_recovered_trunk_decodes_without_manual_restore(olmo_rig, tmp_path):
    cfg, _, _, model = olmo_rig
    pool = _pool(cfg, 96, max_pages=16)
    eng = Engine(model, pool)

    sess = eng.new_session([5, 4, 3, 2, 1])
    eng.generate(sess, 3)
    tree, sm, cr = _mk_tree(pool, sess)
    ck = sm.checkpoint()
    cr.wait_dumps()
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    expected = eng.step([sess])[0]               # the token the trunk lands next

    # fresh process analogue: new pool + engine, recover, decode immediately
    pool2 = _pool(cfg, 96, max_pages=16)
    eng2 = Engine(model, pool2)
    rec = recover(root, restore_fn=lambda p: PagedSession.restore_from_payload(pool2, p),
                  device="cpu")
    assert rec.trunk_restore_mode == "slow"      # recovered CR has images only
    trunk = rec.state_manager.sandbox.proc
    assert isinstance(trunk, PagedSession)
    got = eng2.step([trunk])[0]
    assert got == expected
    cr.shutdown()
    rec.deltacr.shutdown()


def _trunk_root(port, rig, root):
    """Save a decoded trunk session of one package; returns the tokens its
    next greedy steps decode (before any crash)."""
    cfg, jmodel, jparams, model = rig
    if port:
        pool = _pool(cfg, 96, max_pages=16)
        eng = Engine(model, pool)
        pkg, restore_of = T, PagedSession.restore_from_payload
    else:
        pool = JPagePool(j_get_config(cfg.name), num_pages=96, page_size=8,
                         max_pages_per_session=16)
        eng = JEngine(jmodel, jparams, pool)
        pkg, restore_of = J, JPagedSession.restore_from_payload
    sess = eng.new_session([5, 4, 3, 2, 1])
    eng.generate(sess, 3)
    cr = pkg.DeltaCR(template_pool_size=8, async_warm=False,
                     restore_fn=lambda p: restore_of(pool, p))
    sm = pkg.StateManager(pkg.Sandbox(pkg.DeltaFS(chunk_bytes=256), sess), cr)
    sm.checkpoint()
    cr.wait_dumps()
    pkg.save_state(root, sm=sm)
    want = [int(eng.step([sess])[0]) for _ in range(3)]
    cr.shutdown()
    return want


def _recovered_tokens(port, rig, root):
    """Recover ``root`` with one package and decode 3 greedy steps."""
    cfg, jmodel, jparams, model = rig
    if port:
        pool = _pool(cfg, 96, max_pages=16)
        eng = Engine(model, pool)
        rec = recover(root, restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
                      device="cpu")
    else:
        pool = JPagePool(j_get_config(cfg.name), num_pages=96, page_size=8,
                         max_pages_per_session=16)
        eng = JEngine(jmodel, jparams, pool)
        rec = J.recover(root, restore_fn=lambda p: JPagedSession.restore_from_payload(pool, p))
    trunk = rec.state_manager.sandbox.proc
    got = [int(eng.step([trunk])[0]) for _ in range(3)]
    rec.deltacr.shutdown()
    return rec.trunk_restore_mode, got


def test_recovered_trunk_matches_the_reference(olmo_rig, tmp_path):
    """Both packages recover a saved trunk and decode the tokens it decoded
    before the crash; the port also recovers the reference's root."""
    j_root, t_root = str(tmp_path / "reference"), str(tmp_path / "port")
    want = _trunk_root(False, olmo_rig, j_root)
    assert _trunk_root(True, olmo_rig, t_root) == want
    assert _recovered_tokens(False, olmo_rig, j_root) == ("slow", want)
    assert _recovered_tokens(True, olmo_rig, t_root) == ("slow", want)
    assert _recovered_tokens(True, olmo_rig, j_root) == ("slow", want)


@pytest.fixture(scope="module")
def system_rig():
    cfg, _, _, model = _build("olmo-1b-tiny", key=3)
    pool = PagePool(cfg, num_pages=512, page_size=8, max_pages_per_session=24, device="cpu")
    return Engine(model, pool), pool


def test_full_agent_search_workflow(system_rig):
    engine, pool = system_rig
    fs = DeltaFS(chunk_bytes=2048)
    fs.write("repo/src", np.arange(5000, dtype=np.int32))
    session = engine.new_session([1, 2, 3], SamplingParams(temperature=0.9, seed=1))
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        template_pool_size=4,                     # small pool → real evictions
    )
    sm = StateManager(Sandbox(fs, session), cr)
    task = LMTask(engine)
    sm.action_applier = lambda sb, act: task.replay_action(sb, act)

    mcts = MCTS(sm, task, MCTSConfig(iterations=14, value_isolation=False, seed=2))
    st = mcts.run()
    cr.wait_dumps()

    assert st.nodes >= 10
    assert st.restores > 0
    # small template pool must have forced at least one slow-path restore
    # (eviction fallback) over 14 iterations of tree search
    assert cr.stats.evictions > 0

    # coupled-consistency: fs "traj" must equal the session tokens at every
    # live full node
    for node in sm.live_nodes():
        if node.lightweight or node.ckpt_id == 1:
            continue
        sm.restore(node.ckpt_id)
        fs_traj = list(sm.sandbox.fs.read("repo/traj"))
        assert fs_traj == sm.sandbox.proc.tokens, "fs/proc dimensions diverged!"

    # GC then every survivor still restores
    reachability_gc(sm)
    survivors = [n for n in sm.live_nodes() if not n.lightweight]
    for node in survivors:
        sm.restore(node.ckpt_id)
    fs.debug_validate()
    # refcount hygiene: no page leaked beyond live sessions/templates
    assert pool.free_pages() > 0
    cr.shutdown()


def test_fork_divergence_and_page_refcounts(system_rig):
    engine, pool = system_rig
    base = engine.new_session([9, 8, 7], SamplingParams(temperature=1.0, seed=5))
    engine.generate(base, 5)
    before_free = pool.free_pages()
    forks = [base.fork() for _ in range(6)]
    for i, f in enumerate(forks):
        f.extras["rng_seed"] = np.asarray([100 + i], np.int64)
        f.extras["rng_counter"] = np.asarray([0], np.int64)
        engine.generate(f, 8)
    # distinct seeds → (almost surely) diverged trajectories
    tails = {tuple(f.tokens[-6:]) for f in forks}
    assert len(tails) > 1
    # base unaffected
    assert len(base.tokens) == 3 + 5   # prompt + 5 generated (last pending)
    for f in forks:
        f.release()
    base.release()
    assert pool.free_pages() >= before_free


# ---------------------------------------------------------------------------
# both packages' schedulers under one op list
# ---------------------------------------------------------------------------
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _bytes(x):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _drop_patched_generations(cr, jcr, patched) -> int:
    """A generation that a patched slow restore of the port registered
    rests on a fork of the restored session, where the JAX package's
    decode registers host grids that hold no page.  Each such fork holds
    its own image, byte for byte: length, tokens and every page's K/V as
    the store has them.  The generation then leaves both packages' caches,
    so that the page refcounts compare as they stand.  Returns the forks
    checked."""
    checked = 0
    for image_id in sorted(patched):
        with cr.pipeline._lock:
            rec = cr.pipeline._gens.get(image_id)
        image = cr.images.get(image_id)
        if rec is not None and image is not None:
            got = rec.anchor.dump_payload()
            held = {n for n in got if n.startswith(("kv/", "meta/"))}
            assert held == {n for n in image.entries if n.startswith(("kv/", "meta/"))}
            for name in held:
                want = read_meta_array(cr.store, image.entries[name])
                np.testing.assert_array_equal(_bytes(got[name]), _bytes(want))
            checked += 1
        cr.pipeline.evict(image_id)
        jcr.pipeline.evict(image_id)
    patched.clear()
    return checked


def test_scheduler_matches_the_reference(rig, monkeypatch):
    """The same submits, steps, forks, suspends (coalesced, urgent and
    forced by page pressure), resumes and finishes give equal token
    streams, handle states, pool statistics and page references in both
    packages (the port's patched restores' generations, which rest on
    forks, are checked and dropped from both caches first)."""
    cfg, jmodel, jparams, model = rig
    patched = set()
    patch_restore = DeltaCR._patch_restore

    def noting(self, ckpt_id, image):
        state = patch_restore(self, ckpt_id, image)
        if state is not None:
            patched.add(image.image_id)
        return state

    monkeypatch.setattr(DeltaCR, "_patch_restore", noting)
    anchors_checked = [0]
    worlds = []
    for port in (False, True):
        if port:
            pool = _pool(cfg, 16)
            eng = Engine(model, pool)
            cr = _cr(pool, async_warm=False)
            sched = Scheduler(eng, cr, SchedulerConfig(max_batch=3, min_free_pages=2,
                                                       auto_suspend_free_pages=5))
            sp = SamplingParams
        else:
            pool = JPagePool(j_get_config(cfg.name), num_pages=16, page_size=8,
                             max_pages_per_session=8)
            eng = JEngine(jmodel, jparams, pool)
            cr = J.DeltaCR(
                template_pool_size=8, async_warm=False,
                restore_fn=lambda p, pool=pool: JPagedSession.restore_from_payload(pool, p),
            )
            sched = JScheduler(eng, cr, JSchedulerConfig(max_batch=3, min_free_pages=2,
                                                         auto_suspend_free_pages=5))
            sp = JSamplingParams
        worlds.append((pool, eng, cr, sched, sp))

    def both(fn):
        """Run one op on both worlds, every dump landed after it."""
        outs = []
        for pool, eng, cr, sched, sp in worlds:
            outs.append(fn(sched, sp))
            cr.wait_dumps()
        return outs

    def check(outs):
        want, got = outs
        assert got == want
        (jpool, jeng, jcr, jsched, _), (pool, eng, cr, sched, _) = worlds
        assert vars(pool.stats) == vars(jpool.stats)
        anchors_checked[0] += _drop_patched_generations(cr, jcr, patched)
        np.testing.assert_array_equal(pool.refs, jpool.refs)
        assert {s: h.state for s, h in sched.handles.items()} == \
            {s: h.state for s, h in jsched.handles.items()}
        for s, h in sched.handles.items():
            if h.session is not None:
                jh = jsched.handles[s]
                assert h.session.tokens == jh.session.tokens
                _close(h.session.extras["last_logits"], jh.session.extras["last_logits"])

    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 6, 1, 2, 7, 9, 3, 5], [11, 3]]
    sids = both(lambda s, sp: [s.submit(p, sp(temperature=0.8 * (i % 2), seed=i))
                               for i, p in enumerate(prompts[:3])])
    check(sids)
    for _ in range(4):
        check(both(lambda s, sp: s.step()))
    check(both(lambda s, sp: s.fork(1)))
    check(both(lambda s, sp: s.step()))
    check(both(lambda s, sp: s.suspend(2)))                 # coalesced: eviction deferred
    check(both(lambda s, sp: s.step()))                     # drains the landed dump
    check(both(lambda s, sp: s.submit(prompts[3], sp(seed=7))))  # page pressure
    for _ in range(3):
        check(both(lambda s, sp: s.step()))
    check(both(lambda s, sp: s.suspend(1, urgent=True)))
    check(both(lambda s, sp: s.generate(3, 2)))
    for sid in (2, 1):
        check(both(lambda s, sp: s.resume(sid)))
        check(both(lambda s, sp: s.step()))
    outs = both(lambda s, sp: (s.suspensions, s.resumes, s.step_count,
                               {k: v for k, v in s.health().items()
                                if k in ("suspensions", "resumes", "sessions_active",
                                         "sessions_suspended", "pending_evictions")}))
    check(outs)
    assert outs[1][0] >= 2 and outs[1][1] >= 2
    assert anchors_checked[0] >= 1
    check(both(lambda s, sp: [s.finish(sid) for sid in sorted(s.handles)]))
    for pool, _, cr, _, _ in worlds:
        pool.debug_validate()
        cr.shutdown()


# ---------------------------------------------------------------------------
# both packages' serial MCTS over DecodeSearchTask
# ---------------------------------------------------------------------------
def _decode_search(port, rig, iterations=8):
    """The serial MCTS of one package over its ``DecodeSearchTask``: the
    actions proposed at every node, and every live node's tokens and last
    logits once restored."""
    cfg, jmodel, jparams, model = rig
    if port:
        pool = _pool(cfg, 64, max_pages=6, page_size=4)
        eng = Engine(model, pool)
        cr = DeltaCR(template_pool_size=3, async_warm=False,
                     restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
        pkg, search = (DeltaFS, Sandbox, StateManager), (MCTS, MCTSConfig, DecodeSearchTask)
    else:
        pool = JPagePool(j_get_config(cfg.name), num_pages=64, page_size=4,
                         max_pages_per_session=6)
        eng = JEngine(jmodel, jparams, pool)
        cr = J.DeltaCR(template_pool_size=3, async_warm=False,
                       restore_fn=lambda p: JPagedSession.restore_from_payload(pool, p))
        pkg, search = (J.DeltaFS, J.Sandbox, J.StateManager), (JS.MCTS, JS.MCTSConfig,
                                                               JS.DecodeSearchTask)
    fs_cls, sandbox_cls, sm_cls = pkg
    mcts_cls, cfg_cls, task_cls = search
    sess = eng.new_session([5, 9, 2, 8, 1, 3, 3])
    fs = fs_cls(chunk_bytes=256)
    sm = sm_cls(sandbox_cls(fs, sess), cr)
    task = task_cls(eng, k_tokens=2, width=2)
    proposed = {}
    propose = task.propose_actions

    def logged(sandbox, seed):
        acts = propose(sandbox, seed)
        logits = np.asarray(sandbox.proc.extras["last_logits"], np.float32)
        proposed[sm.current] = (list(acts), np.sort(logits)[::-1][: task.width + 1])
        return acts

    task.propose_actions = logged
    mcts = mcts_cls(sm, task, cfg_cls(iterations=iterations, expand_width=2,
                                      value_isolation=False, seed=4))
    st = mcts.run()
    cr.wait_dumps()
    nodes = {n.ckpt_id: (n.parent_id, n.visits, n.value, n.reclaimed)
             for n in sm.nodes.values()}
    restored = {}
    for n in list(sm.nodes.values()):
        if n.reclaimed:
            continue
        sm.restore(n.ckpt_id)
        proc = sm.sandbox.proc
        restored[n.ckpt_id] = (list(proc.tokens), np.array(proc.extras["last_logits"]))
    counters = (st.iterations, st.nodes, st.restores, st.fast_restores, st.slow_restores,
                st.checkpoints)
    cr.shutdown()
    return counters, nodes, proposed, restored


def test_decode_search_matches_the_reference(rig):
    """Equal MCTS counters, tree, proposed actions and token streams node
    for node, logits within 1e-4.  Where two of the top ``width + 1``
    logits at a node lie within 2e-4, its actions compare as a set."""
    want = _decode_search(False, rig)
    got = _decode_search(True, rig)
    assert got[0] == want[0]
    assert got[0][4] > 0                      # the search took slow restores
    (gn, wn) = got[1], want[1]
    assert sorted(gn) == sorted(wn)
    for c in wn:
        assert gn[c][0] == wn[c][0] and gn[c][1] == wn[c][1] and gn[c][3] == wn[c][3], c
        assert gn[c][2] == pytest.approx(wn[c][2], abs=TOL)
    assert sorted(got[2]) == sorted(want[2])
    for c, (acts, top) in want[2].items():
        gacts, gtop = got[2][c]
        _close(gtop, top)
        if np.min(np.abs(np.diff(top))) < 2 * TOL:
            assert sorted(gacts) == sorted(acts), c
        else:
            assert gacts == acts, c
    assert sorted(got[3]) == sorted(want[3])
    for c, (tokens, logits) in want[3].items():
        assert got[3][c][0] == tokens, c
        _close(got[3][c][1], logits)


# ---------------------------------------------------------------------------
# a session fork racing an async warm of the same session
# ---------------------------------------------------------------------------
def test_session_fork_racing_a_warm_keeps_page_refcounts():
    """A restored session is warmed (its shared tail page privatized) on
    DeltaCR's warm thread while its owner forks it.  The warm is let run
    right after the fork took its page refs and before it copies the page
    table: the table it copies must still be the one it took refs on."""
    cfg = get_config("olmo-1b-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = _pool(cfg, 16)
    eng = Engine(model, pool)
    tmpl = eng.new_session([1, 2, 3, 4, 5])      # tail page part-full
    sess = tmpl.fork()                           # shares every page with tmpl
    start_warm, warm_done = threading.Event(), threading.Event()
    out = []
    forker = threading.Thread(target=lambda: out.append(sess.fork()))
    incref = pool.incref

    def incref_then_let_the_warm_run(pages):
        incref(pages)
        if threading.current_thread() is forker:
            start_warm.set()
            warm_done.wait(0.5)        # blocked for good while the fork holds the pool

    def warm():
        assert start_warm.wait(10)
        sess.warm()
        warm_done.set()

    pool.incref = incref_then_let_the_warm_run
    warmer = threading.Thread(target=warm)
    warmer.start()
    forker.start()
    forker.join(10)
    warmer.join(10)
    assert not warmer.is_alive() and not forker.is_alive()
    assert pool.stats.warm_copies == 1
    want = np.zeros_like(pool.refs)
    want[0] = 1
    for s in (tmpl, sess, out[0]):
        for p in s.active_pages():
            want[p] += 1
    np.testing.assert_array_equal(pool.refs, want)
    for s in (out[0], sess, tmpl):
        s.release()
    pool.debug_validate()
    assert pool.free_pages() == 15


def test_warm_after_release_leaves_the_pool_alone():
    """DeltaCR's warm thread may reach a restored session after its owner
    released it (a leaf torn down at once); the warm must not privatize
    pages the session no longer holds."""
    cfg = get_config("olmo-1b-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = _pool(cfg, 16)
    eng = Engine(model, pool)
    tmpl = eng.new_session([1, 2, 3, 4, 5])      # tail page part-full
    other = tmpl.fork()                          # the tail stays shared after
    sess = tmpl.fork()
    refs = pool.refs.copy()
    sess.release()
    sess.warm()
    assert pool.stats.warm_copies == 0
    refs[tmpl.active_pages()] -= 1
    np.testing.assert_array_equal(pool.refs, refs)
    for s in (other, tmpl):
        s.release()
    pool.debug_validate()
    assert pool.free_pages() == 15
