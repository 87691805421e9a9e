"""The JAX package's ``tests/test_decode_fork.py`` on the port.

Forked decoders must be *indistinguishable* from freshly prefilled ones:
`fork(ckpt, n)` children decoding k greedy tokens produce bit-identical
token streams to n fresh prefills of the same prefix — at the same decode
batch size, so both worlds run the same jit program — while the block
accounting proves the fork itself copied zero KV bytes (CoW pages stay
shared until the first divergent write).

Parametrized over a pure-attention arch (olmo) and a hybrid
attention+recurrent arch (jamba: mamba states ride in session extras —
fork is aliasing, restore is rebinding, and a restored state is uploaded
back to the pool's device).  The port runs on the CPU here, with random
weights drawn by its own ``Model.init``.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    DeltaCR,
    DeltaFS,
    DumpPolicy,
    Sandbox,
    SandboxTree,
    StateManager,
    recover,
    save_state,
)
from repro_torch.models import Model
from repro_torch.serve import Engine, PagePool, PagedSession

torch.set_num_threads(1)

ARCHS = ["olmo-1b-tiny", "jamba-1.5-large-398b-tiny"]


@pytest.fixture(scope="module", params=ARCHS)
def rig(request):
    cfg = get_config(request.param)
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    return cfg, model


def _fresh_pool(cfg, num_pages=96, page_size=8):
    return PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=16, device="cpu")


def _mk_tree(eng, pool, sess, *, dump=True):
    """Wrap a live session as the trunk of a SandboxTree."""
    cr = DeltaCR(
        template_pool_size=8,
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        async_warm=False,            # deterministic block accounting
        policy=DumpPolicy(stream=dump),
    )
    fs = DeltaFS(chunk_bytes=256)
    sm = StateManager(Sandbox(fs, sess), cr)
    return SandboxTree(sm), sm, cr


def _decode_streams(eng, sessions, k):
    """k batched greedy steps; returns per-session token lists."""
    out = [[] for _ in sessions]
    for _ in range(k):
        toks = eng.step(sessions)
        for i, t in enumerate(toks):
            out[i].append(int(t))
    return out


# ---------------------------------------------------------------------------
# parity: forked decode == fresh prefill, bit-identical
# ---------------------------------------------------------------------------

def test_forked_decode_matches_fresh_prefill(rig):
    cfg, model = rig
    pool = _fresh_pool(cfg)
    eng = Engine(model, pool)
    n, k = 3, 4

    sess = eng.new_session(list(range(1, 12)))
    eng.generate(sess, 2)                       # trunk decodes past the prompt
    prefix = list(sess.tokens[:-1])             # tokens whose K/V are cached
    tree, sm, cr = _mk_tree(eng, pool, sess, dump=False)
    ck = sm.checkpoint(dump=False)

    copied_before = pool.stats.copied_pages
    kids = tree.fork(ck, n)
    # the fork itself moves zero KV block bytes — tables + refcounts only
    assert pool.stats.copied_pages == copied_before
    assert pool.stats.copied_bytes == copied_before * pool.bytes_per_page()

    forked = _decode_streams(eng, [kid.proc for kid in kids], k)

    fresh = [eng.new_session(prefix) for _ in range(n)]
    # same pending token: greedy prefill of the same prefix resamples it
    for f in fresh:
        assert f.tokens[-1] == sess.tokens[-1]
    fresh_streams = _decode_streams(eng, fresh, k)

    assert forked == fresh_streams              # bit-identical, per child
    for f in fresh:
        f.release()
    tree.release_all()
    cr.shutdown()


def test_divergent_forks_match_divergent_prefills(rig):
    """Force-feeding each child a different action (the search-step
    divergence) still matches a fresh prefill force-fed the same action."""
    cfg, model = rig
    pool = _fresh_pool(cfg)
    eng = Engine(model, pool)
    n, k = 3, 4
    actions = [3, 7, 11]

    sess = eng.new_session(list(range(2, 13)))
    eng.generate(sess, 2)
    prefix = list(sess.tokens[:-1])
    tree, sm, cr = _mk_tree(eng, pool, sess, dump=False)
    ck = sm.checkpoint(dump=False)

    kids = tree.fork(ck, n)
    for kid, a in zip(kids, actions):
        # overwrite the *pending* token: its K/V is not yet written, so this
        # is the cause of the first divergent write, not a write itself
        kid.proc.tokens[-1] = a
    copied_before = pool.stats.copied_pages
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
    from repro_torch.search import decode_fanout
    from repro_torch.serve import Scheduler, SchedulerConfig

    cfg, model = rig
    pool = _fresh_pool(cfg)
    eng = Engine(model, pool)
    n, k = 4, 5
    actions = [2, 5, 9, 13]

    sess = eng.new_session(list(range(1, 10)))
    eng.generate(sess, 2)
    prefix = list(sess.tokens[:-1])
    tree, sm, cr = _mk_tree(eng, pool, sess, dump=False)
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
# block accounting: copies happen exactly at the first divergent write
# ---------------------------------------------------------------------------

def test_block_accounting_aligned_vs_unaligned(rig):
    """Page-aligned fork point → the first decode step allocates fresh
    boundary pages, zero copies.  Unaligned → exactly n CoW copies of the
    shared tail page, and nothing else."""
    cfg, model = rig
    psz = 8
    pool = _fresh_pool(cfg, page_size=psz)
    eng = Engine(model, pool)
    n = 3

    # --- unaligned: seq_len straddles a page -----------------------------
    sess = eng.new_session(list(range(1, 12)))   # 11 prompt + pending
    tree, sm, cr = _mk_tree(eng, pool, sess, dump=False)
    assert sess.seq_len % psz != 0
    ck = sm.checkpoint(dump=False)
    kids = tree.fork(ck, n)
    cow_before = pool.stats.cow_copies
    eng.step([kid.proc for kid in kids])
    assert pool.stats.cow_copies == cow_before + n   # one tail copy per child
    tree.release_all()
    cr.shutdown()

    # --- aligned: fork exactly on a page boundary -------------------------
    sess2 = eng.new_session(list(range(1, psz * 2)))  # 15 prompt
    eng.generate(sess2, 2)                            # one step: seq_len -> 16
    assert sess2.seq_len % psz == 0
    tree2, sm2, cr2 = _mk_tree(eng, pool, sess2, dump=False)
    ck2 = sm2.checkpoint(dump=False)
    kids2 = tree2.fork(ck2, n)
    cow_before = pool.stats.cow_copies
    fresh_before = pool.stats.fresh_allocs
    eng.step([kid.proc for kid in kids2])
    assert pool.stats.cow_copies == cow_before        # no copies at all
    assert pool.stats.fresh_allocs == fresh_before + n
    tree2.release_all()
    pool.debug_validate()
    cr2.shutdown()


# ---------------------------------------------------------------------------
# recovered trunk decodes with no hand-rolled restore (satellite 3)
# ---------------------------------------------------------------------------

def test_recovered_trunk_decodes_without_manual_restore(rig, tmp_path):
    cfg, model = rig
    pool = _fresh_pool(cfg)
    eng = Engine(model, pool)

    sess = eng.new_session([5, 4, 3, 2, 1])
    eng.generate(sess, 3)
    tree, sm, cr = _mk_tree(eng, pool, sess)
    ck = sm.checkpoint()
    cr.wait_dumps()
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    expected = eng.step([sess])[0]               # the token the trunk lands next

    # fresh process analogue: new pool + engine, recover, decode immediately
    pool2 = _fresh_pool(cfg)
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
