"""The paged KV session of the port: its pool and DeltaCR path against the
JAX package's, and the fork/write/rollback properties of the JAX package's
``tests/test_kv_fork_props.py``.

A model-free harness writes seeded K/V rows straight into the pools (in
place in the port, by rebinding in the JAX package), standing in for the
decode step's scatter, so every session's content is known exactly.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.core import DeltaCR as JDeltaCR
from repro.core import faults as j_faults
from repro.core.delta_pipeline import mark_clean as j_mark_clean
from repro.core.faults import FaultError as JFaultError
from repro.core.policy import DumpPolicy as JDumpPolicy
from repro.serve import CowCorruptionError as JCowCorruptionError
from repro.serve import PagePool as JPagePool
from repro.serve import PagedSession as JPagedSession
from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DumpPolicy, mark_clean
from repro_torch.core import faults as t_faults
from repro_torch.core.deltafs import host_bytes
from repro_torch.core.faults import FaultError
from repro_torch.kernels import KernelLaunchError
from repro_torch.kernels import ops as t_kops
from repro_torch.serve import CowCorruptionError, PagePool, PagedSession

torch.set_num_threads(1)

CFG_NAME = "qwen3-14b-tiny"
PSZ = 4


# ---------------------------------------------------------------------------
# one harness over both packages
# ---------------------------------------------------------------------------
class World:
    """A pool, a DeltaCR and sessions of one package, driven by the same
    calls.  ``write`` appends one token's K/V rows (float32 values, cast
    to the pool's dtype the same way in both packages)."""

    def __init__(self, pkg, dtype, mode, num_pages=48, template_pool_size=2, verify_cow=False):
        self.pkg = pkg
        if pkg == "jax":
            self.pool = JPagePool(j_get_config(CFG_NAME), num_pages=num_pages, page_size=PSZ,
                                  max_pages_per_session=12, dtype=dtype, verify_cow=verify_cow)
            self.cr = JDeltaCR(
                template_pool_size=template_pool_size, async_warm=False,
                policy=JDumpPolicy(mode=mode, stream=False),
                restore_fn=lambda p: JPagedSession.restore_from_payload(self.pool, p),
            )
            self.Session, self.mark_clean = JPagedSession, j_mark_clean
        else:
            self.pool = PagePool(get_config(CFG_NAME), num_pages=num_pages, page_size=PSZ,
                                 max_pages_per_session=12, dtype=dtype, device="cpu",
                                 verify_cow=verify_cow)
            self.cr = DeltaCR(
                template_pool_size=template_pool_size, async_warm=False,
                policy=DumpPolicy(mode=mode, stream=False),
                restore_fn=lambda p: PagedSession.restore_from_payload(self.pool, p),
            )
            self.Session, self.mark_clean = PagedSession, mark_clean

    def write(self, sess, rows):
        """rows: float32 (2, periods, KVH, D) — K then V of one token."""
        sess.ensure_writable(extra_tokens=1)
        pos = sess.seq_len
        page, off = int(sess.table[pos // PSZ]), pos % PSZ
        for skey, tag in self.pool.attn_tags:
            for pools, r in ((self.pool.pools_k, rows[0]), (self.pool.pools_v, rows[1])):
                if self.pkg == "jax":
                    val = jnp.asarray(r).astype(pools[skey][tag].dtype)
                    pools[skey][tag] = pools[skey][tag].at[:, page, off].set(val)
                else:
                    pools[skey][tag][:, page, off] = torch.from_numpy(r).to(pools[skey][tag].dtype)
        sess.seq_len += 1
        sess.tokens.append(int(abs(r[0, 0, 0]) * 1000) % 50000)

    def payload_bytes(self, sess):
        """Every entry of the session's dump payload as raw bytes."""
        out = {}
        for k, v in sess.dump_payload().items():
            out[k] = (host_bytes(v).tobytes() if isinstance(v, torch.Tensor)
                      else np.ascontiguousarray(np.asarray(v)).tobytes())
        return out

    def image(self, cid):
        """A landed image in package-neutral form: per entry its shape,
        dtype string, pad and the blake2b of every chunk's bytes."""
        img = self.cr.dump_future(cid).result()
        entries = {
            name: (tuple(m.shape), m.dtype, m.trailing_pad,
                   tuple(hashlib.blake2b(self.cr.store.get(c), digest_size=16).hexdigest()
                         for c in m.chunk_ids))
            for name, m in img.entries.items()
        }
        s = self.cr.stats
        return (img.mode, img.dirtied_chunks, entries,
                (s.kernel_keys, s.full_keys, s.clean_keys, s.dumps))


def _script(seed, steps=14):
    """A seeded op list: ("write", rows) | ("ckpt",) | ("fork", k) |
    ("slow", k), k choosing among the checkpoints so far."""
    rng = np.random.default_rng(seed)
    cfg = get_config(CFG_NAME)
    shape = (2, cfg.stages[0].n_periods, cfg.n_kv_heads, cfg.head_dim)
    ops = [("write", rng.standard_normal(shape).astype(np.float32)) for _ in range(5)]
    ops.append(("ckpt",))
    for _ in range(steps):
        op = rng.choice(["write", "write", "ckpt", "fork", "slow"])
        if op == "write":
            for _ in range(int(rng.integers(1, 6))):
                ops.append(("write", rng.standard_normal(shape).astype(np.float32)))
        elif op == "ckpt":
            ops.append(("ckpt",))
        else:
            ops.append((op, int(rng.integers(0, 1 << 20))))
    ops.append(("ckpt",))
    return ops


def _run(world, ops):
    """Apply the op list; returns one record per checkpoint and restore."""
    cr = world.cr
    live = world.Session(world.pool)
    base, ckpts, records = None, [], []
    for op in ops:
        if op[0] == "write":
            world.write(live, op[1])
        elif op[0] == "ckpt":
            cid = len(ckpts) + 1
            cr.checkpoint(live, cid, base)
            cr.wait_dumps()
            ckpts.append(cid)
            base = cid
            records.append(("image", cid, world.image(cid)))
        else:
            cid = ckpts[op[1] % len(ckpts)]
            if op[0] == "slow":
                cr.evict_template(cid)
            kid, path = cr.restore(cid)
            live.release()
            live, base = kid, cid
            world.mark_clean(live, cid)
            records.append(("restore", cid, path, world.payload_bytes(live)))
    live.release()
    cr.shutdown()
    return records


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["delta", "legacy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_session_dumps_and_restores_match_reference(seed, mode, dtype):
    """The same seeded write/checkpoint/fork/rollback sequence through both
    packages: identical images (modes, dirtied chunks, entries, chunk
    digests, key statistics) and byte-identical restores."""
    ops = _script(seed)
    want = _run(World("jax", dtype, mode), ops)
    got = _run(World("torch", dtype, mode), ops)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        assert g == w, f"{g[0]} of checkpoint {g[1]} differs"
    if mode == "delta":
        assert any(r[0] == "image" and r[2][0] == "delta" for r in got)
    assert any(r[0] == "restore" and r[2] == "slow" for r in got)


@pytest.mark.parametrize("action", ["raise", "corrupt"])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cow_copy_fault_rolls_back_alike(pkg, action):
    """A fault at ``kvcache.cow_copy`` — raised before the copy, or bitrot
    after it that ``verify_cow`` detects — rolls the materialize back:
    tables, refcounts and free list as before, in both packages alike."""
    w = World(pkg, "float32", "delta", verify_cow=action == "corrupt")
    faults, err = (j_faults, JFaultError) if pkg == "jax" else (t_faults, FaultError)
    if action == "corrupt":
        err = JCowCorruptionError if pkg == "jax" else CowCorruptionError
    rows = np.ones((2, 1, 2, 16), np.float32)
    sess = w.Session(w.pool)
    for _ in range(PSZ + 1):                 # unaligned: the tail page is shared below
        w.write(sess, rows)
    kids = [sess.fork() for _ in range(2)]
    snap = (w.pool.refs.copy(), w.pool.free_pages(), [k.table.copy() for k in kids])
    plan = faults.FaultPlan().add("kvcache.cow_copy", action=action)
    with faults.inject(plan):
        with pytest.raises(err):
            kids[0].ensure_writable()
        np.testing.assert_array_equal(w.pool.refs, snap[0])
        assert w.pool.free_pages() == snap[1]
        for k, t in zip(kids, snap[2]):
            np.testing.assert_array_equal(k.table, t)
        assert w.pool.stats.cow_rollbacks == 1
        w.pool.debug_validate()
        assert kids[0].ensure_writable() == 1    # the fault is spent: the retry lands
    assert plan.fired("kvcache.cow_copy") == 1
    assert w.pool.stats.cow_copies == 1
    for s in kids + [sess]:
        s.release()
    w.cr.shutdown()


def test_checkpoint_bytes_survive_later_writes():
    """A dump builds its page grid lazily, on the dump worker, from pools
    the port updates in place.  Bytes dumped for a checkpoint must still be
    the checkpoint's after the live session and its forks write on: held
    back until they have, the dump still lands the checkpoint's bytes."""
    import threading

    w = World("torch", "bfloat16", "delta", template_pool_size=4)
    rng = np.random.default_rng(5)
    shape = (2, 1, 2, 16)
    live = w.Session(w.pool)
    for _ in range(6):
        w.write(live, rng.standard_normal(shape).astype(np.float32))
    w.cr.checkpoint(live, 1, None)
    w.cr.wait_dumps()
    for _ in range(3):
        w.write(live, rng.standard_normal(shape).astype(np.float32))
    want = w.payload_bytes(live)
    gate = threading.Event()
    w.cr._dump_worker.submit(gate.wait, 30.0)     # hold the dump of checkpoint 2
    w.cr.checkpoint(live, 2, 1)
    kids = [w.cr.restore(2)[0] for _ in range(2)]
    for s in [live] + kids:                        # later writes on every lineage
        for _ in range(PSZ + 2):
            w.write(s, rng.standard_normal(shape).astype(np.float32))
    gate.set()
    w.cr.wait_dumps()
    assert w.cr.dump_future(2).result().mode == "delta"
    w.cr.evict_template(2)
    restored, path = w.cr.restore(2)
    assert path == "slow"
    assert w.payload_bytes(restored) == want
    for s in [live, restored] + kids:
        s.release()
    w.cr.shutdown()
    w.pool.debug_validate()


def test_warm_kernel_error_surfaces():
    """A kernel failure on the async-warm thread is not swallowed: it is
    counted in health() and re-raised by the next DeltaCR call."""
    pool = PagePool(get_config(CFG_NAME), num_pages=32, page_size=PSZ,
                    max_pages_per_session=8, device="cpu")
    cr = DeltaCR(restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    w = World.__new__(World)
    w.pkg, w.pool = "torch", pool
    sess = PagedSession(pool)
    for _ in range(PSZ + 1):                         # unaligned: warm must copy the tail
        w.write(sess, np.ones((2, 1, 2, 16), np.float32))
    cr.checkpoint(sess, 1, None, dump=False)

    def broken(*_args, **_kw):
        raise KernelLaunchError("page_copy: CUDA error 719 at launch")

    real = t_kops.page_copy_stacked
    t_kops.page_copy_stacked = broken
    try:
        kid, path = cr.restore(1)
        assert path == "fast"
        cr._warm_executor.submit(lambda: None).result(timeout=30)   # the warm has run
    finally:
        t_kops.page_copy_stacked = real
    assert cr.health()["warm_kernel_errors"] == 1
    with pytest.raises(KernelLaunchError, match="719"):
        cr.wait_dumps()
    cr.wait_dumps()                                  # raised once, then cleared
    assert pool.stats.cow_rollbacks == 1 and pool.stats.warm_copies == 0
    for s in (kid, sess):
        s.release()
    cr.shutdown()


# ---------------------------------------------------------------------------
# the JAX package's tests/test_kv_fork_props.py on the port's pool
# ---------------------------------------------------------------------------
MAX_SESSIONS = 8
MAX_SEQ = 24
MAX_SNAPSHOTS = 4

# (op, salt): 0=fork, 1=append-write, 2=release, 3=snapshot, 4=rollback
OPS = st.lists(st.tuples(st.integers(0, 4), st.integers(0, 1 << 20)), min_size=1, max_size=40)


def _append_sentinel(pool, sess, expected, value):
    sess.ensure_writable(extra_tokens=1)
    pos = sess.seq_len
    page = int(sess.table[pos // pool.page_size])
    off = pos % pool.page_size
    assert page != 0, "writable position must not sit on the filler page"
    for skey, tag in pool.attn_tags:
        pool.pools_k[skey][tag][:, page, off] = value
        pool.pools_v[skey][tag][:, page, off] = -value
    sess.seq_len += 1
    sess.tokens.append(int(value) & 0x7FFF)
    expected.append(float(value))


def _read_back(pool, sess):
    skey, tag = pool.attn_tags[0]
    grid = pool.pools_k[skey][tag][0, :, :, 0, 0]            # (P, psz)
    return [float(grid[int(sess.table[pos // pool.page_size]), pos % pool.page_size])
            for pos in range(sess.seq_len)]


def _run_interleaving(ops, *, num_pages=128):
    pool = PagePool(get_config("olmo-1b-tiny"), num_pages=num_pages, page_size=8,
                    max_pages_per_session=8, device="cpu")
    baseline_refs = pool.refs.copy()
    baseline_free = pool.free_pages()
    world = [(PagedSession(pool), [])]
    snapshots = []
    counter = [0]

    def next_val():
        counter[0] += 1
        return float(counter[0])

    for op, salt in ops:
        if op == 0 and world and len(world) < MAX_SESSIONS:
            sess, expected = world[salt % len(world)]
            world.append((sess.fork(), list(expected)))
        elif op == 1 and world:
            sess, expected = world[salt % len(world)]
            if sess.seq_len < MAX_SEQ:
                _append_sentinel(pool, sess, expected, next_val())
        elif op == 2 and world:
            sess, _ = world.pop(salt % len(world))
            sess.release()
        elif op == 3 and world and len(snapshots) < MAX_SNAPSHOTS:
            sess, expected = world[salt % len(world)]
            snapshots.append((sess.dump_payload(), list(expected)))
        elif op == 4 and snapshots and len(world) < MAX_SESSIONS:
            payload, expected = snapshots[salt % len(snapshots)]
            world.append((PagedSession.restore_from_payload(pool, payload), list(expected)))
        for sess, expected in world:
            assert _read_back(pool, sess) == expected, "sibling write leaked"
        pool.debug_validate()
    for sess, _ in world:
        sess.release()
    pool.debug_validate()
    np.testing.assert_array_equal(pool.refs, baseline_refs)
    assert pool.free_pages() == baseline_free


@settings(max_examples=25, deadline=None)
@given(OPS)
def test_random_fork_write_rollback_interleavings(ops):
    _run_interleaving(ops)


def test_scatter_pages_reinterprets_bf16_words():
    """A bfloat16 payload that arrives as 16-bit words is reinterpreted bit
    for bit, never converted."""
    pool = PagePool(get_config(CFG_NAME), num_pages=8, page_size=PSZ, dtype="bfloat16",
                    device="cpu")
    skey, tag = pool.attn_tags[0]
    pool.pools_k[skey][tag].normal_(generator=torch.Generator().manual_seed(0))
    pool.pools_v[skey][tag].normal_(generator=torch.Generator().manual_seed(1))
    src = pool.gather_pages_device(np.array([1, 2]))
    words = {k: v.view(torch.int16).numpy().view(np.uint16) for k, v in src.items()}
    pool.scatter_pages(np.array([5, 6]), words)
    got = pool.gather_pages_device(np.array([5, 6]))
    for k in src:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], src[k])


@pytest.mark.parametrize("cfg_name,n_pools", [("qwen3-14b-tiny", 2), ("gemma3-27b-tiny", 16)])
def test_copy_pages_is_one_call_for_every_pool_of_a_shape(cfg_name, n_pools, monkeypatch):
    """``copy_pages`` hands the K and V pools of every (stage, tag) to one
    ``page_copy_stacked`` call per pool shape (one launch on the card for
    up to 8 pools), and every pool gets the copies."""
    pool = PagePool(get_config(cfg_name), num_pages=8, page_size=PSZ, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for pools in (pool.pools_k, pool.pools_v):
        for skey, tag in pool.attn_tags:
            pools[skey][tag].normal_(generator=gen)
    before = {(id(pools), s, t): pools[s][t].clone()
              for pools in (pool.pools_k, pool.pools_v) for s, t in pool.attn_tags}
    calls = []
    real = t_kops.page_copy_stacked

    def recording(pools, src, dst):
        calls.append(len(pools))
        return real(pools, src, dst)

    monkeypatch.setattr(t_kops, "page_copy_stacked", recording)
    pool.copy_pages([1, 2, 3], [5, 6, 7])
    assert calls == [n_pools]
    for (which, s, t), old in before.items():
        pools = pool.pools_k if which == id(pool.pools_k) else pool.pools_v
        want = old.clone()
        want[:, [5, 6, 7]] = old[:, [1, 2, 3]]
        assert torch.equal(pools[s][t], want)
