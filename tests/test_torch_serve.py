"""The serving slice as a whole: the port's model, page pool and engine
against the JAX package's, and the serving-loop semantics of the JAX
package's ``tests/test_serve.py`` and ``tests/test_decode_fork.py`` on the
port.

Both packages run the same weights: the JAX params of ``Model(cfg).init``
go through numpy into ``convert.params_from_numpy``.  The tiny configs are
float32, so logits agree to rounding (the two packages sum in different
orders): 1e-4 absolute and relative.  The JAX side runs its Pallas
``paged_attention`` in interpret mode, as its own tests do; the port runs
the kernel's plain version, since its tensors lie on the CPU.
"""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import arch_names
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import PagePool as JPagePool
from repro.serve import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import DeltaCR
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, PagePool, PagedSession, SamplingParams

torch.set_num_threads(1)

TOL = 1e-4
ARCHS = ["qwen3-14b-tiny", "olmo-1b-tiny"]


def _build(name):
    cfg = get_config(name)
    jcfg = j_get_config(name)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = Model(cfg, device="cpu", params=params_from_numpy(tree, device="cpu"))
    return cfg, jmodel, jparams, model


@pytest.fixture(scope="module", params=ARCHS)
def rig(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def olmo():
    cfg, _, _, model = _build("olmo-1b-tiny")
    return cfg, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# cross-package: the same weights, prompts and sampling in both engines
# ---------------------------------------------------------------------------
def test_configs_resolve_as_in_the_reference():
    for name in ("qwen3-14b", "qwen3-14b-tiny", "olmo-1b-tiny"):
        assert repr(get_config(name)) == repr(j_get_config(name))


def test_params_round_trip_through_numpy(rig):
    cfg, jmodel, jparams, model = rig
    back = params_to_numpy(model.params)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_engine_matches_reference_engine(rig):
    """Prefill logits, every decode step's logits, and greedy and
    temperature-sampled token streams agree over 6 batched steps."""
    cfg, jmodel, jparams, model = rig
    jpool = JPagePool(j_get_config(cfg.name), num_pages=48, page_size=8, max_pages_per_session=8)
    pool = PagePool(cfg, num_pages=48, page_size=8, max_pages_per_session=8, device="cpu")
    jeng, eng = JEngine(jmodel, jparams, jpool), Engine(model, pool)
    prompts = [list(range(3, 14)), [7, 1, 9, 4, 4, 2]]
    samplings = [(0.0, 0), (0.8, 3)]
    jsess = [jeng.new_session(p, JSamplingParams(temperature=t, seed=s))
             for p, (t, s) in zip(prompts, samplings)]
    sess = [eng.new_session(p, SamplingParams(temperature=t, seed=s))
            for p, (t, s) in zip(prompts, samplings)]
    for a, b in zip(sess, jsess):
        _close(a.extras["last_logits"], b.extras["last_logits"])
        assert a.tokens == b.tokens
    for _ in range(6):
        got, want = eng.step(sess), jeng.step(jsess)
        for a, b in zip(sess, jsess):
            _close(a.extras["last_logits"], b.extras["last_logits"])
        assert got == want
    for a, b in zip(sess, jsess):
        assert a.tokens == b.tokens and a.seq_len == b.seq_len
        np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(pool.refs, jpool.refs)


def test_dense_cache_matches_reference(rig):
    """``init_cache`` + ``prefill`` + ``decode_step`` on a dense cache."""
    cfg, jmodel, jparams, model = rig
    prompt = [[5, 9, 2, 8, 1, 3, 3], [4, 4, 6, 1, 2, 7, 9]]
    jcache = jmodel.init_cache(2, 16)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(prompt, jnp.int32), jcache)
    cache = model.init_cache(2, 16)
    logits, cache = model.prefill(torch.tensor(prompt, dtype=torch.int32), cache)
    _close(logits.numpy(), jlogits)
    for tok in ([3, 11], [6, 0], [1, 1]):
        jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tok, jnp.int32), jcache)
        logits, cache = model.decode_step(torch.tensor(tok, dtype=torch.int32), cache)
        _close(logits.numpy(), jlogits)
    np.testing.assert_array_equal(cache["lens"].numpy(), np.asarray(jcache["lens"]))


@pytest.mark.parametrize("S,chunk", [(27, 8), (16, 16), (5, 512)])
def test_chunked_causal_attention_matches_reference(S, chunk):
    """Several query chunks, a ragged last one, and one chunk only."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = JL.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk)
    got = TL.chunked_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", arch_names())
def test_every_tiny_config_builds_with_reference_param_count(arch):
    """Every architecture builds on the port, with the JAX package's
    param count and, leaf for leaf, its param shapes and dtypes."""
    name = arch + "-tiny"
    model = Model(get_config(name), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    jmodel = JModel(j_get_config(name))
    assert model.param_count() == jmodel.param_count()
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jmodel.param_shapes())
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       model.params)
    assert got == want


# ---------------------------------------------------------------------------
# the JAX package's tests/test_serve.py on the port
# ---------------------------------------------------------------------------
def _pool(cfg, num_pages=64, max_pages=16):
    return PagePool(cfg, num_pages=num_pages, page_size=8, max_pages_per_session=max_pages,
                    device="cpu")


def test_paged_matches_dense(olmo):
    cfg, model = olmo
    eng = Engine(model, _pool(cfg))
    prompt = list(range(1, 11))
    sess = eng.new_session(prompt)
    got = eng.generate(sess, 5)
    cache = model.init_cache(1, 64)
    logits, cache = model.prefill(torch.tensor([prompt], dtype=torch.int32), cache)
    want, tok = [], int(torch.argmax(logits[0]))
    for _ in range(5):
        want.append(tok)
        logits, cache = model.decode_step(torch.tensor([tok], dtype=torch.int32), cache)
        tok = int(torch.argmax(logits[0]))
    assert got == want
    sess.release()


def test_fork_shares_pages_and_cow_isolates(olmo):
    cfg, model = olmo
    pool = _pool(cfg)
    eng = Engine(model, pool)
    sess = eng.new_session([1, 2, 3, 4, 5])
    free_before = pool.free_pages()
    forks = [sess.fork() for _ in range(8)]
    assert pool.free_pages() == free_before          # fork allocates nothing
    a = eng.generate(sess, 4)
    b = eng.generate(forks[0], 4)
    assert a == b                                     # same state → same greedy tokens
    assert pool.cow_copies >= 1
    for f in forks:
        f.release()
    sess.release()
    pool.debug_validate()


def test_refcount_conservation(olmo):
    """Total page refs == sum over sessions of their table references."""
    cfg, model = olmo
    pool = _pool(cfg)
    eng = Engine(model, pool)
    baseline_refs = pool.refs.copy()
    sessions = [eng.new_session([1, 2, 3, 4, 5, 6, 7, 8, 9])]
    for _ in range(5):
        sessions.append(sessions[-1].fork())
    eng.step(sessions[:3])
    expected = np.zeros_like(pool.refs)
    for s in sessions:
        for p in s.active_pages():
            expected[p] += 1
    live = pool.refs - baseline_refs
    np.testing.assert_array_equal(live[1:], expected[1:])
    for s in sessions:
        s.release()
    np.testing.assert_array_equal(pool.refs, baseline_refs)


def test_pool_exhaustion_raises(olmo):
    cfg, model = olmo
    eng = Engine(model, _pool(cfg, num_pages=3))
    with pytest.raises(MemoryError):
        eng.new_session(list(range(40)))             # needs 5 pages, only 2 free


def test_deltacr_integration_slow_path(olmo):
    """PagedSession round-trips through DeltaCR dump → slow restore."""
    cfg, model = olmo
    pool = _pool(cfg)
    eng = Engine(model, pool)
    sess = eng.new_session([5, 4, 3, 2, 1], SamplingParams(temperature=0.7, seed=9))
    eng.generate(sess, 4)
    cr = DeltaCR(
        template_pool_size=1,
        restore_fn=lambda payload: PagedSession.restore_from_payload(pool, payload),
    )
    try:
        cr.checkpoint(sess, 1, None)
        tokens_at_ckpt = list(sess.tokens)
        more_a = eng.generate(sess, 8)
        other = eng.new_session([9])
        cr.checkpoint(other, 2, None)
        assert not cr.has_template(1)
        restored, path = cr.restore(1)
        assert path == "slow"
        assert restored.tokens == tokens_at_ckpt
        more_b = eng.generate(restored, 8)            # rollback determinism
        assert more_a == more_b
    finally:
        cr.shutdown()


def test_session_dump_payload_roundtrip(olmo):
    cfg, model = olmo
    pool = _pool(cfg)
    eng = Engine(model, pool)
    sess = eng.new_session([7, 7, 7])
    eng.generate(sess, 3)
    payload = sess.dump_payload()
    clone = PagedSession.restore_from_payload(pool, payload)
    assert clone.seq_len == sess.seq_len
    assert clone.tokens == sess.tokens
    for pos in range(sess.n_pages):                   # equal contents, other pages
        assert clone.table[pos] != sess.table[pos]
        a = pool.gather_page(int(sess.table[pos]))
        b = pool.gather_page(int(clone.table[pos]))
        for k in a:
            assert torch.equal(a[k], b[k])
    clone.release()
    sess.release()


# ---------------------------------------------------------------------------
# the JAX package's tests/test_decode_fork.py on the port (olmo only; forks
# through DeltaCR.restore of a template)
# ---------------------------------------------------------------------------
def _cr(pool):
    return DeltaCR(
        template_pool_size=8,
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        async_warm=False,            # deterministic block accounting
    )


def _fork(cr, sess, n):
    cr.checkpoint(sess, 1, None, dump=False)
    kids = []
    for _ in range(n):
        kid, path = cr.restore(1)
        assert path == "fast"
        kids.append(kid)
    return kids


def _decode_streams(eng, sessions, k):
    out = [[] for _ in sessions]
    for _ in range(k):
        for i, t in enumerate(eng.step(sessions)):
            out[i].append(int(t))
    return out


@pytest.mark.parametrize("actions", [None, [3, 7, 11]], ids=["same", "divergent"])
def test_forked_decode_matches_fresh_prefill(olmo, actions):
    """Forked children decode exactly what fresh prefills of the same
    prefix decode (force-fed the same divergent action, if any), and the
    fork itself copies no page."""
    cfg, model = olmo
    pool = _pool(cfg, num_pages=96)
    eng = Engine(model, pool)
    n, k = 3, 4
    sess = eng.new_session(list(range(1, 12)))
    eng.generate(sess, 2)
    prefix = list(sess.tokens[:-1])
    cr = _cr(pool)
    try:
        copied_before = pool.stats.copied_pages
        kids = _fork(cr, sess, n)
        assert pool.stats.copied_pages == copied_before
        if actions:
            for kid, a in zip(kids, actions):
                kid.tokens[-1] = a
        forked = _decode_streams(eng, kids, k)
        if actions:
            assert len({tuple(s) for s in forked}) == n
        fresh = [eng.new_session(prefix) for _ in range(n)]
        for f, a in zip(fresh, actions or [None] * n):
            if a is None:
                assert f.tokens[-1] == sess.tokens[-1]
            else:
                f.tokens[-1] = a
        assert forked == _decode_streams(eng, fresh, k)
        for s in fresh + kids:
            s.release()
    finally:
        cr.shutdown()


def test_block_accounting_aligned_vs_unaligned(olmo):
    """Unaligned fork point → exactly n CoW copies of the shared tail page
    on the first step; page-aligned → n fresh pages and no copy."""
    cfg, model = olmo
    psz = 8
    pool = _pool(cfg, num_pages=96)
    eng = Engine(model, pool)
    n = 3

    sess = eng.new_session(list(range(1, 12)))        # 11 prompt + pending
    assert sess.seq_len % psz != 0
    cr = _cr(pool)
    kids = _fork(cr, sess, n)
    cow_before = pool.stats.cow_copies
    calls_before = pool.stats.materialize_calls
    eng.step(kids)
    assert pool.stats.cow_copies == cow_before + n
    assert pool.stats.materialize_calls == calls_before + 1
    for s in kids + [sess]:
        s.release()
    cr.shutdown()

    sess2 = eng.new_session(list(range(1, psz * 2)))  # 15 prompt
    eng.generate(sess2, 2)                            # one step: seq_len -> 16
    assert sess2.seq_len % psz == 0
    cr2 = _cr(pool)
    kids2 = _fork(cr2, sess2, n)
    cow_before = pool.stats.cow_copies
    fresh_before = pool.stats.fresh_allocs
    eng.step(kids2)
    assert pool.stats.cow_copies == cow_before
    assert pool.stats.fresh_allocs == fresh_before + n
    for s in kids2 + [sess2]:
        s.release()
    cr2.shutdown()
    pool.debug_validate()
