"""The port's serving engine against the JAX package's on every
architecture: attention (global, sliding-window, M-RoPE), MoE, mamba and
xLSTM stacks.

Both engines run the same weights (the JAX params through numpy into
``core.convert.params_from_numpy``) over the same prompts: prefill,
batched decode with a fork of a session in the batch, a delta dump through
each package's ``DeltaCR``, and a slow restore after the template is
evicted.  Every step's logits agree within 1e-4 absolute and relative
(float32 tiny configs; the packages sum in different orders) and every
greedy token is equal.  Recurrent states ride in session extras, so a
fork must leave its parent's states untouched when it steps, and a slow
restore must bring them back onto the pool's device and decode exactly
what a fast fork decodes.  The first prompt is longer than gemma3's
window, so its local layers mask in both prefill and paged decode.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import arch_names
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import PagePool as JPagePool
from repro.serve import PagedSession as JPagedSession
from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.serve import Engine, PagePool, PagedSession

torch.set_num_threads(1)

TOL = 1e-4
PROMPTS = [list(range(3, 43)), [7, 1, 9, 4, 4, 2]]   # 40 tokens: past gemma3-tiny's window


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.fixture(scope="module", params=arch_names())
def rig(request):
    name = request.param + "-tiny"
    jcfg = j_get_config(name)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(name)
    model = Model(cfg, device="cpu",
                  params=params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    jpool = JPagePool(jcfg, num_pages=64, page_size=8, max_pages_per_session=8)
    pool = PagePool(cfg, num_pages=64, page_size=8, max_pages_per_session=8, device="cpu")
    return cfg, JEngine(jmodel, jparams, jpool), Engine(model, pool)


def _state_leaves(sess):
    """Copies of a session's recurrent-state leaves, by extras key."""
    return {f"{key}::{leaf}": t.clone() for key in sess.pool.state_keys
            for leaf, t in sess.extras[key].items()}


def _step_both(jeng, eng, jsess, sess):
    got, want = eng.step(sess), jeng.step(jsess)
    for a, b in zip(sess, jsess):
        _close(a.extras["last_logits"], b.extras["last_logits"])
    assert got == want
    return got


def test_engine_prefill_decode_fork_match_reference(rig):
    cfg, jeng, eng = rig
    jsess = [jeng.new_session(p) for p in PROMPTS]
    sess = [eng.new_session(p) for p in PROMPTS]
    for a, b in zip(sess, jsess):
        _close(a.extras["last_logits"], b.extras["last_logits"])
        assert a.tokens == b.tokens
    for key in eng.pool.state_keys:          # states live on the engine's device
        assert all(t.device == eng.device for t in sess[0].extras[key].values())
    _step_both(jeng, eng, jsess, sess)
    jkid, kid = jsess[0].fork(), sess[0].fork()
    jkid.tokens[-1] = kid.tokens[-1] = 5    # a divergent pending token
    # the fork aliases its parent's states; stepping the parent must
    # leave the child's bytes unchanged
    before = _state_leaves(kid)
    _step_both(jeng, eng, jsess[:1], sess[:1])
    after = _state_leaves(kid)
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    for _ in range(3):
        _step_both(jeng, eng, jsess + [jkid], sess + [kid])
    for s in sess + [kid]:
        s.release()
    eng.pool.debug_validate()


def test_slow_restore_matches_reference_and_fast_fork(rig):
    """A delta dump, a template eviction and a slow restore in both
    packages: the restored sessions decode the JAX package's logits and
    tokens, and the port's decodes exactly what its fast fork decodes."""
    cfg, jeng, eng = rig
    jcr = J.DeltaCR(template_pool_size=1, async_warm=False,
                    restore_fn=lambda p: JPagedSession.restore_from_payload(jeng.pool, p))
    cr = DeltaCR(template_pool_size=1, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(eng.pool, p))
    try:
        jsess, sess = jeng.new_session(PROMPTS[0]), eng.new_session(PROMPTS[0])
        for _ in range(2):
            _step_both(jeng, eng, [jsess], [sess])
        jcr.checkpoint(jsess, 1, None)
        cr.checkpoint(sess, 1, None)
        _step_both(jeng, eng, [jsess], [sess])
        jcr.checkpoint(jsess, 2, None)
        cr.checkpoint(sess, 2, None)
        jcr.wait_dumps()
        cr.wait_dumps()
        fast, path = cr.restore(2)
        assert path == "fast"
        assert jcr.evict_template(2) and cr.evict_template(2)
        (jslow, jpath), (slow, spath) = jcr.restore(2), cr.restore(2)
        assert jpath == spath == "slow"
        assert slow.tokens == jslow.tokens == fast.tokens
        for key in eng.pool.state_keys:       # uploaded back to the pool's device
            for leaf, t in slow.extras[key].items():
                assert isinstance(t, torch.Tensor) and t.device == eng.device
                assert torch.equal(t, fast.extras[key][leaf])
        for _ in range(2):
            _step_both(jeng, eng, [jslow], [slow])
            eng.step([fast])
            np.testing.assert_array_equal(fast.extras["last_logits"], slow.extras["last_logits"])
            assert fast.tokens == slow.tokens
        for s in (sess, fast, slow):
            s.release()
    finally:
        jcr.shutdown()
        cr.shutdown()


def test_attention_free_pool_allocates_pages_and_corrupts_nothing():
    """A pool with no attention layer (xlstm) holds no page bytes but still
    allocates pages to bound a session, as the reference's does; its
    injected-bitrot hook has nothing to corrupt and returns (the
    reference's indexes an empty list)."""
    cfg = get_config("xlstm-1.3b-tiny")
    pool = PagePool(cfg, num_pages=8, page_size=4, max_pages_per_session=4, device="cpu")
    jpool = JPagePool(j_get_config("xlstm-1.3b-tiny"), num_pages=8, page_size=4,
                      max_pages_per_session=4)
    assert pool.attn_tags == jpool.attn_tags == [] and pool.bytes_per_page() == 0
    sess, jsess = PagedSession(pool), JPagedSession(jpool)
    sess.ensure_writable(extra_tokens=9)
    jsess.ensure_writable(extra_tokens=9)
    np.testing.assert_array_equal(sess.table, jsess.table)
    np.testing.assert_array_equal(pool.refs, jpool.refs)
    pool._corrupt_page_for_test(int(sess.table[0]))
    with pytest.raises(IndexError):
        jpool._corrupt_page_for_test(int(jsess.table[0]))
    sess.release()
    pool.debug_validate()


def test_bf16_recurrent_state_round_trips_through_a_slow_restore():
    """A bf16 jamba keeps its mamba conv state in bf16: the dump carries it
    as 16-bit words and the slow restore uploads it back as bf16, equal to
    a fast fork's, and decodes the fast fork's logits."""
    import dataclasses

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b-tiny"), dtype="bfloat16",
                              param_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = PagePool(cfg, num_pages=32, page_size=8, max_pages_per_session=8, device="cpu")
    eng = Engine(model, pool)
    cr = DeltaCR(template_pool_size=1, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    try:
        sess = eng.new_session(PROMPTS[1])
        eng.step([sess])
        cr.checkpoint(sess, 1, None)
        cr.wait_dumps()
        fast = cr.restore(1)[0]
        assert cr.evict_template(1)
        slow, path = cr.restore(1)
        assert path == "slow"
        convs = [k for k in pool.state_keys if k.endswith("_mamba")]
        assert convs
        for key in pool.state_keys:
            for leaf, t in slow.extras[key].items():
                assert t.dtype == fast.extras[key][leaf].dtype
                assert torch.equal(t, fast.extras[key][leaf])
        assert all(slow.extras[k]["conv"].dtype == torch.bfloat16 for k in convs)
        eng.step([slow])
        eng.step([fast])
        np.testing.assert_array_equal(slow.extras["last_logits"], fast.extras["last_logits"])
        for s in (sess, fast, slow):
            s.release()
    finally:
        cr.shutdown()

