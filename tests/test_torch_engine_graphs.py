"""The Engine's decode programs (one per batch width, the port's
counterpart of the JAX package's ``_decode_jit`` / ``_get_decode``) on the
CPU, where they run the staged eager step: the same static buffers and
staging as the card's CUDA graphs, without the capture.

* Each config runs prefill, decode at B = 1 and B = 3, a fork, a delta
  dump with a slow restore, and a released session, through the port's
  ``Engine`` and the JAX package's on the same weights: every greedy token
  equal, every logit within 1e-4 (``test_torch_serve_families.py``'s
  tolerance).  The configs: dense, MoE, recurrent (mLSTM/sLSTM),
  sliding-window, and the MoE under expert parallelism over a (1, 4)
  logical mesh.
* A width's static buffers are made once and reused by its later steps,
  and no session holds a view of them: stepping the parent leaves a
  fork's recurrent state unchanged.
* The step's body, run under a ``TorchDispatchMode``, makes no call a CUDA
  graph cannot capture: no ``.item()``, no ``nonzero`` or boolean index,
  no tensor built from host data, and no read of a tensor from outside the
  step (a copy from host memory).
* What a capture records (kernel launches, collective bytes) is added at
  every replay, and only the capturing thread records.

The last test needs the card (``-m gpu``): the graphed step against the
eager one, token for token, logit for logit and launch for launch.
"""
import pytest

pytest.importorskip("torch")

import contextlib
import threading

import jax
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.core as J
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import PagePool as JPagePool
from repro.serve import PagedSession as JPagedSession
from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.core.convert import params_from_numpy
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import activation_sharding
from repro_torch.kernels import accounting, launch_counts, paged_attention, reset_launch_counts
from repro_torch.launch.mesh import make_logical_mesh
from repro_torch.models import Model
from repro_torch.serve import Engine, PagePool, PagedSession

torch.set_num_threads(1)

TOL = 1e-4
PROMPTS = [list(range(3, 43)), [7, 1, 9, 4, 4, 2]]   # 40 tokens: past gemma3-tiny's window
# (case id, tiny config, logical mesh of the expert-parallel context or None)
CASES = [
    ("dense", "qwen3-14b-tiny", None),
    ("moe", "qwen3-moe-30b-a3b-tiny", None),
    ("recurrent", "xlstm-1.3b-tiny", None),
    ("sliding", "gemma3-27b-tiny", None),
    ("moe-ep-1x4", "qwen3-moe-30b-a3b-tiny", (1, 4)),
]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _context(cfg, mesh_shape):
    if mesh_shape is None:
        return contextlib.nullcontext()
    mesh = make_logical_mesh(mesh_shape, device="cpu")
    return activation_sharding(dp=("data",), model="model", attn_shard=cfg.attn_shard, mesh=mesh)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def rig(request):
    _, name, mesh_shape = request.param
    jcfg = j_get_config(name)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(name)
    model = Model(cfg, device="cpu",
                  params=params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    jpool = JPagePool(jcfg, num_pages=64, page_size=8, max_pages_per_session=8)
    pool = PagePool(cfg, num_pages=64, page_size=8, max_pages_per_session=8, device="cpu")
    return JEngine(jmodel, jparams, jpool), Engine(model, pool), _context(cfg, mesh_shape)


def _step_both(jeng, eng, jsess, sess):
    got, want = eng.step(sess), jeng.step(jsess)
    for a, b in zip(sess, jsess):
        _close(a.extras["last_logits"], b.extras["last_logits"])
    assert got == want
    return got


def _state_leaves(sess):
    return {f"{key}::{leaf}": t.clone() for key in sess.pool.state_keys
            for leaf, t in sess.extras[key].items()}


def _static_storages(eng):
    """Storage addresses of every program's static buffers."""
    out = set()
    for prog in eng._decode.values():
        out.add(prog.staged.untyped_storage().data_ptr())
        for leaves in prog.states.values():
            out.update(t.untyped_storage().data_ptr() for t in leaves.values())
    return out


def _assert_no_static_views(eng, sessions):
    static = _static_storages(eng)
    for s in sessions:
        for key in s.pool.state_keys:
            for leaf, t in s.extras[key].items():
                assert t.untyped_storage().data_ptr() not in static, f"{key}::{leaf}"


def test_staged_step_matches_reference(rig):
    """Prefill, B = 1 and B = 3 steps, a fork, a slow restore and a
    released session: tokens and logits against the JAX package, static
    buffers made once per width and never held by a session."""
    jeng, eng, ctx = rig
    jcr = J.DeltaCR(template_pool_size=1, async_warm=False,
                    restore_fn=lambda p: JPagedSession.restore_from_payload(jeng.pool, p))
    cr = DeltaCR(template_pool_size=1, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(eng.pool, p))
    try:
        with ctx:
            jsess = [jeng.new_session(p) for p in PROMPTS]
            sess = [eng.new_session(p) for p in PROMPTS]
            for a, b in zip(sess, jsess):
                _close(a.extras["last_logits"], b.extras["last_logits"])
                assert a.tokens == b.tokens
            for _ in range(2):
                _step_both(jeng, eng, jsess[:1], sess[:1])
            prog1 = eng._get_decode(1)
            staged1 = prog1.staged.data_ptr()
            jkid, kid = jsess[0].fork(), sess[0].fork()
            jkid.tokens[-1] = kid.tokens[-1] = 5          # a divergent pending token
            for _ in range(2):
                _step_both(jeng, eng, jsess + [jkid], sess + [kid])
            prog3 = eng._get_decode(3)
            staged3 = prog3.staged.data_ptr()
            # the parent moves on alone: the fork's states stay as they were
            before = _state_leaves(kid)
            _step_both(jeng, eng, jsess[:1], sess[:1])
            after = _state_leaves(kid)
            assert before.keys() == after.keys()
            assert all(torch.equal(before[k], after[k]) for k in before)
            _assert_no_static_views(eng, sess + [kid])
            # a delta dump of the parent, its template evicted, a slow restore
            jcr.checkpoint(jsess[0], 1, None)
            cr.checkpoint(sess[0], 1, None)
            jcr.wait_dumps()
            cr.wait_dumps()
            assert jcr.evict_template(1) and cr.evict_template(1)
            (jslow, jpath), (slow, path) = jcr.restore(1), cr.restore(1)
            assert jpath == path == "slow"
            assert slow.tokens == jslow.tokens
            _step_both(jeng, eng, [jslow], [slow])
            # a released session's place in the batch taken by the restored one
            jsess[1].release()
            sess[1].release()
            for _ in range(2):
                _step_both(jeng, eng, [jsess[0], jkid, jslow], [sess[0], kid, slow])
            _assert_no_static_views(eng, [sess[0], kid, slow])
            # one program per width, its buffers reused by every step
            assert eng._get_decode(1) is prog1 and eng._get_decode(3) is prog3
            assert prog1.staged.data_ptr() == staged1 and prog3.staged.data_ptr() == staged3
            assert sorted(b for b, _ in eng._decode) == [1, 3]
            assert all(p.graph is None for p in eng._decode.values())    # the CPU captures nothing
            for s in (sess[0], kid, slow):
                s.release()
        eng.pool.debug_validate()
    finally:
        jcr.shutdown()
        cr.shutdown()


# ----------------------------------------------------------------------------
# capture safety
# ----------------------------------------------------------------------------
_FORBIDDEN = {"_local_scalar_dense", "nonzero", "lift_fresh", "lift_fresh_copy"}
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_", "_unsafe_index"}


def _storage(t):
    return t.untyped_storage().data_ptr()


class _CaptureBlockers(TorchDispatchMode):
    """Notes every op a CUDA graph cannot capture: a host sync
    (``.item()``, ``nonzero``, a boolean index), a tensor built from host
    data (``lift_fresh``), or an op reading a tensor that is neither one of
    the ``known`` step inputs nor made by an earlier op of the step (on the
    card: a copy from host memory)."""

    def __init__(self, known):
        super().__init__()
        self.known = {_storage(t) for t in known if t.numel()}
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        inputs = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        if name in _FORBIDDEN:
            self.found.append(str(func))
        elif name in _INDEX_OPS and any(t.dtype == torch.bool for t in inputs[1:]):
            self.found.append(f"{func} with a boolean index")
        for t in inputs:
            if t.numel() and _storage(t) not in self.known:
                self.found.append(f"{func} reads a tensor from outside the step")
                break
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.numel():
                self.known.add(_storage(t))
        return out


def _leaves(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def test_detector_flags_each_blocker():
    """The detector itself: each kind of uncapturable op is noted, and
    plain device ops over known tensors are not."""
    x = torch.randn(4)
    mask = x > 0
    outside = torch.from_numpy(np.ones(4, np.float32))
    blockers = {
        "item": lambda: (x.sum() + 1).item(),
        "scalar tensor": lambda: x * torch.tensor(2.0),
        "nonzero": lambda: torch.nonzero(x),
        "bool index": lambda: x[mask],
        "host copy": lambda: x + outside.to(torch.float32),
    }
    for what, fn in blockers.items():
        with _CaptureBlockers([x, mask]) as mode:
            fn()
        assert mode.found, what
    with _CaptureBlockers([x, mask]) as mode:
        y = torch.where(mask, x, -1e30) * 2.0
        x.masked_fill(~mask, -1e30).exp() + torch.arange(4) + y[torch.arange(2)].sum()
    assert mode.found == []


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_body_is_capture_safe(case):
    """The body a CUDA graph captures, ``decode_step`` over a program's
    static buffers at B = 2, makes no uncapturable call."""
    _, name, mesh_shape = case
    cfg = get_config(name)
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = PagePool(cfg, num_pages=64, page_size=8, max_pages_per_session=8, device="cpu")
    eng = Engine(model, pool)
    with _context(cfg, mesh_shape):
        trunk = eng.new_session(PROMPTS[0])
        kid = trunk.fork()
        kid.tokens[-1] = 5
        eng.step([trunk, kid])
        prog = eng._get_decode(2)
        prog.stage([trunk, kid])
        with _CaptureBlockers(_leaves(model.params) + _leaves(prog.cache)
                              + [prog.tokens]) as mode:
            logits = prog.body()
    assert mode.found == []
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
    for s in (trunk, kid):
        s.release()


# ----------------------------------------------------------------------------
# replayed accounting
# ----------------------------------------------------------------------------
def test_replay_adds_what_the_capture_counted():
    """Inside ``recording`` a launch count and a collective's ledger entry
    are kept, not applied; each replay applies them once, as an eager call
    would.  Another thread's launches during the recording apply at once."""
    mesh = make_logical_mesh((1, 4), device="cpu")
    blocks = {r: torch.ones(8, 3) for r in range(4)}
    reset_launch_counts()
    col.reset_ledger()
    col.all_to_all(blocks, mesh, "model", split_axis=0, concat_axis=0)
    eager = col.ledger()
    col.reset_ledger()
    with accounting.recording() as notes:
        accounting.count_launches(paged_attention)
        accounting.count_launches(paged_attention, 0)      # no launch, no note
        col.all_to_all(blocks, mesh, "model", split_axis=0, concat_axis=0)
        worker = threading.Thread(target=accounting.count_launches, args=(paged_attention, 3))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        with pytest.raises(RuntimeError):
            with accounting.recording():
                pass
    assert len(notes) == 2
    assert launch_counts()["paged_attention"] == 3          # the other thread's, applied
    assert col.ledger() == {"received": {}, "calls": {}}
    for n in (1, 2):
        accounting.replay(notes)
        assert launch_counts()["paged_attention"] == 3 + n
        got = col.ledger()
        assert got["calls"] == {"all_to_all": n}
        assert got["received"]["all_to_all"] == {
            r: n * b for r, b in eager["received"]["all_to_all"].items()}
    accounting.count_launches(paged_attention)              # recording over: applied at once
    assert launch_counts()["paged_attention"] == 6
    reset_launch_counts()
    col.reset_ledger()


def test_graphs_on_the_cpu_raise():
    cfg = get_config("qwen3-14b-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = PagePool(cfg, num_pages=16, page_size=8, max_pages_per_session=4, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        Engine(model, pool, graphs=True)
    assert Engine(model, pool).graphs is False
    assert Engine(model, pool, graphs=False).graphs is False


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_graphed_step_matches_eager_on_card(cuda):
    """The same session tree decoded with ``graphs=False`` and with graphs:
    equal tokens, bit-equal logits, and equal launches on every step (a
    width's first step runs eagerly and captures; the rest replay)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen3-14b-tiny"), n_heads=10, n_kv_heads=2, head_dim=64)
    model = Model(cfg, device=cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    runs = []
    for graphs in (False, True):
        pool = PagePool(cfg, num_pages=32, page_size=16, max_pages_per_session=8, device=cuda)
        eng = Engine(model, pool, graphs=graphs)
        trunk = eng.new_session(list(range(3, 24)))
        kid = trunk.fork()
        kid.tokens[-1] = 7
        toks, logits, counts = [], [], []
        for batch in ([trunk], [trunk, kid], [trunk, kid], [trunk]):
            reset_launch_counts()
            toks.append(eng.step(batch))
            torch.cuda.synchronize()
            counts.append(launch_counts()["paged_attention"])
            logits.append(np.stack([s.extras["last_logits"] for s in batch]))
        if graphs:
            assert all(p.graph is not None for p in eng._decode.values())
            assert eng._get_decode(2).replays == 1 and eng._get_decode(1).replays == 1
        runs.append((toks, logits, counts))
        for s in (trunk, kid):
            s.release()
    (etoks, elogits, ecounts), (gtoks, glogits, gcounts) = runs
    assert gtoks == etoks
    assert gcounts == ecounts == [cfg.n_layers] * 4
    for a, b in zip(glogits, elogits):
        np.testing.assert_array_equal(a, b)
