"""The Trainer's step program (``TrainProgram``, the port's counterpart of
the JAX package's ``Trainer._build_step``) on the CPU, where it runs the
staged eager step: the same static buffers, staging and in-place update as
the card's CUDA graph, without the capture.

* **Against the JAX package.**  ``TrainProgram(graph=False)`` against the
  JAX ``Trainer.train_step`` (jitted, as the reference builds it) for
  ``STEPS`` steps from the same params (the JAX ones, converted) on the
  same batches, at ``olmo-1b-tiny`` (and ``qwen3-moe-30b-a3b-tiny`` in
  ``test_torch_train_graphs_b.py``, so that each file stays well under a
  minute), with microbatches 1 and 2, int8 compression on and off, and ``donate`` on
  and off.  Bounds, those of ``tests/test_torch_train_diff.py`` for its
  12-step trainer run (float32; the two packages sum in other orders):
  every step's loss within ``LOSS_TOL`` (1e-5), lr within 1e-6 × peak lr,
  grad_norm within ``GNORM_RTOL`` (1e-5) relative, and every params and
  moment leaf after the last step within ``LEAF_TOL`` (1e-5) ×
  max(1, the leaf's largest magnitude).  With int8 compression, at most
  ``INT8_FLIPS`` (1) element of a leaf may lie outside that bound, by at
  most ``STEPS`` × lr: a gradient element that sits on a rounding boundary
  of its quantized value rounds the other way when its float32 sum
  differs in the last bits, and AdamW's early steps (about lr × sign(g))
  then move that param by up to lr a step.  Measured: one element of
  ``qwen3-moe-30b-a3b-tiny``'s 8,192 expert ``w_down`` values, by 1.0e-3
  after one step and 2.7e-4 after two (its gradient is ~1e-8, so without
  compression it differs by 6.5e-6, inside ``LEAF_TOL``); every other
  leaf within 6e-8.
* **Capture safety.**  The step body, run under the capture-blocker
  detector of ``tests/test_torch_engine_graphs.py`` (no host read, no
  tensor from host data, no boolean index, no read of a tensor from
  outside the step), makes no uncapturable call: dense, MoE, recurrent
  (mLSTM/sLSTM), sliding-window and jamba configs, with 2 microbatches and
  compression, through forward, backward (both rematerialization sites)
  and AdamW.
* **Trees in and out.**  Without ``donate`` the caller's trees are never
  written and the program's own come back; after ``restore_latest`` the
  restored trees are copied in and the resumed run gives the
  uninterrupted run's losses exactly.
* ``Trainer(graphs=True)`` on the CPU raises.

The last test needs the card (``-m gpu``): the graphed step against the
eager step, with a checkpoint write in flight during the capture.
"""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import train as J
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro_torch import train as T
from repro_torch.configs import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.train import TrainProgram
from repro_torch.train.optim import tree_map, tree_paths
from test_torch_engine_graphs import _CaptureBlockers, _leaves

torch.set_num_threads(1)

STEPS = 2
LOSS_TOL = 1e-5
LR_TOL = 1e-6
GNORM_RTOL = 1e-5
LEAF_TOL = 1e-5
INT8_FLIPS = 1
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
DATA = dict(seq_len=32, global_batch=4)
# (microbatches, compress_grads, donate)
VARIANTS = [(mb, comp, donate) for mb in (1, 2) for comp in (False, True)
            for donate in (False, True)]


def _ids(v):
    return f"mb{v[0]}-{'int8' if v[1] else 'fp'}-{'donate' if v[2] else 'keep'}"


def _port_trainer(name, *, microbatches=1, compress=False, donate=False, **kw):
    cfg = get_config(name)
    return T.Trainer(Model(cfg, device="cpu"), T.OptimizerConfig(**OPT),
                     T.DataConfig(vocab_size=cfg.vocab_size, **DATA),
                     T.TrainerConfig(microbatches=microbatches, compress_grads=compress,
                                     donate=donate, log_every=1, **kw))


def _np(tree):
    return {p: np.asarray(jnp.asarray(v, jnp.float32)) for p, v in tree_paths(tree)}


def _flat(tree):
    return {p: t.float().numpy() for p, t in tree_paths(tree)}


# ----------------------------------------------------------------------------
# the staged step against the JAX package
# ----------------------------------------------------------------------------
def check_variant(name, variant):
    mb, comp, donate = variant
    jcfg = j_get_config(name)
    jt = J.Trainer(JModel(jcfg), J.OptimizerConfig(**OPT),
                   J.DataConfig(vocab_size=jcfg.vocab_size, **DATA),
                   J.TrainerConfig(microbatches=mb, compress_grads=comp, donate=donate))
    tt = _port_trainer(name, microbatches=mb, compress=comp, donate=donate)
    jp, jo, je = jt.init_state(0)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    opt = T.adamw_init(params, tt.opt_cfg)
    err = T.error_feedback_init(params) if comp else torch.zeros(())
    prog = None
    for _ in range(STEPS):
        batch = jt.stream.next_batch()
        assert all(np.array_equal(v, w) for v, w in
                   zip(batch.values(), tt.stream.next_batch().values()))
        jp, jo, je, jm = jt.train_step(jp, jo, je, {k: jnp.asarray(v) for k, v in batch.items()})
        if prog is None:
            prog = TrainProgram(tt, batch, graph=False)
        params, opt, err, tm = prog.step(params, opt, err, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(float(jm["loss"]))
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= LR_TOL * OPT["peak_lr"]
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= GNORM_RTOL * gn
    assert params is prog.params and opt is prog.opt_state
    for what, got, want in (("params", params, jp), ("m", opt["m"], jo["m"]),
                            ("v", opt["v"], jo["v"])) + ((("err", err, je),) if comp else ()):
        got, want = _flat(got), _np(want)
        assert sorted(got) == sorted(want), what
        for path, w in want.items():
            diff = np.abs(got[path] - w)
            outside = diff > LEAF_TOL * max(1.0, float(np.abs(w).max()))
            if comp:
                assert int(outside.sum()) <= INT8_FLIPS, (what, path, int(outside.sum()))
                assert float(diff.max()) <= STEPS * OPT["peak_lr"], (what, path)
            else:
                assert not outside.any(), (what, path, float(diff.max()))
    assert int(opt["step"]) == int(jo["step"]) == STEPS


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_staged_step_matches_reference(variant):
    check_variant("olmo-1b-tiny", variant)


# ----------------------------------------------------------------------------
# capture safety
# ----------------------------------------------------------------------------
CAPTURE_CASES = [
    ("dense", "olmo-1b-tiny"),
    ("moe", "qwen3-moe-30b-a3b-tiny"),
    ("recurrent", "xlstm-1.3b-tiny"),
    ("sliding", "gemma3-27b-tiny"),
    ("jamba", "jamba-1.5-large-398b-tiny"),
]


@pytest.mark.parametrize("name", [c[1] for c in CAPTURE_CASES], ids=[c[0] for c in CAPTURE_CASES])
def test_step_body_is_capture_safe(name):
    """The body a CUDA graph captures, the whole step over the program's
    static buffers, makes no uncapturable call; it runs the backward pass
    (the detector sees its ops) and updates the static params in place."""
    tt = _port_trainer(name, microbatches=2, compress=True)
    params, opt, err = tt.init_state(0)
    batch = tt.stream.next_batch()
    prog = TrainProgram(tt, batch, graph=False)
    prog.stage(params, opt, err, batch)
    before = {p: t.clone() for p, t in tree_paths(prog.params)}
    known = (_leaves(prog.params) + _leaves(prog.opt_state) + _leaves(prog.err_buf)
             + [prog.staged])
    seen = []

    class Watch(_CaptureBlockers):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.overloadpacket.__name__)
            return super().__torch_dispatch__(func, types, args, kwargs)

    with Watch(known) as mode:
        metrics = prog.body()
    assert mode.found == []
    assert any(op.endswith("_backward") for op in seen)
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert all(torch.isfinite(v) for v in metrics.values())
    assert int(prog.opt_state["step"]) == 1
    assert any(not torch.equal(t, before[p]) for p, t in tree_paths(prog.params))


# ----------------------------------------------------------------------------
# trees in and out
# ----------------------------------------------------------------------------
def test_without_donate_the_callers_trees_stay_unchanged():
    """Two steps without ``donate``: the given trees keep their values, the
    program's own come back (and pass back without a copy), and metrics
    are copies that the next step leaves alone."""
    tt = _port_trainer("olmo-1b-tiny", microbatches=2, compress=True)
    params, opt, err = tt.init_state(0)
    kept = {name: tree_map(torch.clone, tree) for name, tree in
            (("params", params), ("opt", opt), ("err", err))}
    batch = tt.stream.next_batch()
    prog = TrainProgram(tt, batch, graph=False)
    p1, o1, e1, m1 = prog.step(params, opt, err, batch)
    loss1 = m1["loss"].clone()
    assert p1 is prog.params and o1 is prog.opt_state and e1 is prog.err_buf
    p2, o2, e2, _ = prog.step(p1, o1, e1, tt.stream.next_batch())
    assert p2 is p1 and o2 is o1 and e2 is e1
    assert torch.equal(m1["loss"], loss1)
    for name, tree in (("params", params), ("opt", opt), ("err", err)):
        for (path, t), (_, k) in zip(tree_paths(tree), tree_paths(kept[name])):
            assert torch.equal(t, k), (name, path)
    assert int(opt["step"]) == 0 and int(o2["step"]) == 2


def test_donate_adopts_the_callers_trees():
    tt = _port_trainer("olmo-1b-tiny", donate=True)
    params, opt, err = tt.init_state(0)
    batch = tt.stream.next_batch()
    prog = TrainProgram(tt, batch, graph=False)
    p1, o1, _, _ = prog.step(params, opt, err, batch)
    assert p1 is not params
    assert all(a is b for (_, a), (_, b) in zip(tree_paths(p1), tree_paths(params)))
    assert int(opt["step"]) == 1


def test_a_leaf_of_another_shape_raises():
    tt = _port_trainer("olmo-1b-tiny")
    params, opt, err = tt.init_state(0)
    batch = tt.stream.next_batch()
    prog = TrainProgram(tt, batch, graph=False)
    prog.step(params, opt, err, batch)
    bad = dict(params, embed=params["embed"][:-1])
    with pytest.raises(ValueError, match="shape"):
        prog.step(bad, opt, err, batch)


def _staged(trainer):
    """Route ``trainer.run``'s steps through one staged program."""
    progs = {}

    def step(params, opt, err, batch):
        if "prog" not in progs:
            progs["prog"] = TrainProgram(trainer, batch, graph=False)
        return progs["prog"].step(params, opt, err, batch)

    trainer.train_step = step
    return progs


def test_restored_trees_are_copied_in():
    """A crash before step 3 with a checkpoint after step 2: the program
    still holds step 3's state, so the resumed run matches the
    uninterrupted one only if the restored trees are copied in."""
    whole = _port_trainer("olmo-1b-tiny", microbatches=2, steps=6, ckpt_every=0)
    _staged(whole)
    whole.run(*whole.init_state(0))
    want = [m["loss"] for m in whole.metrics_log]

    tt = _port_trainer("olmo-1b-tiny", microbatches=2, steps=6, ckpt_every=2)
    progs = _staged(tt)
    with pytest.raises(RuntimeError):
        tt.run(*tt.init_state(0), fail_at=3)
    assert int(progs["prog"].opt_state["step"]) == 3
    params, opt, err, step = tt.restore_latest()
    assert step == 2
    tt.run(params, opt, err, start_step=step)
    assert [m["loss"] for m in tt.metrics_log] == want[:3] + want[2:]
    assert int(progs["prog"].opt_state["step"]) == 6


def test_graphs_on_the_cpu_raise():
    cfg = get_config("olmo-1b-tiny")
    args = (T.OptimizerConfig(), T.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                              global_batch=2))
    with pytest.raises(ValueError, match="CUDA"):
        T.Trainer(Model(cfg, device="cpu"), *args, graphs=True)
    assert T.Trainer(Model(cfg, device="cpu"), *args).graphs is False
    assert T.Trainer(Model(cfg, device="cpu"), *args, graphs=False).graphs is False


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
    """One seeded olmo-1b-tiny state trained 4 steps (2 microbatches,
    compression on) eagerly and graphed: every step's loss, lr and
    grad_norm within phase 15's 1e-5 relative, every leaf within 1e-3 of
    the eager leaf's largest magnitude.  The graphed run's capture is made
    while a checkpoint of the start state is still being written (its
    writes slowed so that it spans the capture), and the checkpoint
    restores that state bit for bit."""
    import time

    from repro_torch.train.optim import tree_leaves

    runs = []
    for graphs in (False, True):
        tr = T.Trainer(Model(get_config("olmo-1b-tiny"), device=cuda),
                       T.OptimizerConfig(**OPT),
                       T.DataConfig(vocab_size=get_config("olmo-1b-tiny").vocab_size, seq_len=64,
                                    global_batch=4),
                       T.TrainerConfig(steps=4, ckpt_every=0, microbatches=2, compress_grads=True,
                                       log_every=1),
                       graphs=graphs)
        params, opt, err = tr.init_state(5)
        start = [t.clone() for t in tree_leaves(params)]
        metrics = []
        train_step = tr.train_step

        def keep(p, o, e, batch, train_step=train_step, metrics=metrics):
            out = train_step(p, o, e, batch)
            metrics.append({k: float(v) for k, v in out[3].items()})
            return out

        tr.train_step = keep
        in_flight = []
        if graphs:
            write = tr.fs.write

            def slow_write(*a, **kw):
                time.sleep(0.25)
                return write(*a, **kw)

            tr.fs.write = slow_write
            tr.checkpoint(0, params, opt)
            writer = tr._ckpt_threads[-1]
            first = tr.train_step

            def first_step(p, o, e, batch):
                in_flight.append(writer.is_alive())
                out = first(p, o, e, batch)
                in_flight.append(writer.is_alive())
                tr.train_step = first
                return out

            tr.train_step = first_step
        p, o, e, _ = tr.run(params, opt, err)
        torch.cuda.synchronize()
        if graphs:
            assert in_flight == [True, True]
            (prog,) = tr._steps.values()
            assert prog.graph is not None and prog.replays == 3
            assert tr._get_step(tr.stream.next_batch()) is prog
            tr.fs.write = write
            rp, _, _, step = tr.restore_latest()
            assert step == 0
            for a, b in zip(tree_leaves(rp), start):
                assert torch.equal(a, b)
            tr.close()
            assert tr._steps == {} and tr._graph_pool is None
        runs.append((metrics, {path: t.float().cpu() for path, t in tree_paths(p)},
                     {path: t.float().cpu() for path, t in tree_paths(o["m"])}))
    (em, ep, eo), (gm, gp, go) = runs
    assert len(gm) == len(em) == 4
    for got, want in zip(gm, em):
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-5 * abs(w), (k, got[k], w)
    for got, want in ((gp, ep), (go, eo)):
        for path, w in want.items():
            scale = max(float(w.abs().max()), 1e-30)
            assert float((got[path] - w).abs().max()) <= 1e-3 * scale, path
