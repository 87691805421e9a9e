"""The port's training substrate against the JAX package's, on the CPU, from
the same seeded numpy inputs (the JAX side jitted, as its trainer runs it):

* **optimizer** — ``adamw_update`` over 1, 2 and 20 updates with float32 and
  with bfloat16 moments, with global-norm clipping active and inactive;
  ``cosine_schedule`` at every step; ``compress_grads`` (int8 values and
  scales equal, no element rounded differently by XLA's CPU division);
* **data** — ``PackedStream`` batches and states byte-equal (ranks 0 and 1);
* **trainer** — the JAX ``Trainer`` and the port's, from the same params
  (the JAX ones, converted), on ``olmo-1b-tiny``: the loss log, the final
  params and every checkpoint generation's leaves, after 1 step and after
  12 (``ckpt_every=4``); microbatches 2 against 1.

Bounds, float32 (the two packages sum in different orders; XLA fuses):

* optimizer: each update from the reference's own state gives params and
  float32 moments within ``OPT_TOL`` (1e-6) × max(1, the leaf's largest
  magnitude) and bf16 moments within one bf16 ulp; the port's own chain of
  updates stays within 1e-6 too, except with bf16 moments *and* clipping
  active, where it stays within ``BF16_CLIP_CHAIN_TOL`` (5e-4; measured
  1.3e-5 after 2 updates, 1.3e-4 after 20): the clip scale is the global
  norm's reciprocal, whose float32 sum XLA adds in another order, so a
  moment within an ulp of a bf16 rounding boundary can round the other
  way, and each such 2^-8 step moves its param by up to about lr × 2^-8
  (lr 1e-2, 20 updates).  Without clipping the bf16 chain stays within
  1e-6 (measured 2.4e-7);
* trainer: the loss log within 2e-6 after 1 step and 1e-5 over 12 steps
  (measured 9.5e-7 and 1.4e-6), every param within ``STEP1_TOL`` (2e-6)
  after 1 step and ``STEP12_TOL`` (1e-5) after 12 (measured 1.07e-6 both:
  AdamW's first steps are about lr × sign(g), so the gradients' float
  differences reach the params only where a gradient is near 0).
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
from repro_torch.train.optim import tree_map, tree_paths

torch.set_num_threads(1)

OPT_TOL = 1e-6
BF16_CLIP_CHAIN_TOL = 5e-4
COMPRESS_ERR_TOL = 1e-8
SCALE_ULP_DIFFS = 8          # of the 100 scales (5 leaves x 20 rounds), measured
STEP1_TOL = 2e-6
STEP12_TOL = 1e-5
LOSS_TOL = {1: 2e-6, 12: 1e-5}

SHAPES = {"w": (64, 32), "norm": {"scale": (32,)},
          "body": {"b_gates": (16,), "wo": (8, 8, 4), "dt_bias": (8,)}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _np(tree):
    return dict(tree_paths(jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                                        if str(np.asarray(x).dtype) == "bfloat16"
                                        else np.asarray(x), tree)))


def _flat(tree):
    return {p: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for p, t in tree_paths(tree)}


def _assert_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max()) if w.size else 0.0
        bound = tol * max(1.0, float(np.abs(w).max()) if w.size else 0.0)
        assert err <= bound, (what, path, err, bound)


def _bf16_ulps(got, want):
    """Largest distance in bf16 ulps between two bf16-valued float32 trees."""
    worst = 0
    for path, w in want.items():
        a = torch.from_numpy(got[path]).to(torch.bfloat16).view(torch.int16).int()
        b = torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).int()
        worst = max(worst, int((a - b).abs().max()) if a.numel() else 0)
    return worst


# ------------------------------------------------------------------- optimizer
def _torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _check_moments(got_state, want_state, moment_dtype, what):
    for key in ("m", "v"):
        got, want = _flat(got_state[key]), _np(want_state[key])
        assert got_state[key]["w"].dtype == getattr(torch, moment_dtype)
        if moment_dtype == "bfloat16":
            assert _bf16_ulps(got, want) <= 1, (what, key)
        else:
            _assert_close(got, want, OPT_TOL, f"{key} {what}")


@pytest.mark.parametrize("clip_norm", [1.0, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype, clip_norm):
    """Each of 20 updates from the reference's own state (one update's
    arithmetic), and the port's own chain of 20 against the reference's,
    checked after 1, 2 and 20."""
    rng = np.random.default_rng(0)
    p0 = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=30, moment_dtype=moment_dtype,
              clip_norm=clip_norm)
    jcfg, tcfg = J.OptimizerConfig(**kw), T.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    jo = J.adamw_init(jp, jcfg)
    tp = tree_map(torch.from_numpy, p0)
    to = T.adamw_init(tp, tcfg)
    update = jax.jit(lambda p, g, o: J.adamw_update(p, g, o, jcfg))
    for n in range(1, 21):
        g = _tree(SHAPES, lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
        sp, so, sm = T.adamw_update(_torch(jp), tree_map(torch.from_numpy, g), _torch(jo), tcfg)
        jp, jo, jm = update(jp, jax.tree.map(jnp.asarray, g), jo)
        assert int(so["step"]) == int(jo["step"]) == n
        assert abs(float(sm["lr"]) - float(jm["lr"])) <= OPT_TOL * kw["peak_lr"]
        assert abs(float(sm["grad_norm"]) - float(jm["grad_norm"])) <= OPT_TOL * float(jm["grad_norm"])
        _assert_close(_flat(sp), _np(jp), OPT_TOL, f"update {n} from the same state")
        _check_moments(so, jo, moment_dtype, f"update {n} from the same state")

        tp, to, _ = T.adamw_update(tp, tree_map(torch.from_numpy, g), to, tcfg)
        if n in (1, 2, 20):
            chain_tol = OPT_TOL
            if moment_dtype == "bfloat16" and clip_norm == 1.0:
                chain_tol = BF16_CLIP_CHAIN_TOL
            _assert_close(_flat(tp), _np(jp), chain_tol, f"params after {n}")
            if moment_dtype == "float32" or clip_norm != 1.0:
                _check_moments(to, jo, moment_dtype, f"after {n}")


def test_adamw_update_bf16_params_match_reference():
    """bf16 params and gradients, float32 moments, clipping active: each of
    20 updates from the reference's own state.  The clipped gradient is
    rounded back to bf16 before the moments see it, as the reference's
    ``clip_by_global_norm`` does; the new params agree within one bf16 ulp
    (the float32 value before the rounding agrees within 1e-6), the
    moments within ``OPT_TOL``."""
    rng = np.random.default_rng(2)
    bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    jp = jax.tree.map(bf16, _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32)))
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=30)
    jcfg, tcfg = J.OptimizerConfig(**kw), T.OptimizerConfig(**kw)
    jo = J.adamw_init(jp, jcfg)
    update = jax.jit(lambda p, g, o: J.adamw_update(p, g, o, jcfg))
    for n in range(1, 21):
        g = jax.tree.map(bf16, _tree(SHAPES, lambda s: (rng.standard_normal(s) * 3)
                                     .astype(np.float32)))
        sp, so, _ = T.adamw_update(_torch(jp), _torch(g), _torch(jo), tcfg)
        jp, jo, _ = update(jp, g, jo)
        assert all(t.dtype == torch.bfloat16 for _, t in tree_paths(sp))
        assert _bf16_ulps(_flat(sp), _np(jp)) <= 1, n
        _check_moments(so, jo, "float32", f"update {n} from the same state")


def test_cosine_schedule_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    js = jax.jit(J.cosine_schedule(J.OptimizerConfig(**kw)))
    ts = T.cosine_schedule(T.OptimizerConfig(**kw))
    for step in range(0, 121):
        want = float(js(jnp.int32(step)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * kw["peak_lr"], (step, got, want)


def test_compress_grads_matches_reference():
    """20 error-feedback rounds, each compressed by the port from the
    reference's own carried error.  XLA's CPU compiles the reference's
    ``max|x| / 127.0`` as a multiplication by the float32 reciprocal of 127
    (its HLO holds ``multiply(x, 0.00787401572)``); the port divides.  So a
    scale may differ by one float32 ulp, and an int8 value only where
    ``x / scale`` falls within that ulp's reach of a rounding half: in
    these 20 rounds 8 of the 100 scales differ by one ulp
    (``SCALE_ULP_DIFFS``) and no int8 value differs.  The new error stays within ``COMPRESS_ERR_TOL``,
    and the port's own chain of 20 decompresses to a sum within 1e-5 of
    the reference's."""
    rng = np.random.default_rng(1)
    g = _tree(SHAPES, lambda s: (rng.standard_normal(s) * 1e-3).astype(np.float32))
    je = J.error_feedback_init(jax.tree.map(jnp.asarray, g))
    te = T.error_feedback_init(tree_map(torch.from_numpy, g))
    compress = jax.jit(J.compress_grads)
    j_sum = t_sum = 0.0
    scale_ulps = []
    for _ in range(20):
        g = _tree(SHAPES, lambda s: (rng.standard_normal(s) * 1e-3).astype(np.float32))
        (sq, ss), se = T.compress_grads(tree_map(torch.from_numpy, g), _torch(je))
        (jq, js), je = compress(jax.tree.map(jnp.asarray, g), je)
        got_q, got_s = dict(tree_paths(sq)), dict(tree_paths(ss))
        for path, want in _np(jq).items():
            assert got_q[path].dtype == torch.int8
            np.testing.assert_array_equal(got_q[path].numpy(), want)
        for path, want in _np(js).items():
            ulps = abs(int(got_s[path].numpy().view(np.int32)) - int(want.view(np.int32)))
            assert ulps <= 1, path
            scale_ulps.append(ulps)
        _assert_close(_flat(se), _np(je), COMPRESS_ERR_TOL, "error feedback")
        (tq, ts), te = T.compress_grads(tree_map(torch.from_numpy, g), te)
        t_sum = t_sum + np.concatenate([v.ravel() for v in _flat(T.decompress_grads((tq, ts))).values()])
        j_sum = j_sum + np.concatenate([v.ravel() for v in _np(J.decompress_grads((jq, js))).values()])
    assert sum(scale_ulps) <= SCALE_ULP_DIFFS
    assert np.abs(t_sum - j_sum).max() <= 1e-5 * np.abs(j_sum).max()


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("rank", [0, 1])
def test_packed_stream_matches_reference(rank):
    kw = dict(vocab_size=50304, seq_len=256, global_batch=8, n_ranks=2, rank=rank)
    js, ts = J.PackedStream(J.DataConfig(**kw)), T.PackedStream(T.DataConfig(**kw))
    for _ in range(5):
        jb, tb = js.next_batch(), ts.next_batch()
        for k in ("tokens", "labels"):
            assert tb[k].dtype == jb[k].dtype and tb[k].tobytes() == jb[k].tobytes()
        jst, tst = js.state(), ts.state()
        for k in ("cursor", "buf"):
            assert tst[k].dtype == jst[k].dtype and tst[k].tobytes() == jst[k].tobytes()


# -------------------------------------------------------------------- trainer
CFG = "olmo-1b-tiny"


def _trainers(steps, ckpt_every, microbatches=(1, 1), **opt):
    opt = {"peak_lr": 1e-3, "warmup_steps": 5, "total_steps": 100, **opt}
    data = dict(vocab_size=256, seq_len=32, global_batch=4)
    jt = J.Trainer(JModel(j_get_config(CFG)), J.OptimizerConfig(**opt), J.DataConfig(**data),
                   J.TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=1,
                                   microbatches=microbatches[0]))
    tt = T.Trainer(Model(get_config(CFG), device="cpu"), T.OptimizerConfig(**opt),
                   T.DataConfig(**data),
                   T.TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=1,
                                   microbatches=microbatches[1]))
    return jt, tt


def _run_both(jt, tt, seed=0):
    """Both trainers from the JAX trainer's ``init_state(seed)``."""
    jp, jo, je = jt.init_state(seed)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    to = T.adamw_init(tp, tt.opt_cfg)
    jp, jo, _, jstep = jt.run(jp, jo, je)
    tp, to, _, tstep = tt.run(tp, to, torch.zeros(()))
    assert jstep == tstep
    return (jp, jo), (tp, to)


def _generation(fs, config):
    fs.switch(config)
    out = {}
    for key in fs.keys():
        v = fs.read(key)
        out[key] = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _check_generation(jt, tt, step, tol):
    want = _generation(jt.fs, jt.ckpt_index[step])
    got = _generation(tt.fs, tt.ckpt_index[step])
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key.startswith(("ckpt/data/", "ckpt/meta/")) or key == "ckpt/opt/step":
            assert g.tobytes() == w.tobytes(), key
        else:
            bound = tol * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= bound, key


@pytest.mark.parametrize("steps", [1, 12])
def test_trainer_matches_reference(steps):
    ckpt_every = 1 if steps == 1 else 4
    jt, tt = _trainers(steps, ckpt_every)
    (jp, _), (tp, _) = _run_both(jt, tt)
    tol = STEP1_TOL if steps == 1 else STEP12_TOL
    assert [m["step"] for m in tt.metrics_log] == [m["step"] for m in jt.metrics_log]
    for a, b in zip(jt.metrics_log, tt.metrics_log):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL[steps], (a, b)
    _assert_close(_flat(tp), _np(jp), tol, "final params")
    # the same retained generations, each with the reference's keys
    assert sorted(tt.ckpt_index) == sorted(jt.ckpt_index)
    assert sorted(tt.fs.keys()) == sorted(jt.fs.keys())
    _check_generation(jt, tt, 1 if steps == 1 else 8, tol)


@pytest.mark.parametrize("jax_microbatches", [1, 2])
def test_trainer_microbatches_match_reference(jax_microbatches):
    """The port's 2 microbatches (float32 accumulation) against the JAX
    trainer's 2, and against its 1 with the reference's own microbatch
    check (no clipping, no warmup, 2 steps, 2e-5)."""
    if jax_microbatches == 2:
        jt, tt = _trainers(12, 0, microbatches=(2, 2))
        tol = STEP12_TOL
    else:
        jt, tt = _trainers(2, 0, microbatches=(1, 2), warmup_steps=0, total_steps=10,
                           clip_norm=1e9)
        tol = 2e-5
    (jp, _), (tp, _) = _run_both(jt, tt, seed=3)
    _assert_close(_flat(tp), _np(jp), tol, "final params")
