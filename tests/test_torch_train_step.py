"""The port's ``Model.loss_fn`` and its backward pass against the JAX
package's, for every architecture: the train-step half of the reference's
``tests/test_models.py::test_smoke_forward_and_train_step``, as a
differential.  Both packages get the same params (the JAX ones, carried
over by ``core.convert.params_from_numpy``) and the same seeded numpy
batch; the JAX side is ``jax.jit(jax.value_and_grad(model.loss_fn))``.

Each arch runs twice: ``remat=False`` with one loss chunk, and
``remat=True`` with a loss chunk of 12 over 32 positions (three chunks, the
last padded with -1 labels), so rematerialization and padding both run.
The batch masks a sixth of the labels with -1, as EOD masking does.

Bounds, float32 throughout: the loss within 1e-5 relative, every gradient
leaf within ``GRAD_TOL`` of that leaf's largest magnitude in the JAX
package's gradient (1e-4; xlstm's recurrences 2e-4, see ``GRAD_TOL``).
The two packages sum in different orders (XLA fuses and reorders
reductions).

The archs are split over this file, ``test_torch_train_step_b.py`` and
``test_torch_train_step_c.py`` so that each file stays well under a
minute.
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
from repro_torch.configs import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.train.optim import tree_map, tree_paths

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
# Per arch, the bound on |grad_port - grad_jax| over the leaf's largest
# |grad_jax|: 1e-4, except xlstm (mLSTM/sLSTM), 2e-4.  Measured on the CPU
# (numpy seed 0, PRNGKey(3)): every arch but xlstm within 6.1e-6 (mamba's
# doubling scan, jamba's w_dt, the largest); xlstm 8.8e-5 at an mLSTM's wk:
# its exp-gated chunk recurrence, with the stabilizer's max() and exp(),
# amplifies float32 rounding of the forward into the gradient, so the
# bound leaves it twice that room rather than a 12% margin.
GRAD_TOL = {"xlstm-1.3b": 2e-4}
B, S = 2, 32
CASES = [(False, 1024), (True, 12)]          # (remat, loss_chunk)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 1 / 6] = -1
    if cfg.input_mode == "embeddings":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "labels": labels}


def jax_loss_and_grads(jmodel, jparams, batch, **kw):
    def loss_of(p, b):
        return jmodel.loss_fn(p, b, **kw)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(model, params, batch, **kw):
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    flat = list(tree_paths(leaves))
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat], allow_unused=True)
    # a leaf the loss does not reach (an unused head) has a zero gradient, as in JAX
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {p: (torch.zeros_like(t) if g is None else g).numpy()
             for (p, t), g in zip(flat, grads)})


def check_arch(arch, remat, loss_chunk):
    name = arch + "-tiny"
    jmodel = JModel(j_get_config(name))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = Model(get_config(name), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _batch(model.cfg)
    kw = dict(remat=remat, loss_chunk=loss_chunk)
    j_loss, j_metrics, j_grads = jax_loss_and_grads(jmodel, jparams, batch, **kw)
    t_loss, t_metrics, t_grads = port_loss_and_grads(model, params, batch, **kw)
    assert np.isfinite(t_loss)
    assert abs(t_loss - j_loss) <= LOSS_RTOL * abs(j_loss), (t_loss, j_loss)
    assert t_metrics["tokens"] == j_metrics["tokens"]
    assert abs(t_metrics["ce"] - j_metrics["ce"]) <= LOSS_RTOL * abs(j_metrics["ce"])
    assert abs(t_metrics["aux"] - j_metrics["aux"]) <= LOSS_RTOL * max(abs(j_metrics["aux"]), 1.0)
    tol = GRAD_TOL.get(arch, 1e-4)
    j_flat = dict(tree_paths(j_grads))
    assert sorted(j_flat) == sorted(t_grads)
    total = 0.0
    for path, want in j_flat.items():
        got = t_grads[path]
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        assert err <= tol, (path, err)
        total += float(np.abs(got).sum())
    assert np.isfinite(total) and total > 0


ARCHS_A = arch_names()[:5]


@pytest.mark.parametrize("remat,loss_chunk", CASES, ids=["plain", "remat-chunked"])
@pytest.mark.parametrize("arch", ARCHS_A)
def test_loss_and_grads_match_reference(arch, remat, loss_chunk):
    check_arch(arch, remat, loss_chunk)
