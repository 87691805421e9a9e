"""Gradients through the port's layers against the JAX package's, where the
whole-model differentials (``test_torch_train_step*.py``) cannot reach at
the tiny configs' 32 positions: the MoE with capacity drops (the tiny
configs are drop-free), mamba's doubling scan and mLSTM's chunk recurrence
over several chunks, the sLSTM loop, and windowed chunked attention over
several query and key chunks.

Each case feeds both packages the same params (the JAX ones, converted)
and the same seeded input, and compares the gradients of ``sum(out * r)``
(``r`` a fixed seeded weight; plus the MoE's aux loss) with respect to the
input and to every param leaf, each within ``GRAD_TOL`` of that leaf's
largest magnitude, float32 throughout: ``GRAD_TOL`` = 1e-4, as for the
whole models (measured on the CPU: at most 4.9e-7 in every case).
"""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as JL
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.train.optim import tree_map, tree_paths

torch.set_num_threads(1)

GRAD_TOL = 1e-4


def _grads_match(case, jfn, tfn, jparams, x):
    rng = np.random.default_rng(7)
    out_shape = jax.eval_shape(lambda p, xx: jfn(p, xx), jparams, jnp.asarray(x))
    r = rng.standard_normal(out_shape.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jfn(p, xx) * r)

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x))
    tparams = tree_map(lambda t: t.requires_grad_(),
                       params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(tfn(tparams, tx) * torch.from_numpy(r))
    flat = list(tree_paths(tparams))
    grads = torch.autograd.grad(loss, [tx] + [t for _, t in flat], allow_unused=True)
    want = {"x": np.asarray(jg_x), **dict(tree_paths(jax.tree.map(np.asarray, jg_p)))}
    got = {"x": grads[0]}
    got.update({p: (torch.zeros_like(t) if g is None else g) for (p, t), g in zip(flat, grads[1:])})
    assert sorted(got) == sorted(want), case
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path].detach().numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (case, path, err)


def test_moe_grads_with_capacity_drops_match_reference():
    """Capacity factor 0.5: most (token, expert) assignments drop into slot
    C, which is cut off, so they get no gradient; the kept ones, the gates
    and the router's aux term do."""
    kw = dict(d_model=32, d_ff=16, n_experts=4, top_k=2, capacity_factor=0.5)
    jspec, tspec = JL.MoESpec(**kw), L.MoESpec(**kw)
    jparams = JL.moe_init(jax.random.PRNGKey(0), jspec, jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 64, 32)).astype(np.float32)
    # the capacity rule really drops here
    keep = L._moe_route(
        params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), tspec,
        torch.from_numpy(x))[3]
    assert 0 < int((~keep).sum()) < keep.numel()

    def jfn(p, xx):
        out, aux = JL.moe_apply(p, jspec, xx)
        return out + aux

    def tfn(p, xx):
        out, aux = L.moe_apply(p, tspec, xx)
        return out + aux

    _grads_match("moe", jfn, tfn, jparams, x)


def test_mamba_grads_over_several_chunks_match_reference():
    """S = 40 in chunks of 16: three chunks, the last padded."""
    kw = dict(d_model=32, d_state=8, d_conv=4, expand=2)
    jspec, tspec = JL.MambaSpec(**kw), L.MambaSpec(**kw)
    jparams = JL.mamba_init(jax.random.PRNGKey(1), jspec, jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 40, 32)).astype(np.float32)
    _grads_match("mamba", lambda p, xx: JL.mamba_apply(p, jspec, xx, chunk=16)[0],
                 lambda p, xx: L.mamba_apply(p, tspec, xx, chunk=16)[0],
                 jparams, x)


def test_mlstm_grads_over_several_chunks_match_reference():
    """S = 40 in chunks of 16: the (C, n, m) carry crosses two chunk
    boundaries, the last chunk padded (log input gate -1e30)."""
    jspec, tspec = JL.XLSTMSpec(d_model=32, n_heads=2), L.XLSTMSpec(d_model=32, n_heads=2)
    jparams = JL.mlstm_init(jax.random.PRNGKey(2), jspec, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 40, 32)).astype(np.float32)
    _grads_match("mlstm", lambda p, xx: JL.mlstm_apply(p, jspec, xx, chunk=16)[0],
                 lambda p, xx: L.mlstm_apply(p, tspec, xx, chunk=16)[0],
                 jparams, x)


def test_slstm_grads_match_reference():
    jspec, tspec = JL.XLSTMSpec(d_model=32, n_heads=2), L.XLSTMSpec(d_model=32, n_heads=2)
    jparams = JL.slstm_init(jax.random.PRNGKey(3), jspec, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 24, 32)).astype(np.float32)
    _grads_match("slstm", lambda p, xx: JL.slstm_apply(p, jspec, xx)[0],
                 lambda p, xx: L.slstm_apply(p, tspec, xx)[0],
                 jparams, x)


@pytest.mark.parametrize("window", [None, 12], ids=["causal", "window12"])
def test_chunked_attention_grads_match_reference(window):
    """S = 40 in chunks of 8: five query chunks, the port skipping the key
    chunks the reference computes fully masked (and, with a window, the
    clamped duplicates before chunk 0)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 2, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 40, 2, 16)).astype(np.float32)
    params = {"k": kv[0], "v": kv[1]}

    def jfn(p, qq):
        return JL.chunked_causal_attention(qq, p["k"], p["v"], window=window, chunk=8)

    def tfn(p, qq):
        return L.chunked_causal_attention(qq, p["k"], p["v"], window=window, chunk=8)

    _grads_match(f"attention {window}", jfn, tfn, jax.tree.map(jnp.asarray, params), q)
