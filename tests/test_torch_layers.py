"""The sublayer functions the port added, against the JAX package's.

Each test gives the JAX function and the port's the same numpy inputs and
weights from a seed (the JAX params carried over by
``core.convert.params_from_numpy``) and compares the output and every
state leaf: ``moe_apply`` (with its drop set and aux loss), ``mamba_apply``,
``mlstm_apply``, ``slstm_apply``, ``apply_mrope`` and windowed
``chunked_causal_attention``.  Sequences span several chunks, a ragged
last chunk, one chunk, and a single decode step, from zero and from
carried states.  The JAX side is jitted, as its own tests run it.

Tolerances, float32 throughout: 1e-5 absolute and relative (both packages
sum in different orders).  Mamba's chunk recurrence is a doubling scan in
the port and ``lax.associative_scan`` in the JAX package: the two multiply
the decay factors in different groupings, so its output and SSM state get
1e-4 (up to 27 steps of rounding in each grouping, on values of order 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import layers as L

torch.set_num_threads(1)

LAYER_TOL = 1e-5
SCAN_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["cf4", "cf0.5"])
@pytest.mark.parametrize("B,S", [(2, 24), (1, 40), (3, 1)])
def test_moe_apply_matches_reference(cf, B, S):
    """Output, aux loss and the set of dropped (token, expert) assignments;
    capacity factor 0.5 forces drops, 4.0 none; S = 1 is a decode step."""
    spec = dict(d_model=32, d_ff=24, n_experts=8, top_k=2, capacity_factor=cf)
    jspec, tspec = JL.MoESpec(**spec), L.MoESpec(**spec)
    jparams = JL.moe_init(jax.random.PRNGKey(S), jspec, jnp.float32)
    params = _port_params(jparams)
    x = np.random.default_rng(B * 100 + S).standard_normal((B, S, 32)).astype(np.float32)
    jout, jaux = jax.jit(JL.moe_apply, static_argnums=1)(jparams, jspec, jnp.asarray(x))
    out, aux = L.moe_apply(params, tspec, _t(x))
    _close(out, jout, LAYER_TOL)
    _close(aux, jaux, LAYER_TOL)
    keep = L._moe_route(params, tspec, _t(x))[3]
    route = jax.jit(lambda p, xg: JL._moe_route(p, jspec, xg)[3])
    jkeep = np.stack([np.asarray(route(jparams, jnp.asarray(x[b]))) for b in range(B)])
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if cf < 1.0 and S > 1:
        assert not keep.all()


@pytest.mark.parametrize("S,chunk", [(27, 8), (16, 16), (5, 256), (1, 256)])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_mamba_apply_matches_reference(S, chunk, with_state):
    spec = dict(d_model=32, d_state=8, d_conv=4, expand=2)
    jspec, tspec = JL.MambaSpec(**spec), L.MambaSpec(**spec)
    jparams = JL.mamba_init(jax.random.PRNGKey(7), jspec, jnp.float32)
    params = _port_params(jparams)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    jstate = state = None
    if with_state:
        conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
        ssm = rng.standard_normal((2, 64, 8)).astype(np.float32)
        jstate, state = (jnp.asarray(conv), jnp.asarray(ssm)), (_t(conv), _t(ssm))
    apply = jax.jit(functools.partial(JL.mamba_apply, chunk=chunk), static_argnums=1)
    jy, (jconv, jssm) = apply(jparams, jspec, jnp.asarray(x), jstate)
    y, (conv, ssm) = L.mamba_apply(params, tspec, _t(x), state, chunk=chunk)
    _close(y, jy, SCAN_TOL)
    _close(conv, jconv, LAYER_TOL)
    _close(ssm, jssm, SCAN_TOL)


def test_linear_scan_matches_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t stepped in order,
    at a length that is not a power of two."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 13, 3), generator=g, dtype=torch.float64)
    b = torch.randn((2, 13, 3), generator=g, dtype=torch.float64)
    a_sc, h_sc = L._linear_scan(a, b)
    h, p = torch.zeros((2, 3), dtype=torch.float64), torch.ones((2, 3), dtype=torch.float64)
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        np.testing.assert_allclose(h_sc[:, t].numpy(), h.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a_sc[:, t].numpy(), p.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S,chunk", [(27, 8), (16, 16), (5, 128), (1, 128)])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_mlstm_apply_matches_reference(S, chunk, with_state):
    jspec, tspec = JL.XLSTMSpec(d_model=32, n_heads=2), L.XLSTMSpec(d_model=32, n_heads=2)
    jparams = JL.mlstm_init(jax.random.PRNGKey(8), jspec, jnp.float32)
    params = _port_params(jparams)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    jstate = state = None
    if with_state:
        leaves = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32),
                  rng.standard_normal((2, 2, 16)).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32))
        jstate = tuple(jnp.asarray(v) for v in leaves)
        state = tuple(_t(v) for v in leaves)
    apply = jax.jit(functools.partial(JL.mlstm_apply, chunk=chunk), static_argnums=1)
    jy, jst = apply(jparams, jspec, jnp.asarray(x), jstate)
    y, st = L.mlstm_apply(params, tspec, _t(x), state, chunk=chunk)
    _close(y, jy, LAYER_TOL)
    for got, want in zip(st, jst):
        _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
def test_slstm_apply_matches_reference(S, with_state):
    jspec, tspec = JL.XLSTMSpec(d_model=32, n_heads=2), L.XLSTMSpec(d_model=32, n_heads=2)
    jparams = JL.slstm_init(jax.random.PRNGKey(9), jspec, jnp.float32)
    params = _port_params(jparams)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    jstate = state = None
    if with_state:
        leaves = [rng.standard_normal((2, 32)).astype(np.float32) for _ in range(4)]
        jstate = tuple(jnp.asarray(v) for v in leaves)
        state = tuple(_t(v) for v in leaves)
    jy, jst = jax.jit(JL.slstm_apply, static_argnums=1)(jparams, jspec, jnp.asarray(x), jstate)
    y, st = L.slstm_apply(params, tspec, _t(x), state)
    _close(y, jy, LAYER_TOL)
    for got, want in zip(st, jst):
        _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3)])
def test_apply_mrope_matches_reference(sections):
    """Distinct (t, h, w) ids, so every band is exercised."""
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 7, 1, 3)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta=1e4)
    got = L.apply_mrope(_t(x), _t(pos), sections, theta=1e4)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("S,chunk,window", [(64, 16, 8), (64, 16, 16), (27, 8, 13),
                                            (40, 512, 7), (33, 8, 100)])
def test_windowed_attention_matches_reference(S, chunk, window):
    """The window-limited kv range: windows under, at and over a chunk,
    one chunk only, and a window wider than the sequence."""
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((2, S, 2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    attend = jax.jit(functools.partial(JL.chunked_causal_attention, window=window, chunk=chunk))
    want = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = L.chunked_causal_attention(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    _close(got, want, LAYER_TOL)
