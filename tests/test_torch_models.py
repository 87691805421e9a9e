"""The port's models against the JAX package's, for every architecture.

The JAX package's ``tests/test_models.py`` on the port (every ``-tiny``
config; the train-step half of its smoke test, as a differential, is in
``test_torch_train_step*.py``), then differentials that give both packages the same
numpy inputs from a seed: the whole model (``forward``, and ``prefill`` +
``decode_step`` on a dense cache with every cache leaf, on the JAX params
carried over by ``core.convert.params_from_numpy``).  The sublayer
differentials are in ``test_torch_layers.py``.

Tolerance, float32 throughout: 1e-4 absolute and relative (both packages
sum in different orders, and mamba's chunk recurrence groups its products
differently, see ``test_torch_layers.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import layers as L

torch.set_num_threads(1)

ARCHS = arch_names()
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _inputs(cfg, rng, B, S):
    if cfg.input_mode == "embeddings":
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def rig(request):
    """(cfg, JAX model, JAX params, port model on the same weights)."""
    name = request.param + "-tiny"
    jmodel = JModel(j_get_config(name))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = Model(get_config(name), device="cpu", params=_port_params(jparams))
    return model.cfg, jmodel, jparams, model


# ---------------------------------------------------------------------------
# the JAX package's tests/test_models.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward(arch):
    """The forward half of the reference's smoke test, on random weights
    drawn by the port."""
    cfg = get_config(arch + "-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    inputs = torch.from_numpy(_inputs(cfg, np.random.default_rng(0), 2, 32))
    hidden, aux = model.forward(inputs)
    assert hidden.shape == (2, 32, cfg.d_model)
    assert bool(torch.isfinite(hidden).all()) and bool(torch.isfinite(aux))
    if cfg.is_moe:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The decode cache path (ring buffers, recurrent states, MoE) against
    the full-sequence forward, with the reference's tolerances."""
    cfg = get_config(arch + "-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(1))
    B, S0, NDEC = 2, 16, 3
    full = torch.from_numpy(_inputs(cfg, np.random.default_rng(2), B, S0 + NDEC))
    hidden, _ = model.forward(full)
    ref_logits = model._logits(hidden)
    cache = model.init_cache(B, S0 + NDEC + 4)
    logits, cache = model.prefill(full[:, :S0], cache)
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, S0 - 1].numpy(), atol=3e-3, rtol=1e-3)
    for t in range(NDEC):
        tok = full[:, S0 + t] if full.dim() == 2 else full[:, S0 + t : S0 + t + 1]
        logits, cache = model.decode_step(tok, cache)
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, S0 + t].numpy(),
                                   atol=3e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_config_estimate(arch):
    cfg = get_config(arch + "-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    actual, est = model.param_count(), cfg.param_count()
    assert abs(actual - est) / max(actual, 1) < 0.05, (arch, actual, est)


def test_sliding_window_masks_long_range():
    """attn_local must not see past the window."""
    cfg = get_config("gemma3-27b-tiny")
    assert cfg.window is not None
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 64, 1, 2, 16), generator=g)
    k = torch.randn((1, 64, 1, 16), generator=g)
    v = torch.randn((1, 64, 1, 16), generator=g)
    out_w = L.chunked_causal_attention(q, k, v, window=8, chunk=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 100.0
    v2[:, 0] += 100.0
    out_w2 = L.chunked_causal_attention(q, k2, v2, window=8, chunk=16)
    np.testing.assert_allclose(out_w[:, -1].numpy(), out_w2[:, -1].numpy(), atol=1e-5)


def test_moe_capacity_drops_are_bounded():
    cfg = get_config("qwen3-moe-30b-a3b-tiny")
    spec = L.MoESpec(d_model=cfg.d_model, d_ff=cfg.moe_d_ff, n_experts=cfg.n_experts,
                     top_k=cfg.top_k, capacity_factor=0.5)  # force drops
    g = torch.Generator().manual_seed(0)
    params = L.moe_init(g, spec, torch.float32, "cpu")
    x = torch.randn((2, 64, cfg.d_model), generator=g)
    out, aux = L.moe_apply(params, spec, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) > 0


def test_mrope_text_equals_rope():
    """M-RoPE with equal (t,h,w) ids must reduce to 1-D RoPE."""
    x = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8)[None].expand(2, 8)
    r1 = L.apply_rope(x, pos)
    r2 = L.apply_mrope(x, torch.stack([pos, pos, pos], dim=-1), (4, 2, 2))
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# whole models: the same weights and inputs in both packages
# ---------------------------------------------------------------------------
def test_forward_matches_reference(rig):
    cfg, jmodel, jparams, model = rig
    inputs = _inputs(cfg, np.random.default_rng(3), 2, 24)
    pos_offset = np.asarray([0, 5], np.int32)
    forward = jax.jit(functools.partial(jmodel.forward, remat=False))
    jh, jaux = forward(jparams, jnp.asarray(inputs), pos_offset=jnp.asarray(pos_offset))
    h, aux = model.forward(_t(inputs), pos_offset=_t(pos_offset))
    _close(h, jh, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


def test_dense_cache_matches_reference(rig):
    """``init_cache`` + ``prefill`` + ``decode_step``, every cache leaf
    (ring buffers and recurrent states included) after the last call; a
    windowed config's prompt is longer than its window, so its ring buffer
    wraps at prefill and again at decode."""
    cfg, jmodel, jparams, model = rig
    B, NDEC = 2, 3
    S0 = cfg.window + 4 if cfg.window else 12
    MAX = S0 + 8
    full = _inputs(cfg, np.random.default_rng(4), B, S0 + NDEC)
    jcache = jmodel.init_cache(B, MAX)
    cache = model.init_cache(B, MAX)
    assert jax.tree.structure(jax.tree.map(np.asarray, jcache)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), cache))
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(full[:, :S0]), jcache)
    decode = jax.jit(jmodel.decode_step)
    logits, cache = model.prefill(_t(full[:, :S0]), cache)
    _close(logits, jlogits, MODEL_TOL)
    for t in range(NDEC):
        tok = full[:, S0 + t] if full.ndim == 2 else full[:, S0 + t : S0 + t + 1]
        jlogits, jcache = decode(jparams, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(_t(tok), cache)
        _close(logits, jlogits, MODEL_TOL)
    for got, want in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), cache)),
                         jax.tree.leaves(jax.tree.map(np.asarray, jcache))):
        _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_bf16_params_carry_their_float32_leaves(arch):
    """Under a bf16 config, ``params_from_numpy`` carries every leaf with
    its dtype and bits: the float32 router, ``dt_bias``, ``A_log``, ``D``,
    ``w_if``, ``b_if`` and ``b_gates`` stay float32 beside bf16 weights."""
    cfg = dataclasses.replace(j_get_config(arch + "-tiny"), dtype="bfloat16",
                              param_dtype="bfloat16")
    jparams = JModel(cfg).init(jax.random.PRNGKey(0))
    params = _port_params(jparams)
    leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    f32 = set()
    for path, want in leaves:
        got = params
        for key in path:
            got = got[key.key]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        if want.dtype == np.float32:
            f32.add(path[-1].key)
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    assert f32 & {"router", "dt_bias", "A_log", "D", "w_if", "b_if", "b_gates"}

