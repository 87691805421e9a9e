"""The port's activation constraints against the JAX package's.

The reference's four ``constrain`` tests (``tests/test_dist.py``) run on
the port, capturing ``repro_torch.dist.placement.with_sharding_constraint``
as they capture ``jax.lax.with_sharding_constraint``.  Then, for every
tiny architecture, the set of ``(shape, spec)`` pairs that reach the
constraint over one pass, under one context, in both packages: the
reference traced by ``jax.make_jaxpr`` (each ``lax.scan`` body traced
once; a set does not count repeats) with its ``with_sharding_constraint``
patched, the port run eagerly with its own patched.  The passes are
``loss_fn`` (the forward and the chunked loss) and ``prefill`` +
``decode_step`` on a dense cache.
"""
import pytest

pytest.importorskip("torch")

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro_torch.dist.placement as placement
from repro.configs import arch_names
from repro.configs import get_config as j_get_config
from repro.dist import sharding as jsh
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.dist.placement import NamedSharding, PartitionSpec as P
from repro_torch.dist.sharding import activation_sharding, constrain, current_act_ctx
from repro_torch.launch.mesh import make_logical_mesh
from repro_torch.models import Model

torch.set_num_threads(1)


@contextlib.contextmanager
def _captured(module, sink):
    """Replace ``module.with_sharding_constraint`` by a recorder of
    ``(shape, spec entries)``; restored on exit."""
    real = module.with_sharding_constraint

    def fake(x, sharding):
        spec = getattr(sharding, "spec", sharding)
        sink.append((tuple(int(d) for d in x.shape), tuple(spec)))
        return x

    module.with_sharding_constraint = fake
    try:
        yield sink
    finally:
        module.with_sharding_constraint = real


# ---------------------------------------------------------------------------
# the reference's constrain tests on the port
# ---------------------------------------------------------------------------
def test_constrain_noop_without_context():
    x = torch.ones((4, 4))
    assert current_act_ctx() is None
    assert constrain(x, ("dp", None)) is x       # no ctx → exact identity
    assert constrain(x, ("model", "kv")) is x
    assert constrain(x, (None, None)) is x


def test_constrain_literal_axis_passthrough():
    """Names that are not logical axes pass through as literal mesh axes."""
    with _captured(placement, []) as got:
        with activation_sharding(dp=("data",)):
            constrain(torch.ones((2, 2)), ("dp", "expert"))
    assert got[-1][1] == P("data", "expert")


def test_attn_shard_kv_vs_group_resolution():
    """GQA head-axis TP routing: ``kv`` and ``group`` are mutually
    exclusive per architecture."""
    assert get_config("qwen3-14b").attn_shard == "kv"
    assert get_config("gemma-2b").attn_shard == "group"
    assert get_config("qwen2-vl-2b").attn_shard == "group"
    with _captured(placement, []) as got:
        for arch, want_kv, want_group in (
            ("qwen3-14b", "model", None),
            ("gemma-2b", None, "model"),
            ("qwen2-vl-2b", None, "model"),
        ):
            with activation_sharding(attn_shard=get_config(arch).attn_shard):
                constrain(torch.ones((2, 2)), ("kv", "group"))
            assert got[-1][1] == P(want_kv, want_group), arch


def test_constrain_resolution_under_context():
    with _captured(placement, []) as got:
        with activation_sharding(dp=("data",), attn_shard="group", seq_parallel=True):
            constrain(torch.ones((2, 2, 2)), ("dp", "sp", "group"))
        assert got[-1][1] == P("data", "model", "model")
        with activation_sharding(dp=(), seq=("data",), attn_shard="kv"):
            constrain(torch.ones((2, 2)), ("dp", "seq"))
        assert got[-1][1] == P(None, "data")
    assert current_act_ctx() is None             # every context popped


# ---------------------------------------------------------------------------
# the port's own checks: with a mesh, the constraint is a checked identity
# ---------------------------------------------------------------------------
def test_constrain_under_a_mesh_is_a_checked_identity():
    mesh = make_logical_mesh((2, 4), device="cpu")
    x = torch.arange(24.0).reshape(2, 3, 4)
    with _captured(placement, []) as got:
        with activation_sharding(dp=("data",), mesh=mesh):
            constrain(x, ("dp", "model", "model"))
    # enforce_divisible drops "model" from the 3-long dim; the spec keeps its length
    assert got[-1] == ((2, 3, 4), ("data", None, "model"))
    with activation_sharding(dp=("data",), mesh=mesh):
        assert constrain(x, ("dp", None, "model")) is x


def test_with_sharding_constraint_rejects_bad_specs():
    mesh = make_logical_mesh((2, 2), device="cpu")
    x = torch.ones((2, 2))
    assert placement.with_sharding_constraint(x, P("data", None)) is x
    assert placement.with_sharding_constraint(x, NamedSharding(mesh, P(None, "model"))) is x
    with pytest.raises(ValueError, match="more entries"):
        placement.with_sharding_constraint(x, P("data", None, None))
    with pytest.raises(ValueError, match="not an axis name"):
        placement.with_sharding_constraint(x, P(3, None))
    with pytest.raises(TypeError):
        placement.with_sharding_constraint(x, ("data", None))
    with pytest.raises(ValueError, match="not in"):
        placement.with_sharding_constraint(x, NamedSharding(mesh, P("pod", None)))


def test_contexts_nest_per_thread():
    import threading

    with activation_sharding(dp=("a",)) as outer:
        with activation_sharding(dp=("b",)):
            assert current_act_ctx()["dp"] == ("b",)
            seen = []
            t = threading.Thread(target=lambda: seen.append(current_act_ctx()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and seen == [None]
        assert current_act_ctx() is outer


# ---------------------------------------------------------------------------
# (shape, spec) sets against the reference, every tiny arch
# ---------------------------------------------------------------------------
B, S, MAX_SEQ = 2, 8, 16
CTX = dict(dp=("pod", "data"), seq=("model",), seq_parallel=True)


def _batch(cfg, rng):
    if cfg.input_mode == "embeddings":
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        key = "embeds"
    else:
        inputs = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        key = "tokens"
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    step = (rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            if key == "embeds" else rng.integers(0, cfg.vocab_size, size=(B,)).astype(np.int32))
    return key, inputs, labels, step


def _reference_pairs(arch, mode):
    cfg = j_get_config(arch + "-tiny")
    model = JModel(cfg)
    shapes = model.param_shapes()
    key, inputs, labels, step = _batch(cfg, np.random.default_rng(0))
    sink = []
    with _captured(jax.lax, sink), jsh.activation_sharding(attn_shard=cfg.attn_shard, **CTX):
        if mode == "loss":
            jax.make_jaxpr(lambda p, i, y: model.loss_fn(p, {key: i, "labels": y}))(
                shapes, inputs, labels)
        else:
            cache = jax.eval_shape(lambda: model.init_cache(B, MAX_SEQ))

            def serve(p, c, i, t):
                _, c = model.prefill(p, i, c)
                return model.decode_step(p, t, c)

            jax.make_jaxpr(serve)(shapes, cache, inputs, step)
    return set(sink)


def _port_pairs(arch, mode):
    cfg = get_config(arch + "-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    key, inputs, labels, step = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in _batch(cfg, np.random.default_rng(0)))
    sink = []
    with torch.no_grad(), _captured(placement, sink), \
            activation_sharding(attn_shard=cfg.attn_shard, **CTX):
        if mode == "loss":
            model.loss_fn(model.params, {key: inputs, "labels": labels})
        else:
            _, cache = model.prefill(inputs, model.init_cache(B, MAX_SEQ))
            model.decode_step(step, cache)
    return set(sink)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mode", ["loss", "serve"])
@pytest.mark.parametrize("arch", arch_names())
def test_constraint_sets_equal_the_reference(arch, mode):
    want = _reference_pairs(arch, mode)
    got = _port_pairs(arch, mode)
    assert want, "the reference reached no constraint"
    assert got == want, (sorted(got - want), sorted(want - got))
