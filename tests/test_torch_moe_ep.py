"""The port's expert-parallel MoE over logical meshes.

The reference's ``_moe_apply_shard_map`` needs one JAX device per rank, so
it runs once per module in a subprocess with eight fake host devices
(``--xla_force_host_platform_device_count=8``, as the JAX package's
multi-device lane does); its routing inside ``shard_map`` is recorded per
device through ``jax.debug.callback``.  The same numpy inputs and params go
through the port's EP path on the same layouts, with a capacity factor of
0.5 so that assignments drop.  The other cases run the port alone: EP
against ``moe_apply`` per shard, replicas along "model", the ``E % ep``
error, gradients, views of the weights, and the collectives against numpy
definitions of JAX's tiled semantics with the ledger's counts.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.placement import NamedSharding, PartitionSpec as P, device_put
from repro_torch.dist.sharding import activation_sharding
from repro_torch.launch.mesh import make_logical_mesh
from repro_torch.models import layers as L

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, F, K = 64, 32, 2                      # qwen3-moe-30b-a3b-tiny's widths, top-2
B, S = 8, 32
# (mesh shape, seq_parallel, experts); (1, 8) needs 8 experts to split 8 ways
LAYOUTS = [((2, 4), False, 4), ((2, 4), True, 4), ((4, 2), True, 4), ((1, 8), False, 8),
           ((8, 1), False, 4)]
IDS = [f"{a}x{b}-sp{int(sp)}-E{e}" for (a, b), sp, e in LAYOUTS]

REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import layers as L
from repro.dist.sharding import activation_sharding

inp = np.load(sys.argv[1])
rec = []
route = L._moe_route

def recorded(params, spec, x_flat):
    out = route(params, spec, x_flat)
    d, m = jax.lax.axis_index("data"), jax.lax.axis_index("model")
    jax.debug.callback(lambda d, m, k: rec.append((int(d), int(m), np.asarray(k))), d, m, out[3])
    return out

L._moe_route = recorded
res = {}
for i, (rows, cols, sp, E) in enumerate(inp["layouts"]):
    spec = L.MoESpec(d_model=int(inp["D"]), d_ff=int(inp["F"]), n_experts=int(E),
                     top_k=int(inp["K"]), capacity_factor=0.5)
    params = {k: jnp.asarray(inp[f"E{E}_{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    mesh = Mesh(np.array(jax.devices()[: rows * cols]).reshape(rows, cols), ("data", "model"))
    rec.clear()
    with activation_sharding(dp=("data",), mesh=mesh, seq_parallel=bool(sp)):
        out, aux = L.moe_apply(params, spec, jnp.asarray(inp["x"]))
    jax.effects_barrier()
    res[f"{i}_out"] = np.asarray(out)
    res[f"{i}_aux"] = np.asarray(aux)
    for d, m, keep in rec:
        res[f"{i}_keep_{d * cols + m}"] = keep
np.savez(sys.argv[2], **res)
"""


def _params(E, seed):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((D, E)) / 8).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F)) / 8).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F)) / 8).astype(np.float32),
        "w_down": (rng.standard_normal((E, F, D)) / 6).astype(np.float32),
    }


def _inputs():
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32)
    params = {E: _params(E, E) for E in (4, 8)}
    return x, params


def _spec(E, capacity_factor=0.5):
    return L.MoESpec(d_model=D, d_ff=F, n_experts=E, top_k=K, capacity_factor=capacity_factor)


def _torch(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's EP outputs, aux and per-device keep masks, every layout."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    x, params = _inputs()
    arrays = {"x": x, "D": D, "F": F, "K": K,
              "layouts": np.array([[a, b, int(sp), e] for (a, b), sp, e in LAYOUTS])}
    for E, p in params.items():
        arrays.update({f"E{E}_{k}": v for k, v in p.items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz")],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


@contextlib.contextmanager
def _recorded_keeps(sink):
    """Every routing call's keep mask, in call order (the EP path routes
    rank by rank, in rank order)."""
    route = L._moe_route

    def recorded(params, spec, x):
        out = route(params, spec, x)
        sink.append(out[3].reshape(-1).numpy())
        return out

    L._moe_route = recorded
    try:
        yield sink
    finally:
        L._moe_route = route


def _ep(params, spec, x, shape, sp):
    mesh = make_logical_mesh(shape, device="cpu")
    with activation_sharding(dp=("data",), mesh=mesh, seq_parallel=sp):
        return L.moe_apply(params, spec, x)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("layout", range(len(LAYOUTS)), ids=IDS)
def test_ep_matches_the_reference_shard_map(reference, layout):
    """Output within 1e-5, aux within 1e-6 and every rank's drop set equal
    to the reference's ``_moe_apply_shard_map`` on the same layout."""
    (rows, cols), sp, E = LAYOUTS[layout]
    x, params = _inputs()
    with _recorded_keeps([]) as keeps:
        out, aux = _ep(_torch(params[E]), _spec(E), torch.from_numpy(x), (rows, cols), sp)
    np.testing.assert_allclose(out.numpy(), reference[f"{layout}_out"], rtol=0, atol=1e-5)
    assert abs(float(aux) - float(reference[f"{layout}_aux"])) <= 1e-6
    assert len(keeps) == rows * cols
    dropped = 0
    for rank, keep in enumerate(keeps):
        want = reference[f"{layout}_keep_{rank}"].reshape(-1)
        assert np.array_equal(keep, want), f"rank {rank}: drop sets differ"
        dropped += int((~keep).sum())
    assert dropped > 0, "the layout should drop assignments at capacity factor 0.5"


@pytest.mark.parametrize("layout", range(len(LAYOUTS)), ids=IDS)
def test_ep_equals_moe_apply_per_shard(layout):
    """Each rank's block equals ``moe_apply`` run on that shard's tokens as
    one group (capacity per shard), replicas along "model" compute the same
    rows, and aux is the mean of the shards' aux."""
    (rows, cols), sp, E = LAYOUTS[layout]
    x, params = _inputs()
    params, spec, xt = _torch(params[E]), _spec(E), torch.from_numpy(x)
    mesh = make_logical_mesh((rows, cols), device="cpu")
    with activation_sharding(dp=("data",), mesh=mesh, seq_parallel=sp) as ctx:
        sharding, outs, auxes = L._moe_ep_ranks(params, spec, xt, ctx)
        out, aux = L.moe_apply(params, spec, xt)
    shard_aux = []
    first = {}
    for rank, index in sharding.addressable_devices_indices_map(xt.shape).items():
        xl = xt[index]
        Bl, Sl, _ = xl.shape
        want, a = L.moe_apply(params, spec, xl.reshape(1, Bl * Sl, D))
        torch.testing.assert_close(outs[rank], want.reshape(Bl, Sl, D), rtol=0, atol=1e-6)
        torch.testing.assert_close(out[index], outs[rank], rtol=0, atol=0)
        key = tuple((s.start, s.stop) for s in index)
        if key in first:
            assert torch.equal(outs[rank], outs[first[key]]), f"replica rank {rank} differs"
        first.setdefault(key, rank)
        shard_aux.append(float(a))
    assert abs(float(aux) - float(np.mean(shard_aux))) <= 1e-6
    assert set(auxes) == set(range(rows * cols))


def test_ep_degree_must_divide_the_experts():
    x, params = _inputs()
    with pytest.raises(AssertionError, match="experts 4 must divide EP degree 8"):
        _ep(_torch(params[4]), _spec(4), torch.from_numpy(x), (1, 8), False)


def test_a_batch_that_does_not_split_raises():
    """A batch that does not divide over the data axes raises, as
    ``shard_map`` does: no fall-back to the local path."""
    x, params = _inputs()
    with pytest.raises(ValueError, match="does not split evenly"):
        _ep(_torch(params[4]), _spec(4), torch.from_numpy(x[:6]), (4, 2), False)


@pytest.mark.parametrize("shape,sp", [((2, 4), True), ((1, 4), False)], ids=["2x4-sp", "1x4"])
def test_ep_gradients_equal_the_local_path(shape, sp):
    """Drop-free (capacity factor 4), the EP path's gradients with respect
    to x, the router and the expert weights equal the local path's within
    1e-5 of each gradient's largest magnitude (float32 sums over the
    tokens group by shard on the EP path)."""
    x, params = _inputs()
    spec = _spec(4, capacity_factor=4.0)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32))

    def grads(ep):
        p = {k: v.requires_grad_() for k, v in _torch(params[4]).items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        out, _ = _ep(p, spec, xt, shape, sp) if ep else L.moe_apply(p, spec, xt)
        gs = torch.autograd.grad((out * g).sum(), [xt] + [p[k] for k in sorted(p)])
        return dict(zip(["x"] + sorted(p), gs))

    want, got = grads(False), grads(True)
    for k in want:
        scale = max(1.0, float(want[k].abs().max()))
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


def test_ep_reads_the_weights_in_place():
    """Without an FSDP gather the expert FFN runs on views of the whole
    weights: no second copy of the expert weights."""
    x, params = _inputs()
    params = _torch(params[4])
    seen = []
    ffn = L._moe_expert_ffn

    def recorded(t, wg, wu, wd, act):
        seen.append((wg, wu, wd))
        return ffn(t, wg, wu, wd, act)

    L._moe_expert_ffn = recorded
    try:
        _ep(params, _spec(4), torch.from_numpy(x), (1, 4), False)
    finally:
        L._moe_expert_ffn = ffn
    assert len(seen) == 4
    for rank, ws in enumerate(seen):
        for w, name in zip(ws, ("w_gate", "w_up", "w_down")):
            whole = params[name]
            assert w.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
            assert torch.equal(w, whole[rank * 1:(rank + 1) * 1])


def test_ep_takes_sharded_weights_laid_out_as_its_specs():
    """``ShardedTensor`` weights laid out as the EP specs give their own
    blocks (the same output); another layout raises."""
    x, params = _inputs()
    tp = _torch(params[4])
    mesh = make_logical_mesh((2, 4), device="cpu")
    specs = {"router": P("data", None), "w_gate": P("model", "data", None),
             "w_up": P("model", "data", None), "w_down": P("model", None, "data")}
    sharded = {k: device_put(v, NamedSharding(mesh, specs[k])) for k, v in tp.items()}
    xt = torch.from_numpy(x)
    with activation_sharding(dp=("data",), mesh=mesh):
        want, _ = L.moe_apply(tp, _spec(4), xt)
        got, _ = L.moe_apply(sharded, _spec(4), xt)
        assert torch.equal(got, want)
        sharded["w_up"] = device_put(tp["w_up"], NamedSharding(mesh, P("model", None, None)))
        with pytest.raises(ValueError, match="is not laid out as"):
            L.moe_apply(sharded, _spec(4), xt)


# ---------------------------------------------------------------------------
# the collectives against numpy definitions of JAX's tiled semantics
# ---------------------------------------------------------------------------
def _np_group(mesh_shape, axes, axis, rank):
    """The ranks of ``rank``'s group along ``axis``, in axis-index order."""
    coords = list(np.unravel_index(rank, mesh_shape))
    at = axes.index(axis)
    out = []
    for i in range(mesh_shape[at]):
        c = list(coords)
        c[at] = i
        out.append(int(np.ravel_multi_index(c, mesh_shape)))
    return out


CASES = [((2, 4), "model"), ((2, 4), "data"), ((4, 2), "model"), ((2, 2, 2), "b"), ((1, 8), "a")]


@pytest.mark.parametrize("shape,axis", CASES, ids=[f"{s}-{a}" for s, a in CASES])
def test_collectives_follow_jax_tiled_semantics(shape, axis):
    axes = ("a", "b", "c")[: len(shape)] if axis in ("a", "b") else ("data", "model")
    mesh = make_logical_mesh(shape, axes, device="cpu")
    n = mesh.shape[axis]
    rng = np.random.default_rng(sum(shape))
    blocks = {r: rng.standard_normal((4 * n, 3, 2 * n)).astype(np.float32) for r in range(mesh.size)}
    tb = {r: torch.from_numpy(b) for r, b in blocks.items()}
    item = 4
    col.reset_ledger()
    gathered = col.all_gather(tb, mesh, axis, dim=1)
    a2a = col.all_to_all(tb, mesh, axis, split_axis=0, concat_axis=2)
    means = col.pmean({r: t[0, 0, 0] for r, t in tb.items()}, mesh, axis)
    led = col.ledger()
    for r in range(mesh.size):
        group = _np_group(shape, axes, axis, r)
        i = group.index(r)
        np.testing.assert_array_equal(gathered[r].numpy(), np.concatenate([blocks[g] for g in group], 1))
        want = np.concatenate([np.split(blocks[g], n, axis=0)[i] for g in group], axis=2)
        np.testing.assert_array_equal(a2a[r].numpy(), want)
        np.testing.assert_allclose(float(means[r]), np.mean([blocks[g][0, 0, 0] for g in group]),
                                   rtol=1e-6)
        others = (n - 1) * blocks[r].nbytes
        assert led["received"].get("all_gather", {}).get(r, 0) == others
        assert led["received"].get("all_to_all", {}).get(r, 0) == others // n
        assert led["received"].get("pmean", {}).get(r, 0) == (n - 1) * item
    assert led["calls"] == {"all_gather": 1, "all_to_all": 1, "pmean": 1}
    if n == 1:
        assert all(gathered[r] is tb[r] and a2a[r] is tb[r] for r in tb)


def test_collectives_carry_gradients():
    mesh = make_logical_mesh((2, 2), device="cpu")
    tb = {r: torch.full((2, 2), float(r), requires_grad=True) for r in range(4)}
    out = col.all_to_all(col.all_gather(tb, mesh, "model", dim=0), mesh, "data", 0, 1)
    total = sum((o * (r + 1)).sum() for r, o in out.items())
    grads = torch.autograd.grad(total, [tb[r] for r in range(4)])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_moe_ep_ledger_bytes_follow_the_formula():
    """Per rank: (ep-1)/ep of its (E, C, D) buffer each way; the FSDP gather
    (n_data - 1) times its three expert-weight blocks and its router block."""
    x, params = _inputs()
    E = 4
    col.reset_ledger()
    _ep(_torch(params[E]), _spec(E), torch.from_numpy(x), (2, 2), False)
    led = col.ledger()["received"]
    T = (B // 2) * S
    C = _spec(E).capacity(T)
    ep, n_data = 2, 2
    a2a = (ep - 1) * E * C * D * 4 // ep
    gather = (n_data - 1) * ((E // ep) * (D // n_data) * F * 4 * 3 + (D // n_data) * E * 4)
    for r in range(4):
        assert led["all_to_all"][r] == 2 * a2a
        assert led["all_gather"][r] == gather


def test_collectives_take_every_rank():
    mesh = make_logical_mesh((2, 2), device="cpu")
    blocks = {r: torch.zeros(2) for r in range(3)}
    for op in (lambda b: col.all_gather(b, mesh, "data", 0),
               lambda b: col.all_to_all(b, mesh, "data", 0, 0),
               lambda b: col.pmean(b, mesh, "data")):
        with pytest.raises(ValueError, match="one tensor for each of the 4 ranks"):
            op(blocks)
    with pytest.raises(ValueError, match="does not split 2 ways"):
        col.all_to_all({r: torch.zeros(3) for r in range(4)}, mesh, "model", 0, 0)
