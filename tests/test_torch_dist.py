"""The port's sharding rules and logical meshes.

The JAX package's ``tests/test_dist.py`` cases for the functions ported
(``param_specs``, ``enforce_divisible``, ``data_axes``, ``batch_spec``,
``cache_specs``) run on the port, and a differential test holds every spec
equal to the reference's, leaf by leaf along the same paths, for every
architecture on the production meshes (the reference's ``FakeMesh``
stand-ins: no devices needed).  The port's own placement layer (``Mesh``,
``NamedSharding`` keyed by rank, ``ShardedTensor``, ``device_put``,
``from_blocks``) and ``launch.mesh`` are tested on logical meshes on the
CPU.
"""
import pytest

pytest.importorskip("torch")

import jax
import numpy as np
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import arch_names as ref_arch_names
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as JS
from repro_torch.configs import arch_names, get_config
from repro_torch.dist import sharding as TS
from repro_torch.dist.placement import (
    Mesh,
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    device_put,
    from_blocks,
)
from repro_torch.launch import mesh as launch_mesh

torch.set_num_threads(1)


class FakeMesh:
    """Minimal mesh stand-in (the reference test's): specs need only the
    axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)
        self.shape = dict(zip(names, shape))


MESH = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted-key order (the JAX package's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, (P, JP)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_the_archs_are_the_reference_archs():
    assert arch_names() == ref_arch_names()


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", arch_names())
def test_param_specs_cover_every_leaf(arch):
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    specs = dict(_leaves(TS.param_specs(cfg, MESH)))
    shapes = dict(_leaves(Model(cfg, device="meta").param_shapes()))
    assert specs.keys() == shapes.keys()
    n_sharded = 0
    for path, spec in specs.items():
        leaf = shapes[path]
        assert isinstance(spec, P)
        assert len(tuple(spec)) <= len(leaf.shape), (spec, leaf.shape)
        for dim, axes in zip(leaf.shape, tuple(spec)):
            if axes is None:
                continue
            ax = axes if isinstance(axes, tuple) else (axes,)
            size = int(np.prod([MESH.shape[a] for a in ax]))
            assert dim % size == 0, (arch, spec, leaf.shape)
            n_sharded += 1
    assert n_sharded > 0


def test_enforce_divisible_fallback():
    assert tuple(TS.enforce_divisible(P("data", "model"), (4, 1024), MESH)) == (None, "model")
    spec = TS.enforce_divisible(P(("pod", "data"), None), (64, 3), MESH3)
    assert tuple(spec) == (("pod", "data"), None)


def test_enforce_divisible_per_dim_independence():
    spec = TS.enforce_divisible(P("data", "model", None), (32, 17, 5), MESH)
    assert tuple(spec) == ("data", None, None)
    assert tuple(TS.enforce_divisible(P("data", "model"), (7, 9), MESH)) == (None, None)
    spec = TS.enforce_divisible(P(("pod", "data"), "model"), (96, 48), MESH3)
    assert tuple(spec) == (("pod", "data"), "model")
    spec = TS.enforce_divisible(P(("pod", "data"), "model"), (48, 48), MESH3)
    assert tuple(spec) == (None, "model")


def test_data_axes_and_batch_spec():
    assert TS.data_axes(MESH) == ("data",)
    assert TS.data_axes(MESH3) == ("pod", "data")
    assert TS.batch_spec("train", MESH) == P("data", None)
    assert TS.batch_spec("decode", MESH3, long_context=True) == P(None, ("pod", "data"))


def test_cache_specs_seq_sharded():
    cfg = get_config("qwen3-14b")
    assert TS.cache_specs(cfg, MESH)["k"] == P(None, "data", "model", None, None)
    cl = TS.cache_specs(cfg, MESH, long_context=True)
    assert cl["k"] == P(None, None, "data", None, None)
    assert cl["lens"] in (P(), P(None))


# ---------------------------------------------------------------------------
# differential: every spec equals the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", arch_names())
def test_param_specs_equal_the_reference_leaf_by_leaf(arch, mesh):
    want = list(_leaves(JS.param_specs(ref_get_config(arch), mesh)))
    got = list(_leaves(TS.param_specs(get_config(arch), mesh)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g) == tuple(w), (arch, path, g, w)


@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", arch_names())
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    for long_context in (False, True):
        want = JS.cache_specs(ref_get_config(arch), mesh, long_context=long_context)
        got = TS.cache_specs(get_config(arch), mesh, long_context=long_context)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k]) == tuple(want[k]), (arch, k)
        for kind in ("train", "prefill", "decode"):
            assert tuple(TS.batch_spec(kind, mesh, long_context=long_context)) == tuple(
                JS.batch_spec(kind, mesh, long_context=long_context)
            )
    assert TS.data_axes(mesh) == JS.data_axes(mesh)


@pytest.mark.parametrize(
    "entries,shape",
    [
        (("data", "model"), (4, 1024)),
        (("data", "model", None), (32, 17, 5)),
        ((("pod", "data"), "model"), (96, 48)),
        ((("pod", "data"), "model"), (48, 48)),
        ((None, ("data", "model")), (3, 512)),
        (("model",), (8,)),
    ],
)
def test_enforce_divisible_equals_the_reference(entries, shape):
    for mesh in (MESH, MESH3):
        if any(a == "pod" for e in entries if isinstance(e, tuple) for a in e) and mesh is MESH:
            continue
        want = JS.enforce_divisible(JP(*entries), shape, mesh)
        got = TS.enforce_divisible(P(*entries), shape, mesh)
        assert tuple(got) == tuple(want)


# ---------------------------------------------------------------------------
# logical meshes and placement
# ---------------------------------------------------------------------------
def test_partition_spec_normalizes_like_the_reference():
    for entries in [("data", None), (("data",), None), (("pod", "data"), "model"), ((),)]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


def test_indices_map_is_keyed_by_rank_on_one_device():
    mesh = launch_mesh.make_logical_mesh((4, 2), device="cpu")
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.device_set == {torch.device("cpu")}
    sh = NamedSharding(mesh, P("data", "model"))
    imap = sh.addressable_devices_indices_map((8, 6))
    assert sorted(imap) == list(range(8))     # eight ranks, one device
    for rank, index in imap.items():
        d, m = divmod(rank, 2)
        assert index == (slice(2 * d, 2 * d + 2), slice(3 * m, 3 * m + 3))
    # tuple axes: major first; unnamed dims whole
    sh2 = NamedSharding(mesh, P(("model", "data")))
    imap2 = sh2.addressable_devices_indices_map((16, 3))
    assert imap2[1] == (slice(8, 10), slice(0, 3))    # rank 1 = (data 0, model 1)
    with pytest.raises(ValueError):
        sh.addressable_devices_indices_map((6, 6))    # 6 rows over 4 ranks
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("data", "data"))


def test_device_put_blocks_full_and_replicas_share_one_copy():
    mesh = launch_mesh.make_logical_mesh((4, 2), device="cpu")
    x = torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
    st = device_put(x, NamedSharding(mesh, P(None, "model")))
    assert isinstance(st, ShardedTensor) and st.shape == (64, 6) and st.nbytes == x.nbytes
    assert len(st.addressable_shards) == 8 and len(st.unique_shards()) == 2
    # the four data replicas of one model block are one tensor on one device
    by_index = {}
    for sh in st.addressable_shards:
        by_index.setdefault((sh.index[1].start,), set()).add(id(sh.data))
    assert all(len(ids) == 1 for ids in by_index.values())
    assert torch.equal(st.full(), x)
    # blocks are independent copies of the source
    x[0, 0] = -1.0
    assert st.full()[0, 0] == 0.0


def test_reshard_and_from_blocks():
    a = launch_mesh.make_logical_mesh((4, 2), device="cpu")
    b = launch_mesh.make_logical_mesh((2, 4), device="cpu")
    x = torch.randn(32, 16, generator=torch.Generator().manual_seed(0))
    st = device_put(x, NamedSharding(a, P("data", "model")))
    moved = device_put(st, NamedSharding(b, P("model", "data")))
    assert torch.equal(moved.full(), x)
    blocks = [sh.data for sh in moved.addressable_shards]
    again = from_blocks((32, 16), moved.sharding, blocks)
    assert torch.equal(again.full(), x)
    with pytest.raises(ValueError):
        from_blocks((32, 16), moved.sharding, blocks[:-1])


def test_updates_copy_only_the_blocks_they_touch():
    mesh = launch_mesh.make_logical_mesh((4, 2), device="cpu")
    x = torch.zeros(16, 8)
    st = device_put(x, NamedSharding(mesh, P("data", "model")))
    new = st.with_box((slice(5, 7), slice(2, 6)), torch.ones(2, 4))
    want = x.clone()
    want[5:7, 2:6] = 1.0
    assert torch.equal(new.full(), want) and torch.equal(st.full(), x)
    touched = [i for i, (o, n) in enumerate(zip(st.addressable_shards, new.addressable_shards))
               if o.data is not n.data]
    assert touched == [2, 3]                 # rows 4-7 live on data coordinate 1
    flat = device_put(torch.zeros(64), NamedSharding(mesh, P("model")))
    put = flat.with_flat(torch.tensor([3, 40]), torch.tensor([1.0, 2.0]))
    assert put.full()[3] == 1.0 and put.full()[40] == 2.0 and flat.full().sum() == 0


def test_launch_meshes():
    local = launch_mesh.make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        launch_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        launch_mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_logical_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert launch_mesh.make_logical_mesh((4, 2)).device_set == {torch.device("cuda", 0)}
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_mesh.make_logical_mesh((4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_mesh.make_local_mesh()
