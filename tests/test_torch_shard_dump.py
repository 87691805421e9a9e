"""Shard-native dumps in the port: canonical tile plans, gather-free per-part
encode, cross-layout digest identity, and sharded restore.

The JAX package's ``tests/test_shard_dump.py`` runs here on the port; its
multi-device cases run on the port's *logical* meshes — (4, 2), (2, 4) and
(1, 1) ranks on the CPU — so they need no faked devices.  Differential
tests hold the port to the reference exactly: ``TilePlan`` and the host
tile grids bit for bit, and one write/checkpoint/rollback chain on the
reference's single-device ``ShardedArrayState`` and on the port's
``ShardedTensorState`` under all three layouts gives the same tile grids
and chunk digests (blake2b over the bytes), with byte-identical restores.
The reference's plan is mesh-independent, so its single-device run is the
yardstick.
"""
import pytest

pytest.importorskip("torch")

import ml_dtypes
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro.core import DeltaCR as JDeltaCR
from repro.core.chunk_store import chunk_digest as ref_chunk_digest
from repro.core.policy import DumpPolicy as JDumpPolicy
from repro.dist import shard_dump as jsd
from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.core.chunk_store import ChunkStore
from repro_torch.core.convert import sharded_state_from_numpy
from repro_torch.dist import shard_dump as sd
from repro_torch.dist.placement import NamedSharding, PartitionSpec as P, device_put
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_logical_mesh

torch.set_num_threads(1)

LAYOUTS_PORT = [(1, 1), (4, 2), (2, 4)]


def _mesh(rows, cols):
    return make_logical_mesh((rows, cols), device="cpu")


def _sharding(mesh, *axes):
    return NamedSharding(mesh, P(*axes))


def _cr(restore_fn=None, chunk_bytes=2048, **kw):
    return DeltaCR(policy=DumpPolicy(mode="delta"), chunk_bytes=chunk_bytes,
                   restore_fn=restore_fn, **kw)


def _np(x):
    """Host numpy of a port value (bfloat16 as uint16 words)."""
    from repro_torch.core.convert import tensor_to_numpy

    return tensor_to_numpy(kops.shard_fetch_assemble(x))


# ---------------------------------------------------------------------------
# TilePlan: canonical, mesh-independent, invertible — and the reference's
# ---------------------------------------------------------------------------
SHAPES = st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 24, 64]), min_size=1, max_size=4)


@settings(max_examples=60, deadline=None)
@given(
    shape=SHAPES,
    dtype=st.sampled_from(["float32", "int8", "uint16", "int64", "bfloat16"]),
    chunk_bytes=st.sampled_from([1, 64, 1024, 65536]),
)
def test_tileplan_properties_and_reference_equality(shape, dtype, chunk_bytes):
    shape = tuple(shape)
    plan = sd.TilePlan.for_array(shape, dtype, chunk_bytes)
    assert plan.shape == shape and plan.dtype == dtype
    for s, g in zip(shape, plan.grid):
        assert g >= 1 and (g & (g - 1)) == 0 and g <= sd.MAX_TILES_PER_DIM and s % g == 0
    if any(g > 1 for g in plan.grid):
        assert plan.tile_bytes >= chunk_bytes
    ref_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    assert plan.nbytes == int(np.prod(shape)) * np.dtype(ref_dt).itemsize
    assert plan == sd.TilePlan.for_array(shape, dtype, chunk_bytes)
    want = jsd.TilePlan.for_array(shape, ref_dt, chunk_bytes)
    assert (plan.shape, plan.dtype, plan.grid) == (want.shape, want.dtype, want.grid)
    assert (plan.tile, plan.tile_bytes, plan.n_tiles) == (want.tile, want.tile_bytes, want.n_tiles)
    # a torch dtype names the same plan
    if dtype in ("float32", "int8", "int64", "bfloat16"):
        assert sd.TilePlan.for_array(shape, getattr(torch, dtype), chunk_bytes) == plan


@settings(max_examples=40, deadline=None)
@given(
    shape=st.sampled_from([(64,), (8, 24), (4, 16, 8), (2, 4, 6, 8)]),
    dtype=st.sampled_from(["float32", "int8", "int64", "bfloat16"]),
    chunk_bytes=st.sampled_from([16, 256, 4096]),
    seed=st.integers(0, 2**16),
)
def test_grids_roundtrip_and_equal_the_reference(shape, dtype, chunk_bytes, seed):
    rng = np.random.default_rng(seed)
    ref_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    arr = (rng.standard_normal(shape) * 100).astype(ref_dt)
    plan = sd.TilePlan.for_array(shape, dtype, chunk_bytes)
    host = arr.view(np.uint16) if dtype == "bfloat16" else arr   # numpy words
    grid = sd.array_to_grid(host, plan)
    assert grid.shape == (plan.n_tiles, plan.tile_bytes) and grid.dtype == np.uint8
    want = jsd.array_to_grid(arr, jsd.TilePlan.for_array(shape, ref_dt, chunk_bytes))
    np.testing.assert_array_equal(grid, want)
    back = sd.grid_to_array(grid, plan)
    np.testing.assert_array_equal(_np(back).view(np.uint8), arr.view(np.uint8))
    # a tensor tiles to the same grid
    from repro_torch.core.convert import tensor_from_numpy

    np.testing.assert_array_equal(sd.array_to_grid(tensor_from_numpy(arr), plan), want)


def test_device_grid_matches_host_grid():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((16, 24)).astype(np.float32)
    plan = sd.TilePlan.for_array(arr.shape, arr.dtype, 256)
    view = sd.sharded_view(torch.from_numpy(arr), plan)
    assert [p.tile_ids.tolist() for p in view.parts] == [list(range(plan.n_tiles))]
    np.testing.assert_array_equal(view.parts[0].grid.numpy(), sd.array_to_grid(arr, plan))
    block = sd.device_grid_to_block(view.parts[0].grid, view.parts[0].counts, plan.tile, plan.dtype)
    np.testing.assert_array_equal(block.numpy(), arr)


def test_shard_fetches_move_each_block_once():
    from repro_torch.core.convert import tensor_to_numpy

    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    st = device_put(x, _sharding(_mesh(4, 2), None, "model"))     # 4 replicas a block
    got = kops.shard_fetch(st)
    assert [r for r, _ in got] == [0, 1]                           # one copy of each block
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16 for _, b in got)
    assert torch.equal(torch.cat([b for _, b in got], dim=1), x)
    whole = kops.shard_fetch_assemble(st)
    assert torch.equal(whole, x)
    assert len(kops.start_shard_fetch(st, x)) == 3                 # 2 blocks + the tensor
    f32 = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(kops.shard_fetch_assemble(torch.from_numpy(f32)), f32)
    assert kops.shard_fetch(torch.from_numpy(f32))[0][0] is None
    np.testing.assert_array_equal(tensor_to_numpy(whole), tensor_to_numpy(x))


def test_full_payloads_count_their_gathers():
    """``dump_payload`` (the digest/legacy path) assembles every tensor on
    the host: a partitioned one is a gather and the ledger counts it; a
    replicated one is not partitioned."""
    mesh = _mesh(4, 2)
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    s = sharded_state_from_numpy({"split": x, "repl": x},
                                 {"split": _sharding(mesh, "data", "model"),
                                  "repl": _sharding(mesh)})
    assert sd.is_partitioned(s.get("split")) and not sd.is_partitioned(s.get("repl"))
    sd.reset_fetch_stats()
    out = s.dump_payload()
    np.testing.assert_array_equal(out["split"], x)
    np.testing.assert_array_equal(out["repl"], x)
    snap = sd.fetch_stats()
    assert snap["gathers"] == 1 and snap["gather_bytes"] == x.nbytes


def test_fetch_stats_ledger_keys_by_rank():
    sd.reset_fetch_stats()
    sd.FETCH.note_fetch(4, 100, rows=96)
    sd.FETCH.note_fetch(5, 50)
    sd.FETCH.note_gather(1000)
    snap = sd.fetch_stats()
    assert snap["fetched_bytes"] == 150 and snap["row_bytes"] == 96
    assert snap["by_rank"] == {4: 100, 5: 50} and snap["rows_by_rank"] == {4: 96, 5: 0}
    assert snap["gather_bytes"] == 1000 and snap["gathers"] == 1
    sd.reset_fetch_stats()
    assert sd.fetch_stats()["fetched_bytes"] == 0


# ---------------------------------------------------------------------------
# the block-native diff
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("n_dirty,cap", [(0, 4), (3, 4), (7, 4), (16, 16)])
def test_shard_block_encode_equals_the_grid_path(dtype, n_dirty, cap):
    """Rows, slots and count equal ``delta_encode`` over the two blocks'
    tile grids, overflow included."""
    g = torch.Generator().manual_seed(n_dirty * 31 + cap)
    counts, tile = (4, 2, 2), (3, 4, 8)
    shape = tuple(c * t for c, t in zip(counts, tile))
    old = (torch.randn(shape, generator=g) * 50).to(dtype)
    new = old.clone()
    dirty = torch.randperm(16, generator=g)[:n_dirty]
    for t in dirty.tolist():
        c = np.unravel_index(t, counts)
        idx = tuple(slice(ci * ti, ci * ti + 1) for ci, ti in zip(c, tile))
        new[idx] = new[idx] + 1 if dtype != torch.uint8 else new[idx] ^ 1
    got = kops.shard_block_encode(old, new, counts, tile, cap)
    old_g, new_g = sd.device_tile_grid(old, counts, tile), sd.device_tile_grid(new, counts, tile)
    want = kops.delta_encode(old_g, new_g, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2]) == n_dirty


def test_shard_block_encode_compares_bits():
    old = torch.zeros(8, 4)
    new = old.clone()
    new[5, 0] = -0.0                              # same value, other bits
    data, idx, count = kops.shard_block_encode(old, new, (4, 1), (2, 4), 2)
    assert int(count) == 1 and idx.tolist() == [2, -1]
    nan = torch.full((8, 4), float("nan"))
    assert int(kops.shard_block_encode(nan, nan.clone(), (4, 1), (2, 4), 2)[2]) == 0


# ---------------------------------------------------------------------------
# ShardedTensorState: protocol, dump/restore round trips
# ---------------------------------------------------------------------------
def test_sharded_state_protocol_and_hint():
    rng = np.random.default_rng(1)
    s = sd.ShardedTensorState(
        {"a": torch.from_numpy(rng.standard_normal(1024).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(256).astype(np.float32))}
    )
    assert s.dirty_fraction_hint() is None
    s.reset_dirty_tracking(7)
    assert s.dirty_tracking_base() == 7 and s.dirty_fraction_hint() == 0.0
    s.set("b", s.get("b") + 1)
    assert s.dirty_fraction_hint() == pytest.approx(256 / 1280)
    f = s.fork()
    assert f.dirty_fraction_hint() == pytest.approx(256 / 1280)
    f.invalidate_dirty_tracking()
    assert f.dirty_fraction_hint() is None and s.dirty_fraction_hint() is not None
    with pytest.raises(TypeError):
        s.set("c", np.zeros(4))


def test_writes_after_a_fork_leave_the_fork_unchanged():
    mesh = _mesh(4, 2)
    sh = _sharding(mesh, "data", "model")
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    s = sharded_state_from_numpy({"w": x}, {"w": sh})
    f = s.fork()
    s.set("w", s.get("w").with_box((slice(0, 64), slice(0, 8)), torch.zeros(64, 8)))
    np.testing.assert_array_equal(_np(f.get("w")), x)
    assert not _np(s.get("w")).any()


def test_single_rank_dump_restore_roundtrip():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    tiny = rng.standard_normal(4).astype(np.float32)     # sub-chunk → extras path
    state = sd.ShardedTensorState({"w": torch.from_numpy(w), "tiny": torch.from_numpy(tiny)})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, device="cpu"))
    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[5] += 1.0
        state.set("w", torch.from_numpy(w2))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        img = cr.dump_future(2).result()
        assert img.entries["w"].tile_grid, "multi-chunk tensors dump tiled"
        assert img.shard_parts == 1 and cr.health()["sharded_dumps"] == 2
        got, _how = cr.restore(2)
        np.testing.assert_array_equal(_np(got.get("w")), w2)
        np.testing.assert_array_equal(_np(got.get("tiny")), tiny)
    finally:
        cr.shutdown()


def test_tiled_images_decode_without_base():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    state = sd.ShardedTensorState({"w": torch.from_numpy(w)})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, device="cpu"))
    try:
        cr.checkpoint(state, 1, None)
        cr.wait_dumps()
        meta = cr.dump_future(1).result().entries["w"]
        grid = np.stack([np.frombuffer(cr.store.get(cid), np.uint8) for cid in meta.chunk_ids])
        np.testing.assert_array_equal(sd.grid_to_array(grid, sd.TilePlan.from_meta(meta)), w)
        # a fresh pipeline with no generation decodes from chunks alone
        cr.pipeline.clear()
        cr.evict_template(1)
        got, how = cr.restore(1)
        assert how == "slow"
        np.testing.assert_array_equal(_np(got.get("w")), w)
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# logical meshes: the differential plane
# ---------------------------------------------------------------------------
LAYOUTS = [
    ("fsdp_tp", ("data", "model")),
    ("tp_only", (None, "model")),
    ("fsdp_only", ("data", None)),
    ("replicated", ()),
]


def _dump_digests(arrs, shardings, chunk_bytes=2048, mutate=None):
    """Dump a (possibly sharded) state twice (parent + delta child) and
    return each checkpoint's {key: (tile_grid, digests, n_chunks)}."""
    state = sharded_state_from_numpy(arrs, shardings, device="cpu")
    cr = _cr(chunk_bytes=chunk_bytes)
    try:
        cr.checkpoint(state, 1, None)
        out = {1: {k: (m.tile_grid, m.digests, len(m.chunk_ids))
                   for k, m in cr.dump_future(1).result().entries.items()}}
        if mutate is not None:
            for k, v in mutate.items():
                cur = state.get(k)
                state.set(k, device_put(torch.from_numpy(v), cur.sharding))
            cr.checkpoint(state, 2, 1)
            out[2] = {k: (m.tile_grid, m.digests, len(m.chunk_ids))
                      for k, m in cr.dump_future(2).result().entries.items()}
        return out
    finally:
        cr.shutdown()


@pytest.mark.parametrize("name,axes", LAYOUTS)
def test_sharded_digests_identical_to_single_rank(name, axes):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    v = rng.standard_normal((128,)).astype(np.float32)
    w2 = w.copy()
    w2[7, :16] += 2.0
    mesh = _mesh(4, 2)
    one = _mesh(1, 1)
    ref = _dump_digests({"w": w, "v": v}, {"w": _sharding(one), "v": _sharding(one)},
                        mutate={"w": w2})
    got = _dump_digests(
        {"w": w, "v": v},
        {"w": _sharding(mesh, *axes), "v": _sharding(mesh, axes[0] if axes else None)},
        mutate={"w": w2},
    )
    assert got == ref, f"digest drift under layout {name!r}"


def test_sharded_digests_identical_across_meshes():
    rng = np.random.default_rng(12)
    w = {"w": rng.standard_normal((64, 64)).astype(np.float32)}
    a = _dump_digests(w, {"w": _sharding(_mesh(4, 2), "data", "model")})
    b = _dump_digests(w, {"w": _sharding(_mesh(2, 4), "data", "model")})
    c = _dump_digests(w, {"w": _sharding(make_logical_mesh((8, 1), device="cpu"), "data", None)})
    assert a == b == c


def test_gather_free_dump_bytes_proportional_to_delta():
    """Only the dirty part's compacted rows leave their block; zero
    gathers; every other rank moves only its control words."""
    shard = _sharding(_mesh(4, 2), "data", "model")
    rng = np.random.default_rng(13)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    state = sharded_state_from_numpy({"w": w}, {"w": shard})
    cr = _cr(chunk_bytes=4096)
    try:
        cr.checkpoint(state, 1, None)
        cr.wait_dumps()
        w2 = w.copy()
        w2[0, 0] += 1.0                       # one element → one tile, on rank 0
        state.set("w", state.get("w").with_box((slice(0, 1), slice(0, 1)),
                                                torch.from_numpy(w2[:1, :1])))
        sd.reset_fetch_stats()
        cr.checkpoint(state, 2, 1, priority="sync")
        cr.wait_dumps()
        snap = sd.fetch_stats()
        assert snap["gather_bytes"] == 0 and snap["gathers"] == 0
        plan = sd.TilePlan.from_meta(cr.dump_future(2).result().entries["w"])
        assert snap["row_bytes"] == plan.tile_bytes
        assert snap["rows_by_rank"][0] == plan.tile_bytes
        assert [r for r, b in snap["rows_by_rank"].items() if b] == [0]
        assert sum(snap["by_rank"].values()) == snap["fetched_bytes"]
        assert snap["fetched_bytes"] <= plan.tile_bytes + 64 * 8
    finally:
        cr.shutdown()


def test_misaligned_layout_falls_back_to_counted_gather():
    rng = np.random.default_rng(14)
    w = rng.standard_normal((64, 64)).astype(np.float32)   # 16 KiB: a one-tile plan
    state = sharded_state_from_numpy({"w": w}, {"w": _sharding(_mesh(4, 2), "data", None)})
    cr = _cr(chunk_bytes=w.nbytes)
    try:
        sd.reset_fetch_stats()
        cr.checkpoint(state, 1, None, priority="sync")
        cr.wait_dumps()
        assert sd.fetch_stats()["gathers"] >= 1, "fallback gather must be counted"
        meta = cr.dump_future(1).result().entries["w"]
        grid = np.stack([np.frombuffer(cr.store.get(cid), np.uint8) for cid in meta.chunk_ids])
        np.testing.assert_array_equal(sd.grid_to_array(grid, sd.TilePlan.from_meta(meta)), w)
    finally:
        cr.shutdown()


def test_fork_rollback_interleaving_digest_identity():
    def run(sharding):
        rng = np.random.default_rng(21)
        w = rng.standard_normal((64, 64)).astype(np.float32)
        state = sharded_state_from_numpy({"w": w}, {"w": sharding})
        cr = _cr(restore_fn=lambda p, s=sharding: sd.ShardedTensorState.restore_from_payload(
            p, {"w": s}), chunk_bytes=2048)
        digests = []
        try:
            cr.checkpoint(state, 1, None)
            child = state.fork()
            wa = w.copy()
            wa[3] += 1.0
            child.set("w", device_put(torch.from_numpy(wa), sharding))
            cr.checkpoint(child, 2, 1)
            rolled, _ = cr.restore(1)
            wb = w.copy()
            wb[40, 8:] -= 3.0
            rolled.set("w", device_put(torch.from_numpy(wb), sharding))
            cr.checkpoint(rolled, 3, 1)
            cr.wait_dumps()
            for ck in (1, 2, 3):
                m = cr.dump_future(ck).result().entries["w"]
                digests.append((m.tile_grid, m.digests, tuple(m.shape)))
            np.testing.assert_array_equal(_np(state.get("w")), w)   # the fork's writes stayed
        finally:
            cr.shutdown()
        return digests

    ref = run(_sharding(_mesh(1, 1)))
    assert run(_sharding(_mesh(4, 2), "data", "model")) == ref
    assert run(_sharding(_mesh(2, 4), "data", "model")) == ref


def test_restore_onto_different_mesh():
    sh_a = _sharding(_mesh(4, 2), "data", "model")
    sh_b = _sharding(_mesh(2, 4), "data", "model")
    rng = np.random.default_rng(22)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    state = sharded_state_from_numpy({"w": w}, {"w": sh_a})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh_b}),
             chunk_bytes=512)
    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[10] *= 2.0
        state.set("w", device_put(torch.from_numpy(w2), sh_a))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)                  # force decode, not template fork
        got, how = cr.restore(2)
        assert how == "slow"
        out = got.get("w")
        assert out.sharding is sh_b and len(out.unique_shards()) == 8
        np.testing.assert_array_equal(_np(out), w2)
    finally:
        cr.shutdown()


def test_per_part_slow_restore_through_delta_apply(monkeypatch):
    """The slow restore of a tiled image over a sharded base runs one
    ``delta_apply`` per part with dirty tiles (the plain version on the
    CPU), and its next base is the owned part grids."""
    sh = _sharding(_mesh(4, 2), "data", "model")
    rng = np.random.default_rng(23)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    state = sharded_state_from_numpy({"w": w}, {"w": sh})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh}),
             chunk_bytes=512, async_warm=False)
    calls = []
    real = kops.delta_apply

    def counting(base, rows, idx):
        calls.append(int((idx >= 0).sum()))
        return real(base, rows, idx)

    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[0:2, 0:4] += 1.0                    # rank 0's block only
        w2[60, 60] -= 1.0                      # rank 7's block only
        state.set("w", device_put(torch.from_numpy(w2), sh))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)
        monkeypatch.setattr(kops, "delta_apply", counting)
        got, how = cr.restore(2)
        assert how == "slow" and len(calls) == 2 and sum(calls) == 2
        np.testing.assert_array_equal(_np(got.get("w")), w2)
        rec = cr.pipeline.record_for(2)
        try:
            view = rec.views["w"]
            assert all(p.owns_grid for p in view.parts) and len(view.parts) == 8
        finally:
            cr.pipeline.release_record(rec)
        # the next dump diffs against those owned grids (the kernel plans)
        w3 = w2.copy()
        w3[33, 1] = 5.0
        got.set("w", device_put(torch.from_numpy(w3), sh))
        kernel_before = cr.stats.kernel_keys
        cr.checkpoint(got, 3, 2)
        cr.wait_dumps()
        assert cr.stats.kernel_keys == kernel_before + 1
        assert cr.dump_future(3).result().dirtied_chunks == 1
    finally:
        cr.shutdown()


@pytest.mark.parametrize("broken", ["device_grid_to_block", "assemble_from_parts"])
def test_per_part_decode_errors_raise(monkeypatch, broken):
    """An error on the per-part route of a tiled decode raises from the
    restore; nothing moves the decode to the host tile path."""
    sh = _sharding(_mesh(4, 2), "data", "model")
    rng = np.random.default_rng(25)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    state = sharded_state_from_numpy({"w": w}, {"w": sh})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh}),
             chunk_bytes=512, async_warm=False)
    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[3, 3] += 1.0
        state.set("w", device_put(torch.from_numpy(w2), sh))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)
        host_route = []

        def fail(*_a, **_k):
            raise RuntimeError(f"{broken} failed")

        monkeypatch.setattr(sd, broken, fail)
        monkeypatch.setattr(sd, "grid_to_array", lambda *a: host_route.append(a))
        with pytest.raises(RuntimeError, match=f"{broken} failed"):
            cr.restore(2)
        assert not host_route, "the decode fell back to the host tile path"
    finally:
        cr.shutdown()


def test_plain_tensor_decodes_per_part(monkeypatch):
    """A plain tensor's view is one part on its device: its slow restore
    scatters the dirty tiles there with ``delta_apply`` and returns a
    tensor, and the owned part grid is the next base."""
    rng = np.random.default_rng(26)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    state = sd.ShardedTensorState({"w": torch.from_numpy(w)})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, device="cpu"),
             chunk_bytes=512, async_warm=False)
    calls = []
    real = kops.delta_apply

    def counting(base, rows, idx):
        calls.append(int((idx >= 0).sum()))
        return real(base, rows, idx)

    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[5, :4] += 1.0
        state.set("w", torch.from_numpy(w2))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)
        monkeypatch.setattr(kops, "delta_apply", counting)
        monkeypatch.setattr(sd, "grid_to_array", lambda *a: pytest.fail("host tile path"))
        got, how = cr.restore(2)
        assert how == "slow" and calls == [1]
        out = got.get("w")
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        np.testing.assert_array_equal(_np(out), w2)
        rec = cr.pipeline.record_for(2)
        try:
            (part,) = rec.views["w"].parts
            assert part.owns_grid and rec.views["w"].sharding is None
        finally:
            cr.pipeline.release_record(rec)
    finally:
        cr.shutdown()


def test_misaligned_layout_restores_through_the_host_tile_path(monkeypatch):
    """A layout whose blocks do not nest into the plan is one gather part
    with no device: its restore inverts the tile layout on the host (no
    ``delta_apply``) and is byte-identical."""
    sh = _sharding(_mesh(4, 2), "data", None)
    rng = np.random.default_rng(27)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    plan = sd.TilePlan.for_array(w.shape, w.dtype, 8192)
    assert plan.n_tiles == 2 and 16 % plan.tile[0], "blocks of 16 rows must not nest"
    state = sharded_state_from_numpy({"w": w}, {"w": sh})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh}),
             chunk_bytes=8192, async_warm=False)
    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[40, 1] = 7.0
        state.set("w", device_put(torch.from_numpy(w2), sh))
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)
        monkeypatch.setattr(kops, "delta_apply", lambda *a: pytest.fail("delta_apply launched"))
        got, how = cr.restore(2)
        assert how == "slow"
        np.testing.assert_array_equal(_np(got.get("w")), w2)
    finally:
        cr.shutdown()


def test_heal_a_corrupt_chunk_from_a_sharded_anchor():
    """A verified read that finds a flipped bit repairs it with one row
    fetched from the part that owns it in the anchored ShardedView."""
    sh = _sharding(_mesh(4, 2), "data", "model")
    rng = np.random.default_rng(24)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    store = ChunkStore(chunk_bytes=512, verify_reads=True)
    state = sharded_state_from_numpy({"w": w}, {"w": sh})
    cr = DeltaCR(store=store, policy=DumpPolicy(mode="delta"), chunk_bytes=512,
                 restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh}))
    try:
        cr.checkpoint(state, 1, None)
        cr.wait_dumps()
        meta = cr.dump_future(1).result().entries["w"]
        cid = meta.chunk_ids[13]
        want = store.get(cid)
        store.corrupt_chunk_for_test(cid)
        sd.reset_fetch_stats()
        assert store.get(cid) == want
        h = cr.health()
        assert h["chunk_repairs"] == 1 and h["shards"]["row_bytes"] == len(want)
        assert h["sharded_dumps"] == 1 and h["shard_parts"] == 8
        assert [r for r, b in h["shards"]["rows_by_rank"].items() if b] != []
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# differential: one chain on the reference and on the port's layouts
# ---------------------------------------------------------------------------
CHAIN_CHUNK = 512


def _chain_arrays(rng):
    return {
        "w": rng.standard_normal((64, 96)).astype(np.float32),
        "kv": rng.standard_normal((128, 8, 16)).astype(ml_dtypes.bfloat16),
        "heap": rng.standard_normal(4096).astype(np.float32),
        "v": rng.standard_normal(64).astype(np.float32),        # sub-chunk: extras
    }


def _chain_writes(rng, arrs):
    """Two turns of writes, then a divergent turn after a rollback."""
    a = {k: v.copy() for k, v in arrs.items()}
    a["w"][3:5, 10:40] += 1.0
    a["kv"][40:48] = rng.standard_normal((8, 8, 16)).astype(ml_dtypes.bfloat16)
    a["heap"][rng.choice(4096, 9, replace=False)] = 7.0
    b = {k: v.copy() for k, v in a.items()}
    b["kv"][48:56, :4] = rng.standard_normal((8, 4, 16)).astype(ml_dtypes.bfloat16)
    b["v"][0] = -1.0
    c = {k: v.copy() for k, v in arrs.items()}
    c["w"][60] = 0.0
    c["heap"][:100] = 3.0
    return a, b, c


def _entries(cr, ck):
    return {k: (tuple(m.tile_grid), m.digests, tuple(m.shape), m.dtype)
            for k, m in cr.dump_future(ck).result().entries.items()}


def _run_reference(arrs, turns):
    def put(arrays):
        return {k: jnp.asarray(v) for k, v in arrays.items()}

    state = jsd.ShardedArrayState(put(arrs))
    cr = JDeltaCR(policy=JDumpPolicy(mode="delta"), chunk_bytes=CHAIN_CHUNK,
                  restore_fn=lambda p: jsd.ShardedArrayState.restore_from_payload(p))
    a, b, c = turns
    try:
        cr.checkpoint(state, 1, None)
        for k in arrs:
            state.set(k, jnp.asarray(a[k]))
        cr.checkpoint(state, 2, 1)
        for k in ("kv", "v"):
            state.set(k, jnp.asarray(b[k]))
        cr.checkpoint(state, 3, 2)
        rolled, _ = cr.restore(1)
        for k in arrs:
            rolled.set(k, jnp.asarray(c[k]))
        cr.checkpoint(rolled, 4, 1)
        cr.wait_dumps()
        out = {ck: _entries(cr, ck) for ck in (1, 2, 3, 4)}
        restored = {}
        for ck in (3, 4, 2):
            cr.evict_template(ck)
            got, _how = cr.restore(ck)
            restored[ck] = {k: np.asarray(jax.device_get(got.get(k))).view(np.uint8)
                            for k in arrs}
        return out, restored
    finally:
        cr.shutdown()


def _port_shardings(shape):
    mesh = _mesh(*shape)
    return {
        "w": _sharding(mesh, "data", "model"),
        "kv": _sharding(mesh, "data", "model", None),
        "heap": _sharding(mesh, "model"),
    }


def _run_port(arrs, turns, shape):
    shardings = _port_shardings(shape)
    state = sharded_state_from_numpy(arrs, shardings, device="cpu")
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(
        p, shardings, device="cpu"), chunk_bytes=CHAIN_CHUNK)
    from repro_torch.core.convert import tensor_from_numpy

    def write(st, arrays, keys):
        for k in keys:
            t = tensor_from_numpy(arrays[k])
            cur = st.get(k)
            st.set(k, device_put(t, cur.sharding) if k in shardings else t)

    a, b, c = turns
    try:
        sd.reset_fetch_stats()
        cr.checkpoint(state, 1, None)
        write(state, a, arrs)
        cr.checkpoint(state, 2, 1)
        write(state, b, ("kv", "v"))
        cr.checkpoint(state, 3, 2)
        rolled, _ = cr.restore(1)
        write(rolled, c, arrs)
        cr.checkpoint(rolled, 4, 1)
        cr.wait_dumps()
        assert sd.fetch_stats()["gather_bytes"] == 0, "aligned layouts never gather"
        out = {ck: _entries(cr, ck) for ck in (1, 2, 3, 4)}
        restored = {}
        for ck in (3, 4, 2):
            cr.evict_template(ck)
            got, how = cr.restore(ck)
            assert how == "slow"
            restored[ck] = {k: _np(got.get(k)).view(np.uint8) for k in arrs}
        return out, restored
    finally:
        cr.shutdown()


@pytest.fixture(scope="module")
def reference_chain():
    rng = np.random.default_rng(31)
    arrs = _chain_arrays(rng)
    turns = _chain_writes(rng, arrs)
    return arrs, turns, _run_reference(arrs, turns)


@pytest.mark.parametrize("shape", LAYOUTS_PORT, ids=lambda s: f"{s[0]}x{s[1]}")
def test_chain_equals_the_reference_under_every_layout(reference_chain, shape):
    arrs, turns, (want, want_restored) = reference_chain
    got, restored = _run_port(arrs, turns, shape)
    for ck in want:
        assert got[ck] == want[ck], f"checkpoint {ck} differs under {shape}"
        for k in ("w", "kv", "heap"):
            assert got[ck][k][0], f"{k} dumps tiled"
    for ck, tensors in want_restored.items():
        for k, raw in tensors.items():
            np.testing.assert_array_equal(restored[ck][k], raw.reshape(-1).view(np.uint8)
                                          .reshape(restored[ck][k].shape))


# ---------------------------------------------------------------------------
# the sharded KV pool
# ---------------------------------------------------------------------------
def test_sharded_kv_pool_dump_gather_free_and_digests_equal_the_reference():
    from repro_torch.configs import get_config
    from repro_torch.core.convert import tensor_to_numpy
    from repro_torch.serve.kvcache import PagePool, PagedSession

    cfg = get_config("qwen3-14b")              # 8 KV heads: a clean 2-way TP split
    mesh = _mesh(4, 2)
    pool = PagePool(cfg, num_pages=8, page_size=4, max_pages_per_session=4, device="cpu",
                    sharding=_sharding(mesh, None, None, None, "model", None))
    assert pool.multi_device()
    assert tuple(pool.grid_sharding().spec) == (None, None, None, "model", None)
    g = torch.Generator().manual_seed(5)
    for s, t in pool.attn_tags:
        for pools in (pool.pools_k, pool.pools_v):
            pools[s][t].copy_(torch.randn(pools[s][t].shape, generator=g).to(torch.bfloat16))
    sess = PagedSession(pool)
    sess.seq_len = 8                           # 2 pages
    sess.table[0] = pool.alloc()
    sess.table[1] = pool.alloc()
    sess.reset_dirty_tracking(0)
    gen = sess.delta_generation(4096)
    kv_keys = [k for k in gen.views if k.startswith("kv/")]
    assert kv_keys and all(hasattr(gen.views[k], "parts") for k in kv_keys)
    cr = _cr(chunk_bytes=4096, restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    try:
        sd.reset_fetch_stats()
        cr.checkpoint(sess, 1, None, priority="sync")
        cr.wait_dumps()
        assert sd.fetch_stats()["gather_bytes"] == 0
        img = cr.dump_future(1).result()
        pages = torch.as_tensor(sess.active_pages().astype(np.int64))
        for k in kv_keys:
            meta = img.entries[k]
            assert meta.tile_grid
            _, skey, tag, which = k.split("/")
            pools = pool.pools_k if which == "k" else pool.pools_v
            grid = pools[skey][tag].index_select(1, pages).movedim(1, 0).contiguous()
            words = tensor_to_numpy(grid).view(ml_dtypes.bfloat16)
            plan = jsd.TilePlan.for_array(words.shape, words.dtype, 4096)
            assert tuple(meta.tile_grid) == plan.grid
            rows = jsd.array_to_grid(words, plan)
            assert meta.digests == tuple(ref_chunk_digest(r.tobytes(), 0) for r in rows)
        # the tiled session image restores into fresh pages, byte for byte
        cr.evict_template(1)
        got, how = cr.restore(1)
        assert how == "slow"
        for s, t in pool.attn_tags:
            for pools in (pool.pools_k, pool.pools_v):
                assert torch.equal(pools[s][t][:, got.active_pages()],
                                   pools[s][t][:, sess.active_pages()])
        got.release()
    finally:
        cr.shutdown()
        sess.release()


@pytest.mark.gpu
def test_shard_block_encode_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(3)
    old = torch.randn((64, 8, 32), generator=g).to(torch.bfloat16)
    new = old.clone()
    new[5:9, 2] += 1
    want = kops.shard_block_encode(old, new, (4, 8, 2), (16, 1, 16), 8)
    got = kops.shard_block_encode(old.cuda(), new.cuda(), (4, 8, 2), (16, 1, 16), 8)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_stream_stats_count_the_shard_items():
    from repro_torch.core.stream import ChunkStreamEngine, StreamConfig, WindowItem

    eng = ChunkStreamEngine(StreamConfig(window_bytes=2048, min_windows=2))
    items = [
        WindowItem(key=key, weight=1024, encode=lambda: None, drain=lambda e: e,
                   commit=lambda d: d)
        for key in ("w#shard0", "w#shard1", "w#shard2", "flat")
    ]
    out = {}
    try:
        stats = eng.stream(items, out)
    finally:
        eng.shutdown()
    assert stats.items == 4 and stats.shard_items == 3 and sorted(out) == sorted(
        it.key for it in items)


@pytest.mark.gpu
def test_sharded_chain_on_the_card_launches_per_part():
    """On a (4, 2) logical mesh on the card: a slow restore launches one
    ``delta_apply`` per part with dirty tiles, the dump after it one
    ``delta_fused`` per part, and every restore is byte-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = make_logical_mesh((4, 2))
    sh = _sharding(mesh, "data", "model")
    rng = np.random.default_rng(41)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    state = sharded_state_from_numpy({"w": w}, {"w": sh})
    cr = _cr(restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(p, {"w": sh}),
             chunk_bytes=512, async_warm=False)
    try:
        cr.checkpoint(state, 1, None)
        w2 = w.copy()
        w2[0:2, 0:4] += 1.0                    # rank 0's block
        w2[60, 60] -= 1.0                      # rank 7's block
        state.set("w", device_put(torch.from_numpy(w2), sh))
        sd.reset_fetch_stats()
        cr.checkpoint(state, 2, 1)
        cr.wait_dumps()
        snap = sd.fetch_stats()
        assert snap["gather_bytes"] == 0 and snap["rows_by_rank"][0] > 0
        cr.evict_template(2)
        kops.reset_launch_counts()
        got, how = cr.restore(2)
        torch.cuda.synchronize()
        assert how == "slow" and kops.launch_counts()["delta_apply"] == 2
        np.testing.assert_array_equal(_np(got.get("w")), w2)
        w3 = w2.copy()
        w3[33, 1] = 5.0
        got.set("w", device_put(torch.from_numpy(w3), sh))
        kops.reset_launch_counts()
        cr.checkpoint(got, 3, 2)
        cr.wait_dumps()
        torch.cuda.synchronize()
        assert kops.launch_counts()["delta_fused"] == 8
        assert cr.dump_future(3).result().dirtied_chunks == 1
    finally:
        cr.shutdown()
