"""Tiled (shard-native) images across the two packages' persistence planes.

A root saved by the JAX package's ``save_state`` from a ``ShardedArrayState``
chain is recovered by the port's ``recover`` and restored onto a (4, 2)
logical mesh; a root saved by the port from a ``ShardedTensorState`` on a
(4, 2) mesh is recovered by the reference.  Each restore is compared byte
for byte with the state that was checkpointed, and the recovered images'
tile grids and chunk digests with the writer's.  The port recovers onto
the CPU here (``device="cpu"``: its generation anchors stay numpy grids);
``test_recovered_anchor_on_a_device_grid`` drives the other branch, a tile
grid rebuilt as a tensor, as ``recover`` builds it on the card.
"""
import pytest

pytest.importorskip("torch")

import ml_dtypes
import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.core as J
import repro.core.persist as JP
import repro_torch.core as T
import repro_torch.core.persist as TP
from repro.dist import shard_dump as jsd
from repro_torch.core.convert import sharded_state_from_numpy, tensor_from_numpy, tensor_to_numpy
from repro_torch.dist import shard_dump as sd
from repro_torch.dist.placement import NamedSharding, PartitionSpec as P, device_put
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_logical_mesh

torch.set_num_threads(1)

CHUNK = 512


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 96)).astype(np.float32),
        "kv": rng.standard_normal((128, 8, 16)).astype(ml_dtypes.bfloat16),
        "heap": rng.standard_normal(4096).astype(np.float32),
    }


def _turn(arrs, k):
    out = {key: v.copy() for key, v in arrs.items()}
    out["w"][k : k + 2] += 1.0
    out["kv"][8 * k : 8 * k + 8, :2] = ml_dtypes.bfloat16(k)
    out["heap"][100 * k] = -float(k)
    return out


def _shardings():
    mesh = make_logical_mesh((4, 2), device="cpu")
    return {
        "w": NamedSharding(mesh, P("data", "model")),
        "kv": NamedSharding(mesh, P("data", "model", None)),
        "heap": NamedSharding(mesh, P("model")),
    }


def _bytes(x):
    if isinstance(x, np.ndarray):
        return x.reshape(-1).view(np.uint8)
    if hasattr(x, "addressable_shards") and not isinstance(x, jax.Array):
        x = kops.shard_fetch_assemble(x)
    if isinstance(x, jax.Array):
        return np.asarray(jax.device_get(x)).reshape(-1).view(np.uint8)
    return tensor_to_numpy(x).reshape(-1).view(np.uint8)


def _entries(cr, ck):
    """Each entry's tile grid and chunk digests, once the dump has landed."""
    return {k: (tuple(m.tile_grid), m.digests)
            for k, m in cr.dump_future(ck).result().entries.items()}


def test_reference_root_recovers_in_the_port(tmp_path):
    states = [_arrays(1)]
    states += [_turn(states[-1], k) for k in (1, 2)]
    cr = J.DeltaCR(policy=J.DumpPolicy(mode="delta"), chunk_bytes=CHUNK,
                   restore_fn=lambda p: jsd.ShardedArrayState.restore_from_payload(p))
    st = jsd.ShardedArrayState({k: jnp.asarray(v) for k, v in states[0].items()})
    cr.checkpoint(st, 1, None)
    for ck, arrs in ((2, states[1]), (3, states[2])):
        for k, v in arrs.items():
            st.set(k, jnp.asarray(v))
        cr.checkpoint(st, ck, ck - 1)
    cr.wait_dumps()
    want = {ck: _entries(cr, ck) for ck in (1, 2, 3)}
    assert all(g for e in want.values() for g, _ in e.values())
    root = str(tmp_path / "ref")
    JP.save_state(root, deltacr=cr)
    cr.shutdown()

    shardings = _shardings()
    rec = TP.recover(root, device="cpu", auto_restore=False,
                     restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(
                         p, shardings, device="cpu"))
    try:
        pcr = rec.deltacr
        for ck in (1, 2, 3):
            assert _entries(pcr, ck) == want[ck]
        for ck in (3, 1, 2):
            state, how = pcr.restore(ck)
            assert how == "slow"
            for k, v in states[ck - 1].items():
                assert state.get(k).sharding is shardings[k]
                np.testing.assert_array_equal(_bytes(state.get(k)), _bytes(v))
    finally:
        rec.deltacr.shutdown()


def test_port_root_recovers_in_the_reference(tmp_path):
    shardings = _shardings()
    states = [_arrays(2)]
    states += [_turn(states[-1], k) for k in (1, 2)]
    cr = T.DeltaCR(policy=T.DumpPolicy(mode="delta"), chunk_bytes=CHUNK,
                   restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(
                       p, shardings, device="cpu"))
    st = sharded_state_from_numpy(states[0], shardings)
    cr.checkpoint(st, 1, None)
    for ck, arrs in ((2, states[1]), (3, states[2])):
        for k, v in arrs.items():
            st.set(k, device_put(tensor_from_numpy(v), shardings[k]))
        cr.checkpoint(st, ck, ck - 1)
    cr.wait_dumps()
    want = {ck: _entries(cr, ck) for ck in (1, 2, 3)}
    root = str(tmp_path / "port")
    TP.save_state(root, deltacr=cr)
    cr.shutdown()

    rec = JP.recover(root, auto_restore=False,
                     restore_fn=lambda p: jsd.ShardedArrayState.restore_from_payload(p))
    try:
        rcr = rec.deltacr
        for ck in (1, 2, 3):
            assert _entries(rcr, ck) == want[ck]
        for ck in (2, 3, 1):
            state, _how = rcr.restore(ck)
            for k, v in states[ck - 1].items():
                np.testing.assert_array_equal(_bytes(state.get(k)), _bytes(v))
    finally:
        rec.deltacr.shutdown()


def test_recovered_anchor_on_a_device_grid(tmp_path):
    """A tile grid rebuilt as a tensor (what ``recover`` uploads on the
    card) takes the image's dirty tiles with ``delta_apply`` on a restore,
    and is the per-part base of the next dump."""
    shardings = _shardings()
    states = [_arrays(3), None]
    states[1] = _turn(states[0], 1)
    cr = T.DeltaCR(policy=T.DumpPolicy(mode="delta"), chunk_bytes=CHUNK)
    st = sharded_state_from_numpy(states[0], shardings)
    cr.checkpoint(st, 1, None)
    for k, v in states[1].items():
        st.set(k, device_put(tensor_from_numpy(v), shardings[k]))
    cr.checkpoint(st, 2, 1)
    cr.wait_dumps()
    root = str(tmp_path / "port")
    TP.save_state(root, deltacr=cr)
    cr.shutdown()

    rec = TP.recover(root, device="cpu", auto_restore=False,
                     restore_fn=lambda p: sd.ShardedTensorState.restore_from_payload(
                         p, shardings, device="cpu"))
    pcr = rec.deltacr
    try:
        # the rebuilt anchors as tensors: the card's representation
        for image_id in pcr.pipeline.anchored_ids():
            img = pcr.dump_future(image_id).result()
            pcr.pipeline.rebuild_generation(img, device="cpu")
            rec_ = pcr.pipeline.record_for(image_id)
            try:
                for view in rec_.views.values():
                    g = view.grid
                    view._grid = torch.from_numpy(g) if isinstance(g, np.ndarray) else g
            finally:
                pcr.pipeline.release_record(rec_)
        applied = []
        real = kops.delta_apply

        def counting(base, rows, idx):
            applied.append(int((idx >= 0).sum()))
            return real(base, rows, idx)

        kops.delta_apply = counting
        try:
            state, how = pcr.restore(2)
        finally:
            kops.delta_apply = real
        assert how == "slow" and applied
        for k, v in states[1].items():
            np.testing.assert_array_equal(_bytes(state.get(k)), _bytes(v))
        nxt = _turn(states[1], 3)
        for k, v in nxt.items():
            state.set(k, device_put(tensor_from_numpy(v), shardings[k]))
        encodes = []
        real_fused = kops.fused_encode

        def counting_fused(old, new, cap):
            encodes.append(old.shape)
            return real_fused(old, new, cap)

        kops.fused_encode = counting_fused
        try:
            pcr.checkpoint(state, 5, 2)
            pcr.wait_dumps()
        finally:
            kops.fused_encode = real_fused
        img = pcr.dump_future(5).result()
        # every part diffs its rows of the rebuilt grid (none drains as new)
        assert img.mode == "delta" and img.shard_parts == 8 + 8 + 2
        assert len(encodes) == img.shard_parts
        for k, v in nxt.items():
            meta = img.entries[k]
            plan = sd.TilePlan.from_meta(meta)
            rows = sd.array_to_grid(v.view(np.uint16) if k == "kv" else v, plan)
            assert [bytes(pcr.store.get(c)) for c in meta.chunk_ids] == [r.tobytes() for r in rows]
    finally:
        pcr.shutdown()
