"""The port's host plane (ChunkStore, digest encode, DeltaFS) against the
JAX package's: the same payloads give the same chunk digests, pads and
resolved bytes across write / checkpoint / rollback."""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import chunk_store as j_cs
from repro.core import deltafs as j_fs
from repro_torch.core import chunk_store as t_cs
from repro_torch.core import deltafs as t_fs
from repro_torch.core.convert import tensor_from_numpy

torch.set_num_threads(1)


def _digests(store, ids):
    return [(store.digest_of(cid), store.pad_of(cid), store.get(cid)) for cid in ids]


def _meta_view(store, meta):
    """A TensorMeta minus its store-local chunk ids."""
    return (meta.shape, meta.dtype, meta.digests, meta.trailing_pad, _digests(store, meta.chunk_ids))


@pytest.mark.parametrize("n_bytes,chunk", [(100, 64), (4096, 1024), (1, 64), (1000, 7)])
def test_put_bytes_digests_and_pads_match(n_bytes, chunk):
    raw = np.random.default_rng(n_bytes).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    js, ts = j_cs.ChunkStore(chunk_bytes=chunk), t_cs.ChunkStore(chunk_bytes=chunk)
    jids, tids = js.put_bytes(raw), ts.put_bytes(raw)
    assert _digests(js, jids) == _digests(ts, tids)
    assert ts.get_bytes(tids) == js.get_bytes(jids) == raw
    assert list(t_cs.iter_chunk_views(raw, chunk)) == list(j_cs.iter_chunk_views(raw, chunk))


@pytest.mark.parametrize("dtype", ["float32", "int64", "int8", "bfloat16", "bool"])
def test_digest_encode_array_matches(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(333) * 50).astype(np.float32)
    a = np.asarray(jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" else x.astype(dtype)
    b = a.copy()
    b[200:210] = b[0]
    js, ts = j_cs.ChunkStore(chunk_bytes=128), t_cs.ChunkStore(chunk_bytes=128)
    jm1, jd1 = j_fs.digest_encode_array(js, a, None)
    tm1, td1 = t_fs.digest_encode_array(ts, tensor_from_numpy(a), None)
    jm2, jd2 = j_fs.digest_encode_array(js, b, jm1)
    tm2, td2 = t_fs.digest_encode_array(ts, tensor_from_numpy(b), tm1)
    assert (jd1, jd2) == (td1, td2)
    assert _meta_view(js, jm1) == _meta_view(ts, tm1)
    assert _meta_view(js, jm2) == _meta_view(ts, tm2)
    assert tm1.dtype == dtype and tm1.nbytes == jm1.nbytes
    # a numpy array of a numpy dtype encodes like the tensor of its bits
    if dtype != "bfloat16":
        tm3, _ = t_fs.digest_encode_array(ts, b, tm2)
        assert _meta_view(ts, tm3) == _meta_view(ts, tm2)
    got = t_fs.read_meta_array(ts, tm2)
    want = np.asarray(b)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(got, want)


def test_dtype_names_match_the_reference():
    for td, nd in [
        (torch.float32, np.float32), (torch.int64, np.int64), (torch.uint8, np.uint8),
        (torch.bool, np.bool_), (torch.float16, np.float16), (torch.bfloat16, jnp.bfloat16),
    ]:
        assert t_fs.dtype_str(td) == str(np.dtype(nd))
        assert t_fs.dtype_itemsize(t_fs.dtype_str(td)) == np.dtype(nd).itemsize


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**16))
def test_deltafs_write_checkpoint_rollback_match(seed):
    """A seeded chain of writes, deletes, checkpoints and rollbacks through
    both DeltaFS implementations: same keys, bytes and chunk digests."""
    rng = np.random.default_rng(seed)
    jfs, tfs = j_fs.DeltaFS(chunk_bytes=256), t_fs.DeltaFS(chunk_bytes=256)
    configs = []
    for step in range(30):
        op = rng.choice(["write", "write", "write", "delete", "checkpoint", "rollback"])
        key = f"f{int(rng.integers(6))}"
        if op == "write":
            arr = rng.integers(0, 1000, int(rng.integers(1, 400)), dtype=np.int32)
            if rng.random() < 0.5 and jfs.exists(key):
                arr = np.array(jfs.read(key), copy=True)
                arr[int(rng.integers(arr.size))] += 1
            assert jfs.write(key, arr) == tfs.write(key, arr)
        elif op == "delete" and jfs.exists(key):
            jfs.delete(key)
            tfs.delete(key)
        elif op == "checkpoint":
            configs.append((jfs.checkpoint(), tfs.checkpoint()))
        elif op == "rollback" and configs:
            jc, tc = configs[int(rng.integers(len(configs)))]
            jfs.switch(jc)
            tfs.switch(tc)
        assert jfs.keys() == tfs.keys()
        for k in jfs.keys():
            np.testing.assert_array_equal(jfs.read(k), tfs.read(k))
            assert _meta_view(jfs.store, jfs.read_meta(k)) == _meta_view(tfs.store, tfs.read_meta(k))
    assert jfs.store.stats.physical_bytes == tfs.store.stats.physical_bytes
