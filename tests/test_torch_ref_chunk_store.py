"""ChunkStore: refcounting, dedupe, accounting invariants."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.chunk_store import ChunkStore


def test_put_get_roundtrip():
    cs = ChunkStore(chunk_bytes=16)
    cid = cs.put(b"hello world")
    assert cs.get(cid) == b"hello world"
    assert cs.refs(cid) == 1


def test_dedupe_hits():
    cs = ChunkStore(chunk_bytes=16, dedupe=True)
    a = cs.put(b"same-bytes")
    b = cs.put(b"same-bytes")
    assert a == b
    assert cs.refs(a) == 2
    assert cs.stats.dedup_hits == 1
    assert cs.stats.physical_bytes == len(b"same-bytes")


def test_no_dedupe_when_disabled():
    cs = ChunkStore(chunk_bytes=16, dedupe=False)
    a = cs.put(b"same-bytes")
    b = cs.put(b"same-bytes")
    assert a != b
    assert cs.stats.physical_bytes == 2 * len(b"same-bytes")


def test_decref_frees():
    cs = ChunkStore(chunk_bytes=16)
    cid = cs.put(b"x" * 10)
    cs.incref(cid)
    cs.decref(cid)
    assert cid in cs
    cs.decref(cid)
    assert cid not in cs
    assert cs.stats.physical_bytes == 0
    assert cs.stats.chunks_alive == 0


def test_decref_underflow_raises():
    cs = ChunkStore()
    cid = cs.put(b"x")
    cs.decref(cid)
    with pytest.raises(Exception):
        cs.decref(cid)


def test_array_roundtrip():
    cs = ChunkStore(chunk_bytes=64)
    arr = np.arange(1000, dtype=np.int64)
    ids = cs.put_array(arr)
    out = cs.get_array(ids, arr.shape, arr.dtype)
    np.testing.assert_array_equal(arr, out)
    assert len(ids) == -(-arr.nbytes // 64)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.binary(min_size=1, max_size=64), min_size=1, max_size=40))
def test_accounting_invariant(blobs):
    """physical_bytes == sum of live unique chunks; logical tracks refs."""
    cs = ChunkStore(chunk_bytes=32, dedupe=True)
    ids = [cs.put(b) for b in blobs]
    live = {}
    for cid in ids:
        live[cid] = live.get(cid, 0) + 1
    expected_physical = sum(len(cs.get(cid)) for cid in set(ids))
    assert cs.stats.physical_bytes == expected_physical
    # drop all references; store must empty
    for cid in ids:
        cs.decref(cid)
    assert cs.stats.physical_bytes == 0
    assert len(cs) == 0
