"""Tiered chunk storage: hot/warm/cold demotion + promotion, LRU victim
selection, byte accounting, digest-verified promotion with repair-source
healing on corrupt tier payloads, and cross-sandbox digest dedupe."""
import pytest

pytest.importorskip("torch")

import os

import numpy as np

from repro_torch.core import (
    ChunkCorruptionError,
    ChunkStore,
    ColdBackend,
    DirObjectClient,
    WarmBackend,
    make_local_tiers,
    tier_key,
)


def _tiers(tmp_path, hot=1 << 10, warm=1 << 20):
    return make_local_tiers(
        str(tmp_path / "tiers"), hot_capacity_bytes=hot, warm_capacity_bytes=warm
    )


def _payload(i, n=256):
    rng = np.random.default_rng(i)
    return rng.integers(0, 255, n).astype(np.uint8).tobytes()


# ---------------------------------------------------------------- backends
def test_warm_backend_roundtrip_and_dead_segment_reclaim(tmp_path):
    warm = WarmBackend(str(tmp_path / "warm"), segment_bytes=512)
    keys = []
    for i in range(8):
        key = f"k{i}"
        warm.put(key, _payload(i))
        keys.append(key)
    for i, key in enumerate(keys):
        assert warm.get(key) == _payload(i)
    used_before = warm.bytes_used()
    assert used_before > 0
    # deleting everything must reclaim the segment files, not just account
    for key in keys:
        warm.delete(key)
    assert warm.bytes_used() == 0
    segs = [f for f in os.listdir(str(tmp_path / "warm")) if f.startswith("seg-")]
    # at most the current (still-open) segment may remain
    assert len(segs) <= 1


def test_cold_backend_object_store_shape(tmp_path):
    cold = ColdBackend(DirObjectClient(str(tmp_path / "cold")))
    cold.put("aabbcc-0", b"x" * 100)
    assert "aabbcc-0" in cold
    assert cold.get("aabbcc-0") == b"x" * 100
    assert cold.bytes_used() == 100
    cold.delete("aabbcc-0")
    assert cold.get("aabbcc-0") is None
    assert cold.bytes_used() == 0


# ---------------------------------------------------- demotion / promotion
def test_capacity_pressure_demotes_lru_and_promotes_on_read(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path, hot=600))
    data = [_payload(i) for i in range(4)]
    cids = [store.put(d) for d in data]
    # 4*256 > 600: the oldest chunks must have spilled to warm
    tiers = {cid: store.tier_of(cid) for cid in cids}
    assert any(t == "warm" for t in tiers.values())
    assert store.tier_bytes()["hot"] <= 600
    # reads still return exact bytes (promotion is digest-verified)
    for cid, d in zip(cids, data):
        assert store.get(cid) == d
    assert store.tiers.stats.promotions >= 1


def test_explicit_demote_and_get_bytes_routes_through_promotion(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path))
    raw = _payload(7, 700)                      # 3 chunks, last one padded
    ids = store.put_bytes(raw)
    for cid in ids:
        assert store.demote(cid)
        assert store.tier_of(cid) == "warm"
    assert store.get_bytes(ids) == raw          # fast path faults them back
    assert all(store.tier_of(cid) == "hot" for cid in ids)


def test_demote_to_cold_and_dead_chunk_evicts_tier_copy(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path))
    cid = store.put(_payload(1))
    assert store.demote(cid, tier="cold")
    assert store.tier_of(cid) == "cold"
    assert store.tier_bytes()["cold"] > 0
    store.decref(cid)                           # last ref: chunk dies
    assert cid not in store
    # the demoted copy must not leak in the tier
    assert store.tier_bytes().get("cold", 0) == 0


def test_lru_prefers_recent_and_shared_chunks(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path, hot=10 << 10))
    cold_cid = store.put(_payload(10))
    hot_cid = store.put(_payload(11))
    store.incref(hot_cid)                       # widely shared
    store.get(hot_cid)                          # and recently used
    # force pressure: demotion machinery picks the stale, single-ref chunk
    store._tiers.hot_capacity_bytes = 300
    with store._lock:
        store._demote_over_capacity_locked()
    assert store.tier_of(cold_cid) == "warm"
    assert store.tier_of(hot_cid) == "hot"
    store.decref(hot_cid)


# ------------------------------------------------- corruption + self-heal
def test_corrupt_tier_payload_heals_from_repair_source(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path))
    data = _payload(3)
    cid = store.put(data)
    assert store.demote(cid)
    store.corrupt_chunk_for_test(cid)           # mangles the warm copy
    store.attach_repair_source(lambda c, dg, pad: data)
    assert store.get(cid) == data               # promotion verify → heal
    assert store.repair_stats.repaired == 1
    assert store.tiers.stats.promote_verify_failures == 1
    assert store.tier_of(cid) == "hot"


def test_corrupt_cold_payload_without_source_quarantines(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path))
    cid = store.put(_payload(4))
    assert store.demote(cid, tier="cold")
    store.corrupt_chunk_for_test(cid)
    with pytest.raises(ChunkCorruptionError):
        store.get(cid)
    assert cid in store.quarantined_ids()


# ------------------------------------------------------------- accounting
def test_tier_bytes_accounting_consistent(tmp_path):
    store = ChunkStore(chunk_bytes=256, tiers=_tiers(tmp_path, hot=1 << 20))
    data = [_payload(i) for i in range(6)]
    cids = [store.put(d) for d in data]
    total = sum(len(d) for d in data)
    assert store.tier_bytes()["hot"] == total
    for cid in cids[:3]:
        store.demote(cid)
    tb = store.tier_bytes()
    assert tb["hot"] == sum(len(d) for d in data[3:])
    assert tb["warm"] == sum(len(d) for d in data[:3])
    # promote everything back
    for cid, d in zip(cids, data):
        assert store.get(cid) == d
    tb = store.tier_bytes()
    assert tb["hot"] == total and tb.get("warm", 0) == 0


def test_digest_dedupe_shares_one_tier_copy(tmp_path):
    """Two logical chunks with identical content share one content-
    addressed tier object (the digest IS the key)."""
    tiers = _tiers(tmp_path)
    store = ChunkStore(chunk_bytes=256, tiers=tiers)
    d = _payload(9)
    c1 = store.put(d)
    c2 = store.put(d)                           # dedupe: same cid
    assert c1 == c2
    digest = store.digest_of(c1)
    assert digest is not None
    key = tier_key(digest, store.pad_of(c1))
    store.demote(c1)
    assert tiers.warm.get(key) == d


def test_tier_manager_warm_overflow_cascades_to_cold(tmp_path):
    store = ChunkStore(
        chunk_bytes=256,
        tiers=make_local_tiers(
            str(tmp_path / "t"), hot_capacity_bytes=256, warm_capacity_bytes=300
        ),
    )
    cids = [store.put(_payload(i)) for i in range(4)]
    tiers = [store.tier_of(c) for c in cids]
    assert "cold" in tiers                      # warm could not hold them all
    for cid, i in zip(cids, range(4)):
        assert store.get(cid) == _payload(i)
