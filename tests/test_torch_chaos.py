"""Chaos suite: deterministic fault injection across the DeltaState stack.

Every test drives the *production* seams (``core/faults.py`` fire points in
ChunkStore, the stream drain pool, the FIFO dump worker, template forks, and
persistence blob/manifest I/O) and asserts the transactional contract: a
checkpoint either lands bit-identical to the fault-free run or aborts with
nothing half-committed — refcounts balanced, no partial images, loud errors.

Fault plans install process-globally, so these tests must never run with
parallel workers (see the ``chaos`` marker registration in conftest.py).

The JAX package's ``tests/test_chaos.py`` on the port: its host states,
recovery with ``device="cpu"``, and the engine case on the port's ``Model``
and ``Engine`` over the JAX model's weights (``convert.params_from_numpy``).
A ``KernelError`` fails a dump in the port rather than falling back (its own
test is in ``test_torch_deltacr.py``); the injected faults here keep the
reference's retry and fallback.
"""
import pytest

pytest.importorskip("torch")

import threading

import numpy as np
import torch

from repro_torch.core import (
    ChunkCorruptionError,
    ChunkStore,
    CowArrayState,
    DeltaCR,
    DumpPolicy,
    FaultError,
    RecoverError,
    faults,
)
from repro_torch.core.persist import PersistencePlane
from repro_torch.core.stream import StreamConfig

torch.set_num_threads(1)

SEEDS = (0, 1, 2)


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _mk_state(seed, n=1024):
    rng = np.random.default_rng(seed)
    return CowArrayState(
        {
            "a": rng.standard_normal(n).astype(np.float32),
            "b": rng.integers(0, 255, n).astype(np.uint8),
        },
        hot_keys=("a",),
    )


def _mutate(state, step):
    """Deterministic per-step divergence touching a slice of each tensor."""
    lo = (step * 37) % 512
    state.mutate("a", lambda a: a.__setitem__(slice(lo, lo + 64), float(step)))
    state.mutate("b", lambda b: b.__setitem__(slice(lo, lo + 32), step % 251))


def _snapshot(state):
    return {k: np.asarray(state.get(k)).copy() for k in ("a", "b")}


def _decode(cr, image):
    """Decode an image's payload straight from store chunks (mode-agnostic:
    every image carries a self-contained full chunk map per tensor)."""
    return {
        name: cr.store.get_array(meta.chunk_ids, meta.shape, np.dtype(meta.dtype))
        for name, meta in image.entries.items()
    }


def _assert_bit_identical(cr, image, expected):
    got = _decode(cr, image)
    assert set(got) == set(expected)
    for name in expected:
        assert got[name].tobytes() == expected[name].tobytes(), name


def _drop_all_and_assert_balanced(cr, ckpt_ids):
    """Refcount conservation: dropping every checkpoint drains the store."""
    cr.images.debug_validate()
    for cid in ckpt_ids:
        cr.drop_checkpoint(cid)
    cr.wait_dumps()
    cr.images.debug_validate()
    assert cr.images.live_count() == 0
    assert cr.store.stats.physical_bytes == 0, (
        f"leaked {cr.store.stats.physical_bytes} physical bytes after drop-all"
    )


# --------------------------------------------------------------------------
# randomized schedules: land-bit-identical or abort-transactionally
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(120)
@pytest.mark.parametrize("seed", SEEDS)
def test_randomized_faults_land_bit_identical_or_abort(seed):
    """Under a seed-derived schedule of put/drain/worker/fork faults (worker
    kills included), every checkpoint either commits bytes identical to the
    fault-free state or fails loudly with no partial image, and dropping
    everything returns the store to empty."""
    plan = faults.FaultPlan.randomized(seed, kill_ok=True)
    state = _mk_state(seed)
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256, template_pool_size=4,
                 policy=DumpPolicy(retry_backoff_s=0.0))
    expected = {}
    submitted = []
    with faults.inject(plan):
        parent = None
        for step in range(1, 9):
            _mutate(state, step)
            want = _snapshot(state)
            try:
                cr.checkpoint(state, step, parent)
            except FaultError:
                # template-fork fault: transactional no-op — nothing queued
                assert cr.dump_future(step) is None
                assert not cr.has_template(step)
                continue
            expected[step] = want
            submitted.append(step)
            parent = step
        landed, failed = [], []
        for step in submitted:
            try:
                landed.append((step, cr.dump_future(step).result(timeout=60)))
            except Exception:
                failed.append(step)
    assert plan.fired() >= 1, "seeded plan never fired — schedule is dead"
    for step, image in landed:
        _assert_bit_identical(cr, image, expected[step])
    for step in failed:
        # aborted transactionally: the ticket resolved, no image survives
        assert cr.images.image_for(step) is None
    kills = sum(1 for _, _, action in plan.log if action == "kill")
    assert cr._dump_worker.deaths == kills
    assert cr._dump_worker.restarts == kills  # supervision respawned each one
    _drop_all_and_assert_balanced(cr, submitted)
    cr.shutdown()


# --------------------------------------------------------------------------
# targeted: delta -> legacy fallback, degraded mode, poisoned-anchor eviction
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_delta_failure_falls_back_to_legacy_then_degrades_and_probes():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256, template_pool_size=8,
                 policy=DumpPolicy(retries=1, retry_backoff_s=0.0,
                                   delta_fail_threshold=1, degraded_probe_every=3))
    s = _mk_state(7)
    expected = {}

    def ckpt(step, parent):
        _mutate(s, step)
        expected[step] = _snapshot(s)
        cr.checkpoint(s, step, parent)
        cr.wait_dumps(timeout=60)
        return cr.dump_future(step).result()

    img1 = ckpt(1, None)
    assert img1.mode == "delta"                      # fault-free baseline
    anchored = cr.pipeline.record_for(img1.image_id)
    assert anchored is not None
    cr.pipeline.release_record(anchored)

    # both delta attempts fail (retries=1 -> 2 attempts); the third
    # fire-point hit is the legacy attempt, which the plan leaves alone
    with faults.inject(faults.FaultPlan().add("dump.worker", after=1, times=2)):
        img2 = ckpt(2, 1)
    assert img2.mode == "legacy"
    h = cr.health()
    assert h["dump_retries"] == 1                    # one retry before fallback
    assert h["fallback_dumps"] == 1
    assert h["dump_failures"] == 0                   # the checkpoint LANDED
    assert h["degraded"] is True                     # threshold=1 tripped
    # poisoned-anchor invalidation: the generation the failing dump diffed
    # against is evicted, so the next delta re-bases on a fresh full pass
    assert cr.pipeline.record_for(img1.image_id) is None

    img3 = ckpt(3, 2)                                # degraded skip 1
    img4 = ckpt(4, 3)                                # degraded skip 2
    img5 = ckpt(5, 4)                                # probe (every 3rd) -> delta
    img6 = ckpt(6, 5)                                # healthy again
    assert [img3.mode, img4.mode, img5.mode, img6.mode] == [
        "legacy", "legacy", "delta", "delta"
    ]
    h = cr.health()
    assert h["degraded_dumps"] == 2
    assert h["degraded"] is False                    # probe success reset it
    for step in (1, 2, 3, 4, 5, 6):
        _assert_bit_identical(cr, cr.dump_future(step).result(), expected[step])
    _drop_all_and_assert_balanced(cr, [1, 2, 3, 4, 5, 6])
    cr.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_drain_pool_faults_fall_back_without_partial_commit():
    """Persistent drain-stage failures (every window, unlimited) roll back
    the streamed delta attempt each time; the legacy path lands the dump."""
    cfg = StreamConfig(window_bytes=1024, min_windows=2)
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256, template_pool_size=4,
                 policy=DumpPolicy(retries=1, retry_backoff_s=0.0, stream_config=cfg))
    s = _mk_state(5, n=4096)                         # 16 KiB/tensor: streams
    _mutate(s, 1)
    want = _snapshot(s)
    with faults.inject(faults.FaultPlan().add("stream.drain", times=0)) as plan:
        cr.checkpoint(s, 1, None)
        img = cr.dump_future(1).result(timeout=60)
        assert plan.fired("stream.drain") >= 1
    assert img.mode == "legacy"
    assert cr.health()["fallback_dumps"] == 1
    _assert_bit_identical(cr, img, want)
    _drop_all_and_assert_balanced(cr, [1])
    cr.shutdown()


# --------------------------------------------------------------------------
# targeted: supervised worker death
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_worker_death_respawns_and_queued_dumps_survive():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256, template_pool_size=8,
                 policy=DumpPolicy(retry_backoff_s=0.0))
    s = _mk_state(9)
    expected = {}
    with faults.inject(faults.FaultPlan().add("dump.worker", action="kill")):
        for step in (1, 2, 3):                       # queue all three at once
            _mutate(s, step)
            expected[step] = _snapshot(s)
            cr.checkpoint(s, step, step - 1 if step > 1 else None)
        with pytest.raises(FaultError, match="worker died"):
            cr.dump_future(1).result(timeout=60)
        img2 = cr.dump_future(2).result(timeout=60)  # drained by the successor
        img3 = cr.dump_future(3).result(timeout=60)
    assert cr.images.image_for(1) is None            # aborted, no half-image
    assert cr._dump_worker.deaths == 1
    assert cr._dump_worker.restarts == 1
    h = cr.health()
    assert h["worker_deaths"] == 1 and h["dump_failures"] == 1
    _assert_bit_identical(cr, img2, expected[2])
    _assert_bit_identical(cr, img3, expected[3])
    _drop_all_and_assert_balanced(cr, [1, 2, 3])
    cr.shutdown()


# --------------------------------------------------------------------------
# targeted: template-fork faults are transactional no-ops
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_template_fork_fault_registers_nothing():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256)
    s = _mk_state(3)
    with faults.inject(faults.FaultPlan().add("template.fork")):
        with pytest.raises(FaultError):
            cr.checkpoint(s, 1, None)
    assert cr.dump_future(1) is None
    assert not cr.has_template(1)
    cr.images.debug_validate()
    assert cr.images.live_count() == 0
    assert cr.store.stats.physical_bytes == 0
    want = _snapshot(s)
    cr.checkpoint(s, 1, None)                        # clean retry works
    cr.wait_dumps()
    _assert_bit_identical(cr, cr.dump_future(1).result(), want)
    _drop_all_and_assert_balanced(cr, [1])
    cr.shutdown()


# --------------------------------------------------------------------------
# verified reads: detection, repair from generation anchors, quarantine
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_verified_read_repairs_corruption_from_generation_anchor():
    store = ChunkStore(chunk_bytes=256, verify_reads=True)
    cr = DeltaCR(store=store, restore_fn=_restore, template_pool_size=4)
    s = _mk_state(11)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    img = cr.dump_future(1).result()
    want = _snapshot(s)
    cid = img.entries["a"].chunk_ids[0]
    store.corrupt_chunk_for_test(cid)                # bitrot in the store copy
    data = store.get(cid)                            # detect + heal in place
    rs = store.repair_stats.snapshot()
    assert rs.mismatches == 1 and rs.repaired == 1 and rs.quarantined == 0
    assert store.digest_of(cid) is not None
    assert not store.quarantined_ids()
    assert len(data) == 256
    _assert_bit_identical(cr, img, want)             # healed payload is exact
    assert cr.health()["chunk_repairs"] == 1
    _drop_all_and_assert_balanced(cr, [1])
    cr.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_verified_read_quarantines_when_unrepairable():
    store = ChunkStore(chunk_bytes=256, verify_reads=True)
    cr = DeltaCR(store=store, restore_fn=_restore, template_pool_size=4)
    s = _mk_state(13)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    img = cr.dump_future(1).result()
    cr.release_dump_anchor(1)                        # no anchor left to heal from
    cid = img.entries["b"].chunk_ids[0]
    store.corrupt_chunk_for_test(cid)
    with pytest.raises(ChunkCorruptionError) as ei:
        store.get(cid)
    assert ei.value.cid == cid                       # loud, names the chunk
    assert cid in store.quarantined_ids()
    rs = store.repair_stats.snapshot()
    assert rs.quarantined == 1 and rs.repaired == 0
    with pytest.raises(ChunkCorruptionError):        # stays fenced off
        store.get(cid)
    assert cr.health()["quarantined_chunks"] == 1
    cr.shutdown()


# --------------------------------------------------------------------------
# persistence plane: blob/manifest faults, restore-after-corruption
# --------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_persist_io_faults_fail_loudly_and_keep_previous_snapshot(tmp_path):
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256)
    s = _mk_state(17)
    _mutate(s, 1)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    plane = PersistencePlane(str(tmp_path / "state"))
    assert plane.save(deltacr=cr) == 1

    _mutate(s, 2)
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    with faults.inject(faults.FaultPlan().add("persist.blob_write")):
        with pytest.raises(FaultError):
            plane.save(deltacr=cr)
    assert plane.last_seq() == 1                     # old snapshot untouched
    with faults.inject(faults.FaultPlan().add("persist.manifest_append")):
        with pytest.raises(FaultError):
            plane.save(deltacr=cr)
    assert plane.last_seq() == 1                     # orphan blobs are ignored
    rec = plane.recover(restore_fn=_restore, device="cpu")         # seq-1 still recovers
    assert rec.seq == 1
    rec.deltacr.shutdown()
    seq = plane.save(deltacr=cr)                     # plane heals: next save lands
    assert seq > 1 and plane.last_seq() == seq
    cr.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(60)
def test_restore_after_corruption_heals_from_durable_blobs(tmp_path):
    """The satellite scenario: recover a snapshot, bitrot one chunk in the
    recovered store, and watch the verified read heal it from the persisted
    blob; then corrupt the blob itself on disk and require a loud recover
    failure instead of wrong tensor bytes."""
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=256)
    s = _mk_state(19)
    _mutate(s, 1)
    want = _snapshot(s)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root)
    plane.save(deltacr=cr)
    cr.shutdown()

    rec = plane.recover(restore_fn=_restore, device="cpu")
    cr2 = rec.deltacr
    img = cr2.images.image_for(1)
    assert img is not None
    cr2.store.verify_reads = True
    plane.attach_to(cr2.store)                       # durable blobs as healer
    cid = img.entries["a"].chunk_ids[1]
    cr2.store.corrupt_chunk_for_test(cid)
    _assert_bit_identical(cr2, img, want)            # read detects + repairs
    rs = cr2.store.repair_stats.snapshot()
    assert rs.mismatches == 1 and rs.repaired == 1 and rs.quarantined == 0
    cr2.shutdown()

    # Now rot the durable bytes themselves: recovery must refuse the
    # snapshot (digest-verified pack reads), not silently serve flipped
    # bytes.  v2 layout: chunk payloads live in the content-addressed packs.
    blobs = sorted(tmp_path.glob("state/chunks/pack-*.blob"),
                   key=lambda p: p.stat().st_size)
    blob = blobs[-1]                                 # largest pack holds chunks
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    blob.write_bytes(bytes(raw))
    with pytest.raises(RecoverError):
        plane.recover(restore_fn=_restore, device="cpu")


# --------------------------------------------------------------------------
# serving loop: CoW page privatization is transactional (kvcache.cow_copy)
# --------------------------------------------------------------------------
def _serve_world(verify_cow: bool):
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models import Model as JModel
    from repro_torch.configs import get_config
    from repro_torch.core.convert import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.serve import Engine, PagePool

    cfg = get_config("olmo-1b-tiny")
    tree = jax.tree.map(np.asarray, JModel(j_get_config("olmo-1b-tiny")).init(jax.random.PRNGKey(0)))
    model = Model(cfg, device="cpu", params=params_from_numpy(tree, device="cpu"))
    params = model.params

    def mk_pool():
        return PagePool(cfg, num_pages=64, page_size=8,
                        max_pages_per_session=16, verify_cow=verify_cow, device="cpu")

    pool = mk_pool()
    return pool, Engine(model, pool), mk_pool, model, params


def _kv_snapshot(pool, sessions):
    return (
        pool.refs.copy(),
        pool.free_pages(),
        [s.table.copy() for s in sessions],
        [s.seq_len for s in sessions],
    )


@pytest.mark.chaos
@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["raise", "corrupt"])
def test_cow_copy_fault_rolls_back_and_retry_matches_twin(mode):
    """A fault inside the batched CoW privatization (raise before the copy,
    or detected bitrot after it) must leave every session's table, the
    refcounts, and the free list exactly as they were — and the retried step
    must land the same tokens as a fault-free twin world."""
    from repro_torch.core.faults import FaultError
    from repro_torch.serve import CowCorruptionError, Engine

    pool, eng, mk_pool, model, params = _serve_world(verify_cow=(mode == "corrupt"))
    pool_b = mk_pool()
    eng_b = Engine(model, pool_b)

    prompt = list(range(1, 12))                      # unaligned: tail is shared
    sess = eng.new_session(prompt)
    kids = [sess.fork() for _ in range(2)]
    sess_b = eng_b.new_session(prompt)
    kids_b = [sess_b.fork() for _ in range(2)]

    snap = _kv_snapshot(pool, [sess] + kids)
    plan = faults.FaultPlan().add("kvcache.cow_copy", action=mode)
    with faults.inject(plan):
        expected_exc = FaultError if mode == "raise" else CowCorruptionError
        with pytest.raises(expected_exc):
            eng.step(kids)
        # transactional abort: nothing half-committed
        refs, free, tables, lens = _kv_snapshot(pool, [sess] + kids)
        np.testing.assert_array_equal(refs, snap[0])
        assert free == snap[1]
        for got, want in zip(tables, snap[2]):
            np.testing.assert_array_equal(got, want)
        assert lens == snap[3]
        assert pool.stats.cow_rollbacks == 1
        pool.debug_validate()
        toks = eng.step(kids)                        # fault exhausted: retry lands
    assert plan.fired("kvcache.cow_copy") == 1
    assert pool.stats.cow_copies == 2                # one privatized tail per kid
    toks_b = eng_b.step(kids_b)
    assert toks == toks_b                            # bit-identical to the twin
    pool.debug_validate()
