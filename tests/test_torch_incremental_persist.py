"""O(delta) persistence: incremental snapshot chains, fold-on-recover,
prefix-truncation durability, manifest compaction, digest-index repair,
bounded-tail manifest reads, cross-sandbox chunk dedupe, and retention's
disk-footprint bound.

The JAX package's ``tests/test_incremental_persist.py`` on the port: the same cases, with
``device="cpu"`` passed to every recovery (the port recovers onto the card
unless asked not to), so recovered trunks are ``CowTensorState`` on the
CPU."""
import pytest

pytest.importorskip("torch")

import os
import shutil
import tempfile

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.core.persist as persist
from repro_torch.core import (
    CowArrayState,
    DeltaCR,
    DeltaFS,
    Sandbox,
    StateManager,
    compact_state,
    faults,
    recency_gc,
    recover,
    save_state,
)
from repro_torch.core.faults import FaultError
from repro_torch.core.persist import (
    PersistencePlane,
    _read_manifest,
)


torch.set_num_threads(1)


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _mk_sm(chunk_bytes=512, seed=0):
    fs = DeltaFS(chunk_bytes=chunk_bytes)
    rng = np.random.default_rng(seed)
    fs.write("repo/a", rng.integers(0, 255, 2048).astype(np.uint8))
    proc = CowArrayState(
        {
            "heap": rng.standard_normal(1024).astype(np.float32),
            "regs": rng.standard_normal(64).astype(np.float32),
        }
    )
    cr = DeltaCR(store=fs.store, restore_fn=_restore, template_pool_size=4)
    sm = StateManager(Sandbox(fs, proc), cr)
    return sm, fs, cr


def _step(sm, fs, cr, i, seed=0):
    """One durable step: distinguishable mutation + checkpoint + drain."""
    rng = np.random.default_rng(seed * 1000 + i)
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, float(i)))
    fs.write("repo/a", rng.integers(0, 255, 2048).astype(np.uint8))
    ckpt = sm.checkpoint()
    cr.wait_dumps()
    return ckpt


def _disk_bytes(root):
    total = 0
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            total += os.path.getsize(os.path.join(dirpath, f))
    return total


def _pack_blob(root):
    """All pack payload bytes under a root, in name order (for byte-identity
    comparisons between two freshly written roots)."""
    cdir = os.path.join(root, "chunks")
    out = []
    if os.path.isdir(cdir):
        for f in sorted(os.listdir(cdir)):
            if f.startswith("pack-"):
                with open(os.path.join(cdir, f), "rb") as fh:
                    out.append(fh.read())
    return b"".join(out)


def _snap_blob(root, fname):
    with open(os.path.join(root, fname), "rb") as f:
        return f.read()


# -------------------------------------------------------- delta chain basics
def test_delta_saves_write_o_delta_bytes(tmp_path):
    """Steady-state incremental saves write far fewer bytes than the full
    anchor — the tentpole's headline property at test scale."""
    sm, fs, cr = _mk_sm()
    plane = PersistencePlane(str(tmp_path / "p"), keep_snapshots=8, full_every=16)
    _step(sm, fs, cr, 1)
    plane.save(sm=sm)
    full_bytes = plane.last_save_stats["bytes_written"]
    assert plane.last_save_stats["kind"] == "full"
    delta_bytes = []
    for i in range(2, 6):
        # dirty only the proc heap's first element: O(1 chunk) of new data
        sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, float(i)))
        sm.checkpoint()
        cr.wait_dumps()
        plane.save(sm=sm)
        assert plane.last_save_stats["kind"] == "delta"
        delta_bytes.append(plane.last_save_stats["bytes_written"])
    assert max(delta_bytes) * 2 < full_bytes
    rec = plane.recover(device="cpu")
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 5.0
    cr.shutdown()
    rec.deltacr.shutdown()


@settings(max_examples=3, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=1 << 16),
    full_every=st.integers(min_value=1, max_value=4),
)
def test_prefix_truncated_chain_recovers_most_recent_durable(seed, full_every):
    """Property: truncating the manifest to ANY line prefix recovers exactly
    the most recent snapshot durable within that prefix — a crash anywhere
    in a delta chain never yields a wrong or unrecoverable state."""
    with tempfile.TemporaryDirectory() as base:
        sm, fs, cr = _mk_sm(seed=seed)
        root = os.path.join(base, "state")
        plane = PersistencePlane(root, keep_snapshots=32, full_every=full_every)
        n = 6
        for i in range(1, n + 1):
            _step(sm, fs, cr, i, seed=seed)
            plane.save(sm=sm)
        with open(os.path.join(root, "MANIFEST"), "rb") as f:
            lines = f.read().splitlines(keepends=True)
        assert len(lines) == n
        for k in range(1, n + 1):
            sub = os.path.join(base, f"prefix-{k}")
            shutil.copytree(root, sub)
            with open(os.path.join(sub, "MANIFEST"), "wb") as f:
                f.write(b"".join(lines[:k]))
            rec = recover(sub, device="cpu")
            assert rec.seq == k
            assert rec.state_manager.sandbox.proc.get("heap")[0] == float(k)
            rec.deltacr.shutdown()
            # a torn half-line after the prefix is dropped, not misread
            if k < n:
                sub2 = os.path.join(base, f"torn-{k}")
                shutil.copytree(root, sub2)
                with open(os.path.join(sub2, "MANIFEST"), "wb") as f:
                    f.write(b"".join(lines[:k]) + lines[k][: len(lines[k]) // 2])
                rec = recover(sub2, device="cpu")
                assert rec.seq == k
                rec.deltacr.shutdown()
        cr.shutdown()


def test_corrupt_manifest_tail_entry_falls_back(tmp_path):
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=8, full_every=2)
    for i in range(1, 4):
        _step(sm, fs, cr, i)
        plane.save(sm=sm)
    path = os.path.join(root, "MANIFEST")
    with open(path, "rb") as f:
        raw = f.read()
    # flip one byte inside the final (checksummed) line
    mangled = bytearray(raw)
    mangled[-10] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(mangled))
    rec = recover(root, device="cpu")
    assert rec.seq == 2
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 2.0
    cr.shutdown()
    rec.deltacr.shutdown()


def test_corrupt_pack_bytes_fall_back_to_older_candidate(tmp_path):
    """Rotten pack payload fails the per-chunk digest verify; recovery drops
    to the previous durable snapshot instead of returning wrong bytes."""
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    _step(sm, fs, cr, 1)
    save_state(root, sm=sm, mode="full", keep_snapshots=8)
    _step(sm, fs, cr, 2)
    save_state(root, sm=sm, mode="full", keep_snapshots=8)
    packs = sorted(
        f for f in os.listdir(os.path.join(root, "chunks")) if f.startswith("pack-")
    )
    assert len(packs) >= 2
    victim = os.path.join(root, "chunks", packs[-1])  # seq-2's new chunks
    with open(victim, "r+b") as f:
        head = bytearray(f.read(16))
        head[0] ^= 0xFF
        f.seek(0)
        f.write(bytes(head))
    rec = recover(root, device="cpu")
    assert rec.seq == 1
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 1.0
    cr.shutdown()
    rec.deltacr.shutdown()


# ------------------------------------------------- byte-identity round trips
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1 << 16))
def test_incremental_recover_resave_matches_fresh_full_save(seed):
    """Property: recovering an incremental chain and re-saving full is
    byte-identical (snapshot doc AND packs) to a from-scratch full save of
    the live state — the delta plane loses nothing and invents nothing."""
    with tempfile.TemporaryDirectory() as base:
        sm, fs, cr = _mk_sm(seed=seed)
        chain_root = os.path.join(base, "chain")
        plane = PersistencePlane(chain_root, keep_snapshots=16, full_every=8)
        for i in range(1, 5):
            _step(sm, fs, cr, i, seed=seed)
            plane.save(sm=sm)
        assert plane.last_save_stats["kind"] == "delta"
        rec = recover(chain_root, device="cpu")

        via_chain = os.path.join(base, "a")
        from_scratch = os.path.join(base, "b")
        save_state(via_chain, sm=rec.state_manager, mode="full")
        save_state(from_scratch, sm=sm, mode="full")
        e1, e2 = _read_manifest(via_chain)[-1], _read_manifest(from_scratch)[-1]
        assert _snap_blob(via_chain, e1["file"]) == _snap_blob(from_scratch, e2["file"])
        assert _pack_blob(via_chain) == _pack_blob(from_scratch)
        cr.shutdown()
        rec.deltacr.shutdown()


# --------------------------------------------------------------- compaction
def test_compaction_preserves_state_and_shrinks_manifest(tmp_path):
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=4, full_every=8)
    for i in range(1, 6):
        _step(sm, fs, cr, i)
        plane.save(sm=sm)
    before = recover(root, device="cpu")
    entries_before = _read_manifest(root)
    assert len(entries_before) > 1

    # keep_snapshots=1: the fresh full anchor is the whole history
    seq = compact_state(root, keep_snapshots=1)
    entries_after = _read_manifest(root)
    assert len(entries_after) == 1 and int(entries_after[-1]["seq"]) == seq
    after = recover(root, device="cpu")
    assert after.seq == seq

    # bit-identical across the compaction boundary: full re-saves of both
    # recovered worlds produce the same bytes
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    save_state(d1, sm=before.state_manager, mode="full")
    save_state(d2, sm=after.state_manager, mode="full")
    f1, f2 = _read_manifest(d1)[-1]["file"], _read_manifest(d2)[-1]["file"]
    assert _snap_blob(d1, f1) == _snap_blob(d2, f2)
    assert _pack_blob(d1) == _pack_blob(d2)
    # superseded snapshot docs are actually gone
    snaps = [f for f in os.listdir(root) if f.startswith("snap-")]
    assert len(snaps) == 1
    cr.shutdown()
    before.deltacr.shutdown()
    after.deltacr.shutdown()


def test_mid_compaction_kill_recovers_previous_durable(tmp_path, monkeypatch):
    """A kill after the new full doc lands but before the atomic manifest
    switch leaves the OLD manifest authoritative: recovery returns the
    pre-compaction state bit-for-bit, and a retried compaction succeeds."""
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=8, full_every=8)
    for i in range(1, 4):
        _step(sm, fs, cr, i)
        plane.save(sm=sm)
    with open(os.path.join(root, "MANIFEST"), "rb") as f:
        manifest_before = f.read()

    real_replace = os.replace

    def _dying_replace(src, dst, *a, **kw):
        if os.path.basename(dst) == "MANIFEST":
            raise OSError("simulated kill before manifest switch")
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr(persist.os, "replace", _dying_replace)
    with pytest.raises(OSError):
        compact_state(root)
    monkeypatch.setattr(persist.os, "replace", real_replace)

    with open(os.path.join(root, "MANIFEST"), "rb") as f:
        assert f.read() == manifest_before        # commit point never moved
    rec = recover(root, device="cpu")
    assert rec.seq == 3
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 3.0
    rec.deltacr.shutdown()

    seq = compact_state(root)                     # retry heals the orphans
    rec2 = recover(root, device="cpu")
    assert rec2.seq == seq
    assert rec2.state_manager.sandbox.proc.get("heap")[0] == 3.0
    cr.shutdown()
    rec2.deltacr.shutdown()


def test_compaction_fault_point_fires(tmp_path):
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    _step(sm, fs, cr, 1)
    save_state(root, sm=sm)
    with faults.inject(faults.FaultPlan().add("persist.compact")):
        with pytest.raises(FaultError):
            compact_state(root)
    rec = recover(root, device="cpu")                           # untouched
    assert rec.seq == 1
    cr.shutdown()
    rec.deltacr.shutdown()


def test_v1_root_recovers_and_compaction_migrates_to_v2(tmp_path):
    """Migration: legacy v1 snapshots recover unchanged through the same
    door; compaction converts the root to the v2 chunk-pack layout."""
    sm, fs, cr = _mk_sm()
    _step(sm, fs, cr, 1)
    root = str(tmp_path / "state")
    save_state(root, sm=sm, fmt=1)
    assert not os.path.isdir(os.path.join(root, "chunks"))
    rec1 = recover(root, device="cpu")
    assert rec1.state_manager.sandbox.proc.get("heap")[0] == 1.0

    compact_state(root)
    assert os.path.isdir(os.path.join(root, "chunks"))
    rec2 = recover(root, device="cpu")
    assert rec2.state_manager.sandbox.proc.get("heap")[0] == 1.0
    np.testing.assert_array_equal(
        rec1.state_manager.sandbox.fs.read("repo/a"),
        rec2.state_manager.sandbox.fs.read("repo/a"),
    )
    # and the migrated root keeps accepting (now incremental) saves
    _step(sm, fs, cr, 2)
    stats = {}
    save_state(root, sm=sm, stats_out=stats)
    assert stats["fmt"] == 2
    rec3 = recover(root, device="cpu")
    assert rec3.state_manager.sandbox.proc.get("heap")[0] == 2.0
    cr.shutdown()
    for r in (rec1, rec2, rec3):
        r.deltacr.shutdown()


# ------------------------------------------------------- digest index repair
def test_digest_index_rebuilt_when_missing_or_corrupt(tmp_path):
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=8, full_every=2)
    for i in range(1, 4):
        _step(sm, fs, cr, i)
        plane.save(sm=sm)
    idx_path = os.path.join(root, "chunks", "INDEX")
    assert os.path.exists(idx_path)
    with open(idx_path, "rb") as f:
        healthy = f.read()

    os.unlink(idx_path)
    rec = recover(root, device="cpu")
    assert rec.seq == 3
    assert os.path.exists(idx_path)               # rebuild persisted
    rec.deltacr.shutdown()

    with open(idx_path, "wb") as f:
        f.write(b"\x00garbage\tnot-a-checksum\n" * 64)
    rec = recover(root, device="cpu")
    assert rec.seq == 3
    with open(idx_path, "rb") as f:
        rebuilt = f.read()
    assert rebuilt != b"\x00garbage\tnot-a-checksum\n" * 64
    assert len(rebuilt) >= len(healthy) // 2      # real entries are back
    cr.shutdown()
    rec.deltacr.shutdown()


# ------------------------------------------------------ bounded manifest IO
def test_recover_reads_bounded_tail_of_multi_mb_manifest(tmp_path):
    """Satellite regression: recovery of a root with a multi-MB manifest
    must read only the bounded tail, not the whole history."""
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=8, full_every=1)
    for i in range(1, 4):
        _step(sm, fs, cr, i)
        plane.save(sm=sm)
    path = os.path.join(root, "MANIFEST")
    with open(path, "rb") as f:
        raw = f.read()
    first = raw.splitlines(keepends=True)[0]
    pad_lines = (3 * (1 << 20)) // len(first) + 1  # >3 MiB of old history
    with open(path, "wb") as f:
        f.write(first * pad_lines + raw)
    assert os.path.getsize(path) > 3 * (1 << 20)

    rec = recover(root, device="cpu")
    assert rec.seq == 3
    assert persist.LAST_MANIFEST_BYTES_READ <= 256 << 10
    cr.shutdown()
    rec.deltacr.shutdown()


# -------------------------------------------------------- dedupe + retention
def test_digest_dedupe_stores_shared_base_once_across_sandboxes(tmp_path):
    """Four sandboxes sharing the same base image persist into one root:
    the shared chunks land in the packs exactly once (accounting test)."""
    root = str(tmp_path / "state")
    stats_by_save = []
    crs = []
    for i in range(4):
        sm, fs, cr = _mk_sm(seed=0)               # identical shared base
        crs.append(cr)
        # each sandbox diverges by one scalar — its private delta
        sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(i, float(i + 1)))
        sm.checkpoint()
        cr.wait_dumps()
        stats = {}
        save_state(root, sm=sm, keep_snapshots=16, stats_out=stats)
        stats_by_save.append(stats)
    base_pack = stats_by_save[0]["pack_bytes"]
    assert base_pack > 0
    for stats in stats_by_save[1:]:
        # only the sandbox's private dirty chunk(s), never the shared base
        assert stats["pack_bytes"] * 4 <= base_pack
    total_pack = sum(s["pack_bytes"] for s in stats_by_save)
    assert total_pack < 2 * base_pack             # nowhere near 4x
    for cr in crs:
        cr.shutdown()


def test_retention_bounds_disk_footprint(tmp_path):
    """keep_snapshots + pack GC + periodic compaction keep the on-disk
    footprint flat under an unbounded save stream whose LIVE set is bounded
    (unreferenced blob bytes are actually reclaimed, not just dropped from
    the manifest).  Mutations stay in the proc heap: snapshot GC frees the
    old images, so their pack bytes must eventually leave the disk too."""
    sm, fs, cr = _mk_sm()
    root = str(tmp_path / "state")
    plane = PersistencePlane(root, keep_snapshots=2, full_every=4, compact_every=8)

    def _one_round(i):
        sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(0, 128), float(i)))
        sm.checkpoint()
        cr.wait_dumps()
        recency_gc(sm, keep_last=2)               # bound the live tree too
        plane.save(sm=sm)

    for i in range(1, 13):
        _one_round(i)
    mid = _disk_bytes(root)
    for i in range(13, 25):
        _one_round(i)
    end = _disk_bytes(root)
    assert end <= mid * 1.6 + 4096                # flat, not linear in saves
    snaps = [f for f in os.listdir(root) if f.startswith("snap-")]
    assert len(snaps) <= plane.keep_snapshots + plane.full_every
    packs = os.listdir(os.path.join(root, "chunks"))
    assert len([f for f in packs if f.startswith("pack-")]) <= 8
    rec = recover(root, device="cpu")
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 24.0
    cr.shutdown()
    rec.deltacr.shutdown()
