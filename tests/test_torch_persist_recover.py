"""Persistence plane: full-DeltaState save/recover, crash consistency
(truncated manifests, mid-save kills, corrupt blobs), byte-stable re-save,
generation-anchor recovery, in-flight-dump transactionality.

The JAX package's ``tests/test_persist_recover.py`` on the port: the same cases, with
``device="cpu"`` passed to every recovery (the port recovers onto the card
unless asked not to), so recovered trunks are ``CowTensorState`` on the
CPU."""
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import (
    CowArrayState,
    DeltaCR,
    DeltaFS,
    RecoverError,
    Sandbox,
    StateManager,
    recover,
    save_state,
)
from repro_torch.core.persist import PersistencePlane, _read_manifest


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


def _grow_tree(sm, fs, cr, seed=0):
    """root → c2 → LW c3, plus a branch c4 off root.  Returns the ids."""
    rng = np.random.default_rng(seed + 100)
    c1 = sm.checkpoint()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(0, 16), 2.5))
    fs.write("repo/a", rng.integers(0, 255, 2048).astype(np.uint8))
    fs.write("repo/b", rng.integers(0, 255, 700).astype(np.uint8))
    c2 = sm.checkpoint()
    sm.action_applier = lambda sb, a: sb.proc.mutate(
        "regs", lambda r: r.__setitem__(a, -1.0)
    )
    c3 = sm.checkpoint(lightweight=True, actions=(1, 3))
    sm.restore(c1)
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(32, 48), 7.0))
    c4 = sm.checkpoint()
    cr.wait_dumps()
    return c1, c2, c3, c4


def test_full_state_roundtrip(tmp_path):
    sm, fs, cr = _mk_sm()
    c1, c2, c3, c4 = _grow_tree(sm, fs, cr)
    root = str(tmp_path / "state")
    seq = save_state(root, sm=sm)
    assert seq == 1

    rec = recover(root, device="cpu")
    sm2 = rec.state_manager
    assert sm2 is not None
    assert rec.current == c4
    assert set(sm2.nodes) == set(sm.nodes)
    for cid in sm.nodes:
        a, b = sm.nodes[cid], sm2.nodes[cid]
        assert a.parent_id == b.parent_id
        assert a.lightweight == b.lightweight
        assert a.children == b.children
    # restore the same checkpoint in both worlds: byte-identical
    sm.restore(c2)
    sm2.restore(c2)
    for key in ("heap", "regs"):
        np.testing.assert_array_equal(
            sm.sandbox.proc.get(key), sm2.sandbox.proc.get(key)
        )
    for key in ("repo/a", "repo/b"):
        np.testing.assert_array_equal(sm.sandbox.fs.read(key), sm2.sandbox.fs.read(key))
    # bit-identical chunk digests across the recovery boundary
    for ckpt_id, image in cr.images.live_images():
        rimg = rec.deltacr.images.image_for(ckpt_id)
        assert rimg is not None and rimg.image_id == image.image_id
        for name, meta in image.entries.items():
            assert rimg.entries[name].digests == meta.digests
    # the LW marker replays through the recovered chain
    sm2.action_applier = lambda sb, a: sb.proc.mutate(
        "regs", lambda r: r.__setitem__(a, -1.0)
    )
    assert sm2.restore(c3).endswith("+replay")
    assert sm2.sandbox.proc.get("regs")[1] == -1.0
    # fork pins survive recovery
    assert sm2.pinned_ckpts() == sm.pinned_ckpts()
    cr.shutdown()
    rec.deltacr.shutdown()


def test_recovered_dumps_stay_o_delta(tmp_path):
    """Generation-cache anchors are rebuilt: the first post-recovery dump
    delta-chains against a recovered image instead of a full dump."""
    sm, fs, cr = _mk_sm()
    c1 = sm.checkpoint()
    cr.wait_dumps()
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    rec = recover(root, device="cpu")
    sm2, cr2 = rec.state_manager, rec.deltacr
    assert cr2.pipeline is not None and cr2.pipeline.anchored_ids()
    sm2.restore(c1)
    sm2.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 11.0))
    c_new = sm2.checkpoint()
    cr2.wait_dumps()
    image = cr2.images.image_for(c_new)
    assert image is not None and image.mode == "delta"
    # untouched tensors were re-referenced, not re-materialized
    assert cr2.stats.clean_keys + cr2.stats.kernel_keys > 0
    assert image.dump_bytes < sum(
        m.nbytes for m in image.entries.values()
    )
    cr.shutdown()
    cr2.shutdown()


def test_truncated_manifest_recovers_previous(tmp_path):
    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 123.0))
    sm.checkpoint()
    cr.wait_dumps()
    save_state(root, sm=sm)
    # tear the last manifest record mid-line (a crashed append)
    mpath = os.path.join(root, "MANIFEST")
    with open(mpath, "rb") as f:
        raw = f.read()
    with open(mpath, "wb") as f:
        f.write(raw[: len(raw) - 17])
    rec = recover(root, device="cpu")
    assert rec.seq == 1
    cr.shutdown()
    rec.deltacr.shutdown()


def test_corrupt_snapshot_blob_falls_back(tmp_path):
    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    save_state(root, sm=sm)
    entries = _read_manifest(root)
    assert len(entries) == 2
    # flip one byte deep in the newest snapshot blob
    snap = os.path.join(root, entries[-1]["file"])
    with open(snap, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    rec = recover(root, device="cpu")
    assert rec.seq == 1                          # digest mismatch → previous
    cr.shutdown()
    rec.deltacr.shutdown()


def test_mid_save_kill_recovers_last_durable(tmp_path, monkeypatch):
    sm, fs, cr = _mk_sm()
    c1, c2, c3, c4 = _grow_tree(sm, fs, cr)
    root = str(tmp_path / "state")
    save_state(root, sm=sm)

    # crash 1: killed before the blob rename — only a tmp file exists
    import repro_torch.core.persist as persist_mod

    def boom(*a, **k):
        raise OSError("simulated crash during rename")

    monkeypatch.setattr(persist_mod.os, "replace", boom)
    with pytest.raises(OSError):
        save_state(root, sm=sm)
    monkeypatch.undo()
    rec = recover(root, device="cpu")
    assert rec.seq == 1
    rec.deltacr.shutdown()

    # crash 2: blob landed but the manifest append never happened
    real_append = persist_mod._append_manifest

    def append_boom(*a, **k):
        raise OSError("simulated crash before manifest commit")

    monkeypatch.setattr(persist_mod, "_append_manifest", append_boom)
    with pytest.raises(OSError):
        save_state(root, sm=sm)
    monkeypatch.setattr(persist_mod, "_append_manifest", real_append)
    rec = recover(root, device="cpu")
    assert rec.seq == 1                          # uncommitted blob is invisible
    # and a later *successful* save commits normally on top
    assert save_state(root, sm=sm) > 1
    rec2 = recover(root, device="cpu")
    assert rec2.seq > 1
    cr.shutdown()
    rec.deltacr.shutdown()
    rec2.deltacr.shutdown()


def test_inflight_dump_cleanly_absent(tmp_path):
    """A node whose dump has not landed at save time is transactionally
    absent: the snapshot holds the last durable tree, nothing partial."""
    sm, fs, cr = _mk_sm()
    c1 = sm.checkpoint()
    cr.wait_dumps()
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 5.0))
    c2 = sm.checkpoint()                         # dump stalled in the FIFO
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    gate.set()
    cr.wait_dumps()
    rec = recover(root, device="cpu")
    sm2 = rec.state_manager
    assert c1 in sm2.nodes
    assert c2 not in sm2.nodes                   # cleanly absent, not partial
    assert rec.current == c1                     # walked up to durable ground
    sm2.restore(c1)
    cr.shutdown()
    rec.deltacr.shutdown()


def test_recover_empty_root_raises(tmp_path):
    with pytest.raises(RecoverError):
        recover(str(tmp_path / "nothing"), device="cpu")


@settings(max_examples=5, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=2**16),
    n_ckpts=st.integers(min_value=1, max_value=4),
    dirty_elems=st.integers(min_value=1, max_value=512),
)
def test_save_recover_resave_byte_equality(seed, n_ckpts, dirty_elems):
    """Property: save → recover → re-save produces a byte-identical
    snapshot blob (the canonical form is a fixed point of recovery)."""
    sm, fs, cr = _mk_sm(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(n_ckpts):
        sm.sandbox.proc.mutate(
            "heap", lambda h: h.__setitem__(slice(0, dirty_elems), rng.random())
        )
        fs.write("repo/a", rng.integers(0, 255, 2048).astype(np.uint8))
        sm.checkpoint()
    cr.wait_dumps()
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        save_state(d1, sm=sm)
        e1 = _read_manifest(d1)[-1]
        with open(os.path.join(d1, e1["file"]), "rb") as f:
            bytes1 = f.read()
        rec = recover(d1, device="cpu")
        save_state(d2, sm=rec.state_manager)
        e2 = _read_manifest(d2)[-1]
        with open(os.path.join(d2, e2["file"]), "rb") as f:
            bytes2 = f.read()
        rec.deltacr.shutdown()
    cr.shutdown()
    assert bytes1 == bytes2


def test_persistence_plane_wrapper(tmp_path):
    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    # full_every=1: every save is a self-standing full anchor, so retention
    # reduces to the v1 contract — exactly keep_snapshots snap docs on disk
    plane = PersistencePlane(str(tmp_path / "p"), keep_snapshots=2, full_every=1)
    assert plane.last_seq() is None
    s1 = plane.save(sm=sm)
    s2 = plane.save(sm=sm)
    s3 = plane.save(sm=sm)
    assert (s1, s2, s3) == (1, 2, 3)
    assert plane.last_seq() == 3
    # pruning keeps the newest keep_snapshots blobs only
    blobs = sorted(p for p in os.listdir(plane.root) if p.startswith("snap-"))
    assert len(blobs) == 2
    rec = plane.recover(device="cpu")
    assert rec.seq == 3
    cr.shutdown()
    rec.deltacr.shutdown()


def test_persistence_plane_delta_chain_retention(tmp_path):
    """With delta docs on, retention keeps the newest heads plus whatever
    their chains fold from — and nothing older."""
    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    plane = PersistencePlane(str(tmp_path / "p"), keep_snapshots=2, full_every=4)
    for _ in range(6):
        plane.save(sm=sm)
    assert plane.last_save_stats["kind"] == "delta"
    blobs = sorted(p for p in os.listdir(plane.root) if p.startswith("snap-"))
    # seq 5 is the second full anchor (chain of 4 exhausted at seq 4);
    # retained: heads {5, 6} + base closure {5} = exactly 2 docs
    assert blobs == ["snap-00000005.dbox", "snap-00000006.dbox"]
    rec = plane.recover(device="cpu")
    assert rec.seq == 6
    cr.shutdown()
    rec.deltacr.shutdown()


def test_current_walks_past_inflight_and_tombstones(tmp_path):
    """If current sits on a non-durable node whose ancestor is a reclaimed
    tombstone, the snapshot's current walks to the nearest *restorable*
    ancestor — recover's trunk auto-restore always lands."""
    sm, fs, cr = _mk_sm()
    c1 = sm.checkpoint()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 1.0))
    c2 = sm.checkpoint()
    cr.wait_dumps()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(1, 2.0))
    gate = threading.Event()
    cr._dump_executor.submit(gate.wait)
    c3 = sm.checkpoint()                 # current; dump in flight
    sm.reclaim(c2)                       # parent becomes a tombstone
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    gate.set()
    cr.wait_dumps()
    rec = recover(root, device="cpu")
    assert rec.current == c1             # walked past c3 (absent) AND c2 (tombstone)
    # no hand-rolled restore: recover already rolled the trunk onto current
    assert rec.trunk_restore_mode in ("fast", "slow")
    assert rec.state_manager.current == c1
    heap = rec.state_manager.sandbox.proc.get("heap")
    assert heap[0] != 1.0 and heap[1] != 2.0   # pre-c2/c3 state, live now
    cr.shutdown()
    rec.deltacr.shutdown()


def test_auto_restore_modes(tmp_path):
    """Trunk auto-restore: a plain current restores live; a current atop an
    LW replay chain is skipped without an applier, replayed with one; and
    auto_restore=False preserves the old inert-proc behavior."""
    sm, fs, cr = _mk_sm()
    c1, c2, c3, c4 = _grow_tree(sm, fs, cr)
    sm.restore(c3)                       # park current on the LW marker
    root = str(tmp_path / "state")
    save_state(root, sm=sm)

    rec = recover(root, device="cpu")                  # LW chain, no applier → skipped
    assert rec.current == c3
    assert rec.trunk_restore_mode == "skipped-needs-applier"
    rec.deltacr.shutdown()

    applier = lambda sb, a: sb.proc.mutate("regs", lambda r: r.__setitem__(a, -1.0))
    rec2 = recover(root, action_applier=applier, device="cpu")
    assert rec2.trunk_restore_mode.endswith("+replay")
    assert rec2.state_manager.current == c3
    assert rec2.state_manager.sandbox.proc.get("regs")[1] == -1.0
    # the applier stays wired: later manual restores replay too
    assert rec2.state_manager.restore(c3).endswith("+replay")
    rec2.deltacr.shutdown()

    rec3 = recover(root, auto_restore=False, device="cpu")
    assert rec3.trunk_restore_mode == "disabled"
    rec3.deltacr.shutdown()
    cr.shutdown()


def test_recovered_pins_are_releasable(tmp_path):
    """Pins recover with the tree (they describe the pre-crash fork bases)
    but are process-local: release_recovered_pins makes the nodes
    reclaimable again instead of orphaning them forever."""
    from repro_torch.core import SandboxTree, reachability_gc

    sm, fs, cr = _mk_sm()
    c1 = sm.checkpoint()
    cr.wait_dumps()
    tree = SandboxTree(sm)
    tree.fork(c1, 2)                     # two live children pin c1
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    rec = recover(root, device="cpu")
    sm2 = rec.state_manager
    assert rec.recovered_pins == {c1: 2}
    assert sm2.pinned_ckpts() == frozenset({c1})
    # the pre-crash children are gone: a caller not re-attaching forks
    # releases the pins and GC can reclaim again
    assert sm2.release_recovered_pins() == {c1: 2}
    sm2.node(c1).terminal = True
    sm2.node(c1).expandable = False
    sm2.restore(c1)                      # current must move off c1? no: current IS c1
    sm2._current = None                  # detach so GC may take it
    assert c1 in reachability_gc(sm2, keep_terminal_candidates=False)
    tree.release_all()
    cr.shutdown()
    rec.deltacr.shutdown()


def test_save_after_torn_manifest_tail_is_durable(tmp_path):
    """A crash mid-append can leave a newline-less manifest tail; the next
    save must not merge its record into the torn line — the new snapshot
    has to be recoverable (durability as reported)."""
    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    root = str(tmp_path / "state")
    save_state(root, sm=sm)
    save_state(root, sm=sm)
    # tear the tail: strip the trailing newline + a chunk of the last record
    mpath = os.path.join(root, "MANIFEST")
    with open(mpath, "rb") as f:
        raw = f.read()
    with open(mpath, "wb") as f:
        f.write(raw[: len(raw) - 9])
    # post-crash process saves again: this commit must be durable
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 77.0))
    c_new = sm.checkpoint()
    cr.wait_dumps()
    seq = save_state(root, sm=sm)
    rec = recover(root, device="cpu")
    assert rec.seq == seq                        # not an older snapshot
    assert c_new in rec.state_manager.nodes
    cr.shutdown()
    rec.deltacr.shutdown()


def test_kill_at_pack_or_index_write_keeps_previous_durable(tmp_path):
    """v2 fault points: a kill while writing the chunk pack or the digest
    index leaves the previous snapshot authoritative (the manifest append
    is the commit point), and the plane heals on the next save."""
    from repro_torch.core import faults
    from repro_torch.core.faults import FaultError

    sm, fs, cr = _mk_sm()
    _grow_tree(sm, fs, cr)
    plane = PersistencePlane(str(tmp_path / "p"), keep_snapshots=4, full_every=4)
    assert plane.save(sm=sm) == 1

    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 41.0))
    sm.checkpoint()
    cr.wait_dumps()
    for point in ("persist.pack_write", "persist.index_write"):
        with faults.inject(faults.FaultPlan().add(point)):
            with pytest.raises(FaultError):
                plane.save(sm=sm)
        assert plane.last_seq() == 1
        rec = recover(plane.root, device="cpu")
        assert rec.seq == 1                      # previous durable snapshot
        rec.deltacr.shutdown()
    seq = plane.save(sm=sm)                      # plane heals: save lands
    assert seq == 2
    rec = recover(plane.root, device="cpu")
    assert rec.seq == 2
    assert rec.state_manager.sandbox.proc.get("heap")[0] == 41.0
    cr.shutdown()
    rec.deltacr.shutdown()
