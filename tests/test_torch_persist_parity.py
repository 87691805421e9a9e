"""The persistence format across packages.

One op list (writes, file changes, checkpoints, a branch, a reclaimed node,
a pin and a lightweight checkpoint whose action carries a float32 and a
bfloat16 array) runs on the JAX package (``CowArrayState``) and on the port
(``CowTensorState`` on the CPU, its action as tensors), each saving a v2
root after every step: a full snapshot, then deltas.  Each root is then
recovered by both packages, and the four recoveries must agree exactly on
every image entry's chunk digests, pads and shapes, every layer's entries
and tombstones, the snapshot tree with its pins and ``current``, the
anchored image ids, the replay actions, and the bytes every live node
restores to (which are also the bytes it held before the save).  The roots
themselves are equal file by file: packs and digest index byte for byte,
snapshot docs byte for byte once their timing fields are masked.  A v1 root
of the reference recovers in the port, and ``save_store`` archives load in
the other package.  Digests are blake2b over the bytes, so every comparison
is exact.  Both DeltaCRs run without async warm and land each dump inline,
so both stores see one order of puts.
"""
import hashlib
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.persist as JP
import repro_torch.core as T
import repro_torch.core.persist as TP

torch.set_num_threads(1)

# Fields that hold a clock reading: the dump stage timings of an image, and
# a snapshot node's creation time (time.monotonic).  No other field of a
# snapshot doc may differ between the packages.
TIMING_FIELDS = ("wall_ms", "encode_ms", "drain_ms", "commit_ms")
CLOCK_FIELDS = ("created_at",)


def _host(x):
    if isinstance(x, torch.Tensor):
        return T.deltafs.host_bytes(x)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _dump_inline(cr):
    """Each checkpoint of ``cr`` returns once its dump has landed."""
    checkpoint = cr.checkpoint

    def inline(state, ckpt_id, *args, **kwargs):
        checkpoint(state, ckpt_id, *args, **kwargs)
        fut = cr.dump_future(ckpt_id)
        if fut is not None:
            fut.result()

    cr.checkpoint = inline


def _applier(port):
    """Replay an LW action: its float32 array overwrites the heap's head."""
    def apply(sandbox, action):
        vals = action[0]
        if port:
            vals = torch.as_tensor(np.asarray(vals)) if not isinstance(vals, torch.Tensor) else vals
        sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(0, len(vals)), vals))
    return apply


def _world(port):
    pkg = T if port else J
    fs = pkg.DeltaFS(chunk_bytes=256)
    fs.write("repo/base", np.arange(512, dtype=np.int32))
    heap = {"heap": np.zeros(1024, np.float32), "cursor": np.zeros(4, np.int64)}
    if port:
        proc = T.CowTensorState(heap, device="cpu")
        restore_fn = lambda p: T.CowTensorState(p, device="cpu")  # noqa: E731
    else:
        proc = J.CowArrayState(heap)
        restore_fn = lambda p: J.CowArrayState({k: v.copy() for k, v in p.items()})  # noqa: E731
    cr = pkg.DeltaCR(store=fs.store, restore_fn=restore_fn, template_pool_size=16,
                     async_warm=False)
    _dump_inline(cr)
    sm = pkg.StateManager(pkg.Sandbox(fs, proc), cr)
    sm.action_applier = _applier(port)
    return pkg, sm, fs, cr


def _action(port, rng):
    f32 = rng.standard_normal(48).astype(np.float32)
    words = rng.integers(0, 1 << 16, size=6, dtype=np.uint16)
    if port:
        return (torch.from_numpy(f32), torch.from_numpy(words.view(np.int16)).view(torch.bfloat16))
    return (f32, words.view(ml_dtypes.bfloat16))


def _heap_write(port, sm, lo, vals):
    v = torch.from_numpy(vals) if port else vals
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(lo, lo + len(vals)), v))


def _drive(port, root, seed=0):
    """The op list on one package, a plane save after every step."""
    pkg, sm, fs, cr = _world(port)
    plane = pkg.PersistencePlane(root, keep_snapshots=16, full_every=8)
    rng = np.random.default_rng(seed)
    kinds = []

    def save():
        plane.save(sm=sm)
        kinds.append(plane.last_save_stats["kind"])

    c1 = sm.checkpoint()
    save()
    fs.write("repo/a", rng.integers(0, 1 << 20, size=300).astype(np.int32))
    _heap_write(port, sm, 100, rng.standard_normal(64).astype(np.float32))
    c2 = sm.checkpoint()
    save()
    action = _action(port, rng)
    _applier(port)(sm.sandbox, action)
    c3 = sm.checkpoint(lightweight=True, actions=(action,))
    save()
    sm.restore(c1)                                    # branch off the root
    fs.write("repo/b", rng.integers(0, 1 << 20, size=900).astype(np.int32))
    fs.delete("repo/base")
    _heap_write(port, sm, 600, rng.standard_normal(200).astype(np.float32))
    c4 = sm.checkpoint()
    save()
    fs.write("repo/b", rng.integers(0, 1 << 20, size=900).astype(np.int32))
    c5 = sm.checkpoint()
    sm.reclaim(c4)                                    # a tombstone with a live child
    sm.pin(c2)
    save()
    sm.restore(c3)                                    # replays the LW action
    sm.sandbox.proc.mutate("cursor", lambda c: c.__setitem__(1, 7))
    c6 = sm.checkpoint()
    save()
    assert kinds == ["full"] + ["delta"] * 5
    assert [n.ckpt_id for n in sm.nodes.values()] == [c1, c2, c3, c4, c5, c6]
    live = _restored(sm)
    cr.shutdown()
    return live, sm


def _restored(sm):
    """blake2b of every live node's restored process state and files."""
    out = {}
    for n in list(sm.nodes.values()):
        if n.reclaimed:
            continue
        sm.restore(n.ckpt_id)
        h = hashlib.blake2b(digest_size=16)
        proc, fs = sm.sandbox.proc, sm.sandbox.fs
        for k in sorted(proc.keys()):
            h.update(k.encode() + _host(proc.get(k)).tobytes())
        for k in sorted(fs.keys()):
            h.update(k.encode() + np.ascontiguousarray(fs.read(k)).tobytes())
        out[n.ckpt_id] = h.hexdigest()
    return out


def _meta(m):
    return (tuple(m.shape), m.dtype, tuple(d.hex() for d in m.digests), m.trailing_pad,
            tuple(m.tile_grid))


def _action_bytes(a):
    if isinstance(a, (tuple, list)):
        return tuple(_action_bytes(x) for x in a)
    dt = T.deltafs.dtype_str(a.dtype) if isinstance(a, torch.Tensor) else str(a.dtype)
    return (dt, tuple(a.shape), _host(a).tobytes().hex())


def _summary(rec):
    """What a recovery rebuilt, in package-neutral terms."""
    sm, cr = rec.state_manager, rec.deltacr
    images = {c: (img.image_id, img.parent_id, img.mode, img.dirtied_chunks, img.dump_bytes,
                  {k: _meta(m) for k, m in sorted(img.entries.items())})
              for c, img in cr.images.live_images()}
    nodes = {}
    for n in sm.nodes.values():
        layers = None
        if n.layer_config is not None and not n.reclaimed:
            layers = [({k: _meta(m) for k, m in sorted(rec.layer_store.get(l).entries.items())},
                       sorted(rec.layer_store.get(l).tombstones))
                      for l in n.layer_config]
        nodes[n.ckpt_id] = (n.parent_id, sorted(n.children), n.lightweight, n.reclaimed,
                            n.terminal, n.expandable, n.visits, n.value, layers,
                            _action_bytes(tuple(n.replay_actions)))
    anchors = list(cr.pipeline.anchored_ids())
    return {
        "seq": rec.seq,
        "images": images,
        "nodes": nodes,
        "current": rec.current,
        "pins": rec.recovered_pins,
        "pinned": sorted(sm.pinned_ckpts()),
        "anchors": anchors,
        "next_image_id": cr.images.next_image_id(),
        "restored": _restored(sm),
    }


def _recover(port, root):
    if port:
        return T.recover(root, auto_restore=False, action_applier=_applier(True), device="cpu")
    return J.recover(root, auto_restore=False, action_applier=_applier(False))


def _masked(doc, found):
    """A doc with its clock fields set to None; ``found`` collects which."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in TIMING_FIELDS + CLOCK_FIELDS:
                found.add(k)
                out[k] = None
            else:
                out[k] = _masked(v, found)
        return out
    if isinstance(doc, list):
        return [_masked(v, found) for v in doc]
    return doc


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("parity")
    j_root, t_root = str(base / "reference"), str(base / "port")
    j_live, _ = _drive(False, j_root)
    t_live, _ = _drive(True, t_root)
    assert t_live == j_live
    return j_root, t_root, j_live


@pytest.mark.parametrize("reader", ["reference", "port"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_v2_roots_cross_packages(roots, writer, reader):
    """Every (writer, reader) pair recovers the same state as the
    reference reading its own root, and restores the bytes the writer's
    live nodes held."""
    j_root, t_root, live = roots
    want_rec = _recover(False, j_root)
    want = _summary(want_rec)
    want_rec.deltacr.shutdown()
    rec = _recover(reader == "port", j_root if writer == "reference" else t_root)
    got = _summary(rec)
    rec.deltacr.shutdown()
    assert got == want
    assert got["restored"] == live
    assert got["anchors"] and got["pins"] and got["seq"] == 6
    assert any(n[3] for n in got["nodes"].values())            # the tombstone
    assert any(n[2] and n[9] for n in got["nodes"].values())   # the LW action


def test_roots_are_equal_file_by_file(roots):
    """Packs and the digest index byte for byte; every snapshot doc byte
    for byte once its clock fields are masked; manifests equal but for the
    blake2b of those docs."""
    j_root, t_root, _ = roots
    jf, tf = _files(j_root), _files(t_root)
    assert sorted(jf) == sorted(tf)
    packs = [f for f in jf if f.startswith("chunks" + os.sep)]
    assert any("pack-" in f for f in packs) and os.path.join("chunks", "INDEX") in packs
    for f in packs:
        with open(jf[f], "rb") as a, open(tf[f], "rb") as b:
            assert a.read() == b.read(), f
    found = set()
    snaps = sorted(f for f in jf if f.startswith("snap-"))
    assert len(snaps) == 6
    for f in snaps:
        jd, blob_j = JP._load_snapshot(jf[f])
        td, blob_t = TP._load_snapshot(tf[f])
        assert blob_j == blob_t == b""
        assert JP._canon_json(_masked(jd, found)) == TP._canon_json(_masked(td, found)), f
    # the clock fields are the only ones masked, and they are present
    assert found == set(TIMING_FIELDS + CLOCK_FIELDS)
    jm, tm = JP._read_manifest(j_root), TP._read_manifest(t_root)
    assert [{k: v for k, v in e.items() if k not in ("bytes", "blake2b")} for e in jm] == \
        [{k: v for k, v in e.items() if k not in ("bytes", "blake2b")} for e in tm]


def test_reference_v1_root_recovers_in_the_port(tmp_path, roots):
    """A legacy self-contained v1 snapshot of the reference recovers in the
    port to the state the reference recovers from it."""
    _, _, live = roots
    pkg, sm, fs, cr = _world(False)
    root = str(tmp_path / "v1")
    rng = np.random.default_rng(3)
    c1 = sm.checkpoint()
    _heap_write(False, sm, 10, rng.standard_normal(100).astype(np.float32))
    fs.write("repo/a", rng.integers(0, 1 << 20, size=300).astype(np.int32))
    action = _action(False, rng)
    _applier(False)(sm.sandbox, action)
    sm.checkpoint(lightweight=True, actions=(action,))
    sm.restore(c1)
    fs.write("repo/b", rng.integers(0, 1 << 20, size=90).astype(np.int32))
    sm.checkpoint()
    J.save_state(root, sm=sm, fmt=1)
    assert JP._read_manifest(root)[-1].get("fmt", 1) == 1
    want_live = _restored(sm)
    cr.shutdown()
    want_rec = _recover(False, root)
    want = _summary(want_rec)
    want_rec.deltacr.shutdown()
    rec = _recover(True, root)
    got = _summary(rec)
    rec.deltacr.shutdown()
    assert got == want
    assert got["restored"] == want_live


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_save_store_archives_cross_packages(tmp_path, writer):
    """A ``save_store`` archive of either package loads in the other with
    every generation's files, and both packages write the same archive
    contents for the same generations."""
    worlds = {}
    for name, pkg in (("reference", J), ("port", T)):
        fs = pkg.DeltaFS(chunk_bytes=64)
        rng = np.random.default_rng(5)
        fs.write("a", rng.integers(0, 255, size=512).astype(np.uint8))
        fs.write("b", rng.standard_normal(100).astype(np.float32))
        c1 = fs.checkpoint()
        mod = fs.read("a").copy()
        mod[:8] = 0
        fs.write("a", mod)
        fs.delete("b")
        c2 = fs.checkpoint()
        path = str(tmp_path / f"{name}.npz")
        worlds[name] = (pkg.save_store(fs, {"c1": c1, "c2": c2}, path), path, fs, {"c1": c1, "c2": c2})
    n_j, j_path, j_fs, j_cfgs = worlds["reference"]
    n_t, t_path, t_fs, t_cfgs = worlds["port"]
    assert n_j == n_t
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    src_fs, src_cfgs, path = (j_fs, j_cfgs, j_path) if writer == "reference" else (t_fs, t_cfgs, t_path)
    loader = T if writer == "reference" else J
    fs2, configs = loader.load_store(path)
    assert sorted(configs) == ["c1", "c2"]
    for name in ("c1", "c2"):
        src_fs.switch(src_cfgs[name])
        fs2.switch(configs[name])
        assert sorted(fs2.keys()) == sorted(src_fs.keys())
        for k in src_fs.keys():
            assert np.asarray(fs2.read(k)).tobytes() == np.asarray(src_fs.read(k)).tobytes()
            assert fs2.read(k).dtype == src_fs.read(k).dtype
    fs2.debug_validate()


def test_torch_tensors_encode_as_numpy_records():
    """A tensor in a replay action or extra is the ``__nd__`` record of the
    numpy array with its bytes, bfloat16 named as ``ml_dtypes`` names it,
    and each package decodes the other's record to the same bytes."""
    rng = np.random.default_rng(9)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    words = rng.integers(0, 1 << 16, size=(2, 4), dtype=np.uint16)
    obj = {"f": (torch.from_numpy(f32), 3), "b": [torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)],
           "i": torch.arange(4, dtype=torch.int64), "raw": b"\x00\x01"}
    ref = {"f": (f32, 3), "b": [words.view(ml_dtypes.bfloat16)], "i": np.arange(4, dtype=np.int64),
           "raw": b"\x00\x01"}
    enc = TP._encode_obj(obj)
    assert TP._canon_json(enc) == JP._canon_json(JP._encode_obj(ref))
    back = TP._decode_obj(json.loads(TP._canon_json(enc)))
    assert back["b"][0].dtype == torch.bfloat16
    assert _action_bytes(back["b"][0]) == _action_bytes(JP._decode_obj(enc)["b"][0])
    assert back["f"][1] == 3 and back["raw"] == b"\x00\x01"
    np.testing.assert_array_equal(back["f"][0], f32)
    np.testing.assert_array_equal(back["i"], np.arange(4))
