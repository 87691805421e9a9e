"""Delta dump pipeline: parity with legacy images, capacity overflow,
dirty-key metadata reuse, pad round-trips, digest dedupe under FORCE_REF,
and transient-checkpoint dirty-tracking safety."""
import pytest

pytest.importorskip("torch")

import os

import numpy as np

from repro_torch.core import (
    ChunkStore,
    CowArrayState,
    DeltaCR,
    DeltaDumpPipeline,
    DeltaFS,
    Sandbox,
    StateManager,
)
from repro_torch.core.chunk_store import chunk_digest, iter_chunk_views
from repro_torch.core.delta_pipeline import ChunkedView, digest_encode_array


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _mk_state(seed=0, n_keys=6, n=4096, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return CowArrayState(
        {f"k{i}": rng.standard_normal(n).astype(dtype) for i in range(n_keys)}
    )


def _payload_of(cr, ckpt_id):
    image = cr.dump_future(ckpt_id).result()
    return {
        name: cr.store.get_array(meta.chunk_ids, meta.shape, np.dtype(meta.dtype))
        for name, meta in image.entries.items()
    }, image


# ---------------------------------------------------------------------------
# pad accounting
# ---------------------------------------------------------------------------


def test_put_bytes_records_trailing_pad():
    cs = ChunkStore(chunk_bytes=64)
    raw = bytes(range(100))                       # 64 + 36: final pad 28
    ids = cs.put_bytes(raw)
    assert len(ids) == 2
    assert cs.pad_of(ids[0]) == 0
    assert cs.pad_of(ids[1]) == 28
    assert len(cs.get(ids[1])) == 64              # stored zero-padded
    assert cs.get_bytes(ids) == raw               # pad stripped on read


def test_pad_distinguishes_dedupe():
    """Same padded bytes, different logical length → distinct chunks."""
    cs = ChunkStore(chunk_bytes=16)
    a = cs.put(b"ab" + bytes(14), pad=14)
    b = cs.put(b"ab" + bytes(14), pad=12)
    assert a != b
    c = cs.put(b"ab" + bytes(14), pad=14)         # exact match dedupes
    assert c == a


def test_odd_sized_array_roundtrip_through_dump():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=64)
    arr = np.arange(37, dtype=np.int8)            # 37 bytes: single padded chunk
    big = np.arange(1000, dtype=np.int64)         # 8000 bytes: 125 chunks exact
    odd = np.arange(333, dtype=np.float32)        # 1332 bytes: pad 48
    s = CowArrayState({"a": arr, "b": big, "c": odd})
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    payload, image = _payload_of(cr, 1)
    np.testing.assert_array_equal(payload["a"], arr)
    np.testing.assert_array_equal(payload["b"], big)
    np.testing.assert_array_equal(payload["c"], odd)
    assert image.entries["c"].trailing_pad == 64 - (1332 % 64)
    cr.shutdown()


def test_chunk_digest_matches_padded_row():
    piece = b"xyz" * 5
    pad = 64 - len(piece)
    assert chunk_digest(piece, pad) == chunk_digest(piece + bytes(pad), 0)
    views = list(iter_chunk_views(piece, 64))
    assert views == [(memoryview(piece), pad)] or views[0][1] == pad


# ---------------------------------------------------------------------------
# parity: delta pipeline vs legacy full-serialize images
# ---------------------------------------------------------------------------


def _run_workload(cr, seed=3):
    rng = np.random.default_rng(seed)
    s = _mk_state(seed=1)
    cr.checkpoint(s, 1, None)
    for step in range(2, 7):
        key = f"k{int(rng.integers(6))}"
        lo = int(rng.integers(0, 4000))
        s.mutate(key, lambda a, lo=lo: a.__setitem__(slice(lo, lo + 16), float(step)))
        if step % 3 == 0:  # occasionally add a new tensor (shape change class)
            s.set(f"new{step}", rng.standard_normal(100).astype(np.float32))
        cr.checkpoint(s, step, step - 1)
    cr.wait_dumps()
    return s


def test_pipeline_images_bit_identical_to_legacy():
    cr_new = DeltaCR(restore_fn=_restore, chunk_bytes=1024, dump_mode="auto")
    cr_old = DeltaCR(restore_fn=_restore, chunk_bytes=1024, dump_mode="legacy")
    _run_workload(cr_new)
    _run_workload(cr_old)
    for ckpt in range(1, 7):
        pl_new, img_new = _payload_of(cr_new, ckpt)
        pl_old, img_old = _payload_of(cr_old, ckpt)
        assert img_new.mode == "delta" and img_old.mode == "legacy"
        assert sorted(pl_new) == sorted(pl_old)
        for name in pl_new:
            np.testing.assert_array_equal(pl_new[name], pl_old[name])
    cr_new.shutdown()
    cr_old.shutdown()


def test_pipeline_restore_matches_live_state():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=1024, template_pool_size=1)
    s = _run_workload(cr, seed=9)
    # pool=1 → every earlier checkpoint restores via the slow (image) path
    want = {k: s.get(k).copy() for k in s.keys()}
    restored, path = cr.restore(6)
    for k in want:
        np.testing.assert_array_equal(restored.get(k), want[k])
    # walk back through the chain: every image decodes exactly
    for ckpt in (5, 3, 1):
        r, path = cr.restore(ckpt)
        pl, _ = _payload_of(cr, ckpt)
        for k in pl:
            np.testing.assert_array_equal(r.get(k), pl[k])
    cr.shutdown()


# ---------------------------------------------------------------------------
# dirty-ratio sweep through capacity overflow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dirty_chunks", [0, 1, 8, 16, 32])
def test_dirty_ratio_sweep_and_overflow(dirty_chunks):
    n_chunks, cb = 32, 256
    cr = DeltaCR(
        restore_fn=_restore,
        chunk_bytes=cb,
        capacity_frac=0.25,              # capacity 8 → 16/32 overflow to full
        template_pool_size=1,
    )
    base = np.zeros(n_chunks * cb, np.uint8)
    s = CowArrayState({"x": base.copy()})
    cr.checkpoint(s, 1, None)
    s.mutate(
        "x",
        lambda a: [
            a.__setitem__(slice(i * cb, i * cb + 4), 255) for i in range(dirty_chunks)
        ],
    )
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    img = cr.dump_future(2).result()
    assert img.dirtied_chunks == dirty_chunks
    # under capacity → kernel path; over → full fallback; both exact:
    restored, path = cr.restore(1)
    np.testing.assert_array_equal(restored.get("x"), base)
    want = s.get("x").copy()
    restored2, _ = cr.restore(2)
    np.testing.assert_array_equal(restored2.get("x"), want)
    if dirty_chunks <= 8:
        assert cr.stats.kernel_keys >= 1
    cr.shutdown()


def test_kernel_branch_capacity_overflow_falls_back_to_full():
    """Device-backed grids go through kernels.delta_encode with a fixed
    capacity; more dirty chunks than capacity must fall back to the full
    chunk set without corruption.  (Host numpy grids compute the exact set
    and never overflow — this pins the kernel branch.)"""
    import jax.numpy as jnp

    from repro_torch.core.delta_pipeline import DeltaDumpPipeline

    n, cb = 16, 256
    store = ChunkStore(chunk_bytes=cb)
    pipe = DeltaDumpPipeline(store, capacity_frac=0.25)  # capacity 4

    def dev_view(arr):
        grid = jnp.asarray(arr.reshape(n, cb))
        return ChunkedView(
            shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes,
            chunk_bytes=cb, n_chunks=n, trailing_pad=0, grid_fn=lambda g=grid: g,
        )

    from repro_torch.core.delta_pipeline import DeltaGeneration

    base = np.zeros(n * cb, np.uint8)
    res1 = pipe.encode_generation(DeltaGeneration(views={"x": dev_view(base)}), None)

    class _Img:  # minimal DumpImage stand-in
        image_id = 1
        entries = res1.entries

    pipe.register(1, {"x": dev_view(base)}, anchor=None)
    changed = base.copy()
    changed[: 10 * cb] = 7                        # 10 dirty > capacity 4
    res2 = pipe.encode_generation(DeltaGeneration(views={"x": dev_view(changed)}), _Img)
    assert res2.full_keys == 1 and res2.kernel_keys == 0
    assert res2.dirtied == 10
    got = store.get_array(res2.entries["x"].chunk_ids, changed.shape, np.uint8)
    np.testing.assert_array_equal(got, changed)


def test_clean_keys_never_materialize_bytes():
    """Untouched tensors are re-referenced at the metadata level: zero new
    physical bytes, zero puts."""
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=1024)
    s = _mk_state(seed=4, n_keys=8)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    puts_before = cr.store.stats.puts
    bytes_before = cr.store.stats.bytes_written
    cr.checkpoint(s, 2, 1)                        # nothing dirty
    cr.wait_dumps()
    img = cr.dump_future(2).result()
    assert img.dirtied_chunks == 0
    assert cr.store.stats.puts == puts_before
    assert cr.store.stats.bytes_written == bytes_before
    assert cr.stats.clean_keys >= 8
    cr.shutdown()


# ---------------------------------------------------------------------------
# digest dedupe under REPRO_FORCE_REF=1
# ---------------------------------------------------------------------------


def test_force_ref_digest_dedupe(monkeypatch):
    """With Pallas bypassed entirely, two independent dumps of identical
    content collapse to shared chunks (digest dedupe), and restores stay
    collision-free exact."""
    monkeypatch.setenv("REPRO_FORCE_REF", "1")
    # unusual shape → fresh jit trace that observes the env var
    n, cb = 23, 192
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=cb, template_pool_size=1)
    content = np.arange(n * cb, dtype=np.uint8)
    a = CowArrayState({"x": content.copy()})
    b = CowArrayState({"x": content.copy()})
    cr.checkpoint(a, 1, None)
    cr.wait_dumps()
    physical_after_first = cr.store.stats.physical_bytes
    cr.checkpoint(b, 2, None)                     # separate chain, same bytes
    cr.wait_dumps()
    assert cr.store.stats.physical_bytes == physical_after_first  # all dedupe
    assert cr.store.stats.dedup_hits >= n
    r1, _ = cr.restore(1)
    r2, _ = cr.restore(2)
    np.testing.assert_array_equal(r1.get("x"), content)
    np.testing.assert_array_equal(r2.get("x"), content)
    cr.shutdown()


# ---------------------------------------------------------------------------
# dirty-tracking safety
# ---------------------------------------------------------------------------


def test_transient_checkpoint_invalidates_dirty_tracking():
    """isolated_eval drops its transient node; the session then descends
    from a checkpoint that is NOT the next dump's parent — the dump must
    still capture mutations made before the transient fork."""
    fs = DeltaFS(chunk_bytes=256)
    proc = CowArrayState({"heap": np.zeros(1024, np.float32)})
    cr = DeltaCR(store=fs.store, restore_fn=_restore, chunk_bytes=256)
    sm = StateManager(Sandbox(fs, proc), cr)
    c1 = sm.checkpoint()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 1.0))

    def eval_fn(sb):
        sb.proc.mutate("heap", lambda h: h.__setitem__(1, 99.0))
        return 1.0

    sm.isolated_eval(eval_fn)
    # post-eval: heap[0]==1 must survive into the next durable checkpoint
    c2 = sm.checkpoint()
    cr.wait_dumps()
    restored, _ = cr.restore(c2)
    assert restored.get("heap")[0] == 1.0
    assert restored.get("heap")[1] == 0.0         # eval side effect rolled back
    # slow-path must agree with the template content
    cr.evict_template(c2)
    slow, path = cr.restore(c2)
    assert path == "slow"
    np.testing.assert_array_equal(slow.get("heap"), restored.get("heap"))
    cr.shutdown()


def test_branch_checkpoint_ignores_stale_dirty_hint():
    """A branch dump whose parent differs from the session's tracking base
    must not trust the dirty-key hint (regression: clean keys wrongly
    re-referenced the branch parent's chunks)."""
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=1024, template_pool_size=1)
    s = CowArrayState({"k": np.zeros(4096, np.float32)})
    cr.checkpoint(s, 1, None)
    s.mutate("k", lambda a: a.__setitem__(slice(0, 8), 7.0))
    cr.checkpoint(s, 2, 1)
    cr.checkpoint(s, 3, 1)            # branch: parent 1, but hint is vs 2
    cr.wait_dumps()
    payload, _ = _payload_of(cr, 3)
    assert payload["k"][0] == 7.0     # ckpt-3 content, not ckpt-1's zeros
    cr.evict_template(3)
    restored, path = cr.restore(3)
    assert path == "slow" and restored.get("k")[0] == 7.0
    cr.shutdown()


def test_restore_then_checkpoint_delta_is_exact():
    """After a restore, dumps delta against the restored checkpoint."""
    fs = DeltaFS(chunk_bytes=512)
    proc = CowArrayState({"a": np.zeros(4096, np.float32), "b": np.ones(4096, np.float32)})
    cr = DeltaCR(store=fs.store, restore_fn=_restore, chunk_bytes=512)
    sm = StateManager(Sandbox(fs, proc), cr)
    c1 = sm.checkpoint()
    sm.sandbox.proc.mutate("a", lambda x: x.__setitem__(slice(0, 4), 5.0))
    c2 = sm.checkpoint()
    sm.restore(c1)
    sm.sandbox.proc.mutate("b", lambda x: x.__setitem__(slice(0, 4), 7.0))
    c3 = sm.checkpoint()
    cr.wait_dumps()
    img3 = cr.dump_future(c3).result()
    # only "b"'s one dirty chunk was written; "a" was metadata-reused
    assert img3.dirtied_chunks == 1
    slow_payload = {
        name: fs.store.get_array(m.chunk_ids, m.shape, np.dtype(m.dtype))
        for name, m in img3.entries.items()
    }
    assert slow_payload["a"][0] == 0.0            # c1's content, not c2's
    assert slow_payload["b"][0] == 7.0
    cr.shutdown()


# ---------------------------------------------------------------------------
# PagedSession device pipeline (no model needed)
# ---------------------------------------------------------------------------


def _tiny_pool():
    from repro_torch.configs import get_config
    from repro_torch.serve import PagePool

    cfg = get_config("olmo-1b-tiny")
    return PagePool(cfg, num_pages=32, page_size=4, max_pages_per_session=8, device="cpu")


def test_paged_session_delta_chain():
    import jax.numpy as jnp
    from repro_torch.serve import PagedSession

    pool = _tiny_pool()
    sess = PagedSession(pool)
    sess.ensure_writable(extra_tokens=8)          # 2 pages
    sess.seq_len = 8
    sess.tokens = [1, 2, 3, 4, 5, 6, 7, 8]
    # write recognizable content into the session's pages
    for pos in range(sess.n_pages):
        page = int(sess.table[pos])
        payload = {}
        for skey, tag in pool.attn_tags:
            shape = pool.pools_k[skey][tag].shape
            val = jnp.full((shape[0], shape[2], shape[3], shape[4]), float(pos + 1))
            payload[f"{skey}/{tag}/k"] = np.asarray(val)
            payload[f"{skey}/{tag}/v"] = np.asarray(-val)
        pool.scatter_page(page, payload)

    cr = DeltaCR(
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        template_pool_size=1,
    )
    cr.checkpoint(sess, 1, None)
    want_page0 = pool.gather_page(int(sess.table[0]))
    # grow by one token: CoW-privatizes the tail page only
    sess.ensure_writable(extra_tokens=1)
    sess.seq_len += 1
    sess.tokens.append(9)
    cr.checkpoint(sess, 2, 1)
    cr.wait_dumps()
    img1 = cr.dump_future(1).result()
    img2 = cr.dump_future(2).result()
    assert img1.mode == "delta" and img2.mode == "delta"
    # page 0 untouched: its chunks are shared between the two images
    for skey, tag in pool.attn_tags:
        m1 = img1.entries[f"kv/{skey}/{tag}/k"]
        m2 = img2.entries[f"kv/{skey}/{tag}/k"]
        assert m2.chunk_ids[0] == m1.chunk_ids[0], "page-0 chunk not shared"
    # slow restore of ckpt 1 reproduces the original page contents
    other = PagedSession(pool)                    # evict ckpt1's template
    cr.checkpoint(other, 99, None)
    restored, path = cr.restore(1)
    assert path == "slow"
    assert restored.tokens == [1, 2, 3, 4, 5, 6, 7, 8]
    got_page0 = pool.gather_page(int(restored.table[0]))
    for k in want_page0:
        np.testing.assert_array_equal(got_page0[k], want_page0[k])
    restored.release()
    sess.release()
    cr.shutdown()


# ---------------------------------------------------------------------------
# unit: digest_encode_array + ChunkedView layout invariants
# ---------------------------------------------------------------------------


def test_digest_encode_array_reuses_parent_chunks():
    cs = ChunkStore(chunk_bytes=128)
    a = np.arange(1024, dtype=np.uint8)
    meta1, d1 = digest_encode_array(cs, a, None)
    assert d1 == 8 and len(meta1.digests) == 8
    b = a.copy()
    b[200] = 0                                    # chunk 1 dirty
    meta2, d2 = digest_encode_array(cs, b, meta1)
    assert d2 == 1
    assert meta2.chunk_ids[0] == meta1.chunk_ids[0]
    assert meta2.chunk_ids[1] != meta1.chunk_ids[1]
    np.testing.assert_array_equal(
        cs.get_array(meta2.chunk_ids, meta2.shape, np.uint8), b
    )


def test_chunked_view_zero_copy_and_pad():
    arr = np.arange(96, dtype=np.float32)         # 384 bytes, cb=256 → pad 128
    v = ChunkedView.from_host_array(arr, 256)
    assert (v.n_chunks, v.trailing_pad) == (2, 128)
    grid = v.grid
    assert grid.shape == (2, 256)
    np.testing.assert_array_equal(
        grid.reshape(-1)[: arr.nbytes], arr.view(np.uint8)
    )
    assert not grid.reshape(-1)[arr.nbytes :].any()
    aligned = np.arange(128, dtype=np.float32)    # 512 bytes: zero-copy path
    v2 = ChunkedView.from_host_array(aligned, 256)
    assert v2.grid.base is not None               # a view, not a copy
