"""The delta dump path's kernel and tracking details: a paged session's
extras are dirty-tracked key by key, the fused kernel path matches the
unfused one chunk-for-chunk, and faults on the fused path ride the
transactional retry/fallback plane."""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro_torch.core import DeltaCR, DumpPolicy, FaultPlan
from repro_torch.core import faults
from repro_torch.core.delta_pipeline import ChunkedView, DeltaGeneration

CHUNK = 256


def _payload_of(cr, ckpt_id):
    image = cr.dump_future(ckpt_id).result()
    return {
        name: cr.store.get_array(meta.chunk_ids, meta.shape, np.dtype(meta.dtype))
        for name, meta in image.entries.items()
    }, image


# ---------------------------------------------------------------------------
# dirty tracking of a paged session's extras
# ---------------------------------------------------------------------------


def test_paged_session_extras_tracking_key_granular():
    """The tracked extras dict notes every rebind path; delta_generation
    marks only rebound extras dirty (page/key-granular hints for recurrent
    state instead of the old always-dirty blanket)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagePool, PagedSession

    cfg = get_config("olmo-1b-tiny")
    pool = PagePool(cfg, num_pages=8, page_size=4, max_pages_per_session=4, device="cpu")
    sess = PagedSession(pool)
    sess.extras["stage0/mamba"] = {"conv": np.zeros(64, np.float32),
                                   "ssm": np.zeros(32, np.float32)}
    sess.extras["rng_counter"] = np.asarray([0], np.int64)
    sess.reset_dirty_tracking(1)
    gen = sess.delta_generation(256)
    # nothing rebound: meta/* stays dirty (it churns every step), extras not
    assert gen.dirty_keys == frozenset({"meta/seq_len", "meta/tokens"})
    sess.extras["rng_counter"] = np.asarray([1], np.int64)
    gen = sess.delta_generation(256)
    assert "extra/rng_counter" in gen.dirty_keys
    assert not any(k.startswith("extra/stage0/mamba") for k in gen.dirty_keys)
    # nested recurrent state rebinds at its top-level key
    sess.extras["stage0/mamba"] = {"conv": np.ones(64, np.float32),
                                   "ssm": np.zeros(32, np.float32)}
    gen = sess.delta_generation(256)
    assert "extra/stage0/mamba::conv" in gen.dirty_keys
    assert "extra/stage0/mamba::ssm" in gen.dirty_keys
    sess.release()


def test_tracked_extras_covers_every_write_path():
    from repro_torch.configs import get_config
    from repro_torch.serve import PagePool, PagedSession

    cfg = get_config("olmo-1b-tiny")
    pool = PagePool(cfg, num_pages=8, page_size=4, max_pages_per_session=4, device="cpu")
    sess = PagedSession(pool, extras={"a": 1, "b": 2, "c": 3, "d": 4})
    sess.reset_dirty_tracking(1)
    sess.extras["a"] = 10
    sess.extras.update(b=20)
    sess.extras.pop("c")
    sess.extras.setdefault("e", 5)
    del sess.extras["d"]
    assert sess._dirty_extras == {"a", "b", "c", "d", "e"}
    sess.extras.clear()
    assert "e" in sess._dirty_extras
    # fork copies the set; the clone tracks independently
    sess.extras["f"] = 6
    clone = sess.fork()
    clone.extras["g"] = 7
    assert "g" in clone._dirty_extras and "g" not in sess._dirty_extras
    clone.release()
    sess.release()


# ---------------------------------------------------------------------------
# fused vs unfused device path: chunk-for-chunk parity
# ---------------------------------------------------------------------------


class DeviceState:
    """Minimal DeltaEncodable whose grids are *device* (CPU torch) tensors — every
    dirty key routes through the device kernel plan, exercising the fused
    pass exactly like a PagedSession's KV grids do."""

    def __init__(self, arrays):
        self.arrays = {k: np.ascontiguousarray(v, np.uint8) for k, v in arrays.items()}
        self._dirty = None
        self._base = None

    # -- ForkableState
    def fork(self):
        c = DeviceState({k: v.copy() for k, v in self.arrays.items()})
        c._dirty = None if self._dirty is None else set(self._dirty)
        c._base = self._base
        return c

    def release(self):
        pass

    def warm(self):
        pass

    def dump_payload(self):
        return {k: v.copy() for k, v in self.arrays.items()}

    # -- dirty tracking ducks
    def reset_dirty_tracking(self, base_ckpt=None):
        self._dirty, self._base = set(), base_ckpt

    def invalidate_dirty_tracking(self):
        self._dirty, self._base = None, None

    def dirty_tracking_base(self):
        return self._base if self._dirty is not None else None

    def write(self, key, sl, val):
        self.arrays[key][sl] = val
        if self._dirty is not None:
            self._dirty.add(key)

    # -- DeltaEncodable
    def delta_generation(self, chunk_bytes):
        import torch

        views = {}
        for key, arr in self.arrays.items():
            n = -(-arr.nbytes // chunk_bytes)
            pad = n * chunk_bytes - arr.nbytes

            def build(a=arr, n=n, cb=chunk_bytes, pad=pad):
                flat = np.zeros(n * cb, np.uint8)
                flat[: a.nbytes] = a.reshape(-1).view(np.uint8)
                return torch.from_numpy(flat.reshape(n, cb))

            views[key] = ChunkedView(
                shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes,
                chunk_bytes=chunk_bytes, n_chunks=n, trailing_pad=pad,
                grid_fn=build,
            )
        dirty = None if self._dirty is None else frozenset(self._dirty)
        return DeltaGeneration(views=views, extras={}, dirty_keys=dirty)


def _device_restore(payload):
    return DeviceState(payload)


def _run_device_chain(cr, seed=21, steps=4):
    rng = np.random.default_rng(seed)
    s = DeviceState({
        "a": rng.integers(0, 256, 8 * CHUNK, dtype=np.uint8),
        "b": rng.integers(0, 256, 3 * CHUNK, dtype=np.uint8),
    })
    cr.checkpoint(s, 1, None)
    for step in range(2, 2 + steps):
        lo = int(rng.integers(0, 6 * CHUNK))
        s.write("a", slice(lo, lo + 64), step % 251)
        cr.checkpoint(s, step, step - 1)
    cr.wait_dumps()
    return 1 + steps


def test_fused_matches_unfused_chunk_for_chunk():
    cr_f = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK,
                   policy=DumpPolicy(fused_kernel=True))
    cr_u = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK,
                   policy=DumpPolicy(fused_kernel=False))
    try:
        n = _run_device_chain(cr_f)
        _run_device_chain(cr_u)
        for ckpt in range(1, n + 1):
            img_f = cr_f.dump_future(ckpt).result()
            img_u = cr_u.dump_future(ckpt).result()
            assert img_f.mode == img_u.mode == "delta"
            assert sorted(img_f.entries) == sorted(img_u.entries)
            for name, mf in img_f.entries.items():
                mu = img_u.entries[name]
                # chunk-for-chunk: identical layout and identical digests
                assert mf.shape == mu.shape and mf.dtype == mu.dtype
                assert mf.trailing_pad == mu.trailing_pad
                assert mf.digests == mu.digests
            assert img_f.dirtied_chunks == img_u.dirtied_chunks
        assert cr_f.health().get("fused_checksum_mismatches") == 0
    finally:
        cr_f.shutdown()
        cr_u.shutdown()


def test_fused_path_overlap_surface_counts_streamed_dumps():
    """The stream engine's aggregate overlap surface exists and accounts
    streamed fused dumps (the start_host_fetch double-buffer validation
    plane; genuine >1 efficiency needs device DMA, so here we only require
    the accounting to be wired and self-consistent)."""
    from repro_torch.core.stream import StreamConfig

    cr = DeltaCR(
        restore_fn=_device_restore,
        chunk_bytes=CHUNK,
        policy=DumpPolicy(stream_config=StreamConfig(window_bytes=CHUNK, min_windows=2)),
    )
    try:
        rng = np.random.default_rng(31)
        # several keys: windows pack whole tensors, so ≥2 dirty keys are
        # needed to clear StreamConfig.min_windows
        s = DeviceState({
            f"k{i}": rng.integers(0, 256, 8 * CHUNK, dtype=np.uint8)
            for i in range(6)
        })
        cr.checkpoint(s, 1, None)
        for i in range(6):
            s.write(f"k{i}", slice(0, 4 * CHUNK), 7)
        cr.checkpoint(s, 2, 1)
        cr.wait_dumps()
        img2 = cr.dump_future(2).result()
        assert img2.streamed and img2.stream_windows >= 2
        eng = cr.pipeline.stream
        assert eng.dumps_streamed >= 1
        assert eng.overlap_efficiency() > 0.0
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# chaos: faults on the fused path ride the transactional dump plane
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_fused_drain_fault_rides_retry():
    cr = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK)
    ref = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK,
                  policy=DumpPolicy(fused_kernel=False))
    try:
        with faults.inject(FaultPlan().add("kernels.fused", after=2)):
            n = _run_device_chain(cr, seed=41)
        _run_device_chain(ref, seed=41)
        h = cr.health()
        assert h["dump_retries"] >= 1 and h["dump_failures"] == 0
        for ckpt in range(1, n + 1):
            pa, img = _payload_of(cr, ckpt)
            pb, _ = _payload_of(ref, ckpt)
            for name in pa:
                np.testing.assert_array_equal(pa[name], pb[name])
    finally:
        cr.shutdown()
        ref.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_fused_checksum_mismatch_detected_and_recovered(monkeypatch):
    """Tampered DMA bytes (device sums disagree with fetched rows) are
    detected by the host re-checksum; the attempt rolls back and the dump
    degrades to a correct legacy image instead of committing bad bytes."""
    import torch
    from repro_torch.kernels import ops as kops

    real = kops.fused_encode

    def tampered(old, new, max_changed):
        data, idx, count, sums = real(old, new, max_changed)
        # all lanes wrong (torch has no uint32 add on the CPU: add to the words)
        return data, idx, count, sums.view(torch.int32).add(1).view(torch.uint32)

    monkeypatch.setattr(kops, "fused_encode", tampered)
    cr = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK,
                 policy=DumpPolicy(retries=1))
    try:
        n = _run_device_chain(cr, seed=51)
        h = cr.health()
        assert h["fused_checksum_mismatches"] >= 1
        assert h["fallback_dumps"] >= 1 and h["dump_failures"] == 0
        monkeypatch.setattr(kops, "fused_encode", real)
        ref = DeltaCR(restore_fn=_device_restore, chunk_bytes=CHUNK)
        try:
            _run_device_chain(ref, seed=51)
            for ckpt in range(1, n + 1):
                pa, img = _payload_of(cr, ckpt)
                pb, _ = _payload_of(ref, ckpt)
                for name in pa:
                    np.testing.assert_array_equal(pa[name], pb[name])
        finally:
            ref.shutdown()
    finally:
        cr.shutdown()
