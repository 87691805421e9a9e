"""Adaptive dump-mode engine: auto's per-dump selection is bit-identical to
every forced mode, the fused kernel path matches the unfused one
chunk-for-chunk, prediction telemetry lands on images/health, and faults on
the fused path ride the transactional retry/fallback plane."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core import (
    CowArrayState,
    DeltaCR,
    DumpPolicy,
    FaultPlan,
    dirty_fraction_hint,
)
from repro_torch.core import faults
from repro_torch.core.delta_pipeline import ChunkedView, DeltaGeneration

CHUNK = 256


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def _payload_of(cr, ckpt_id):
    image = cr.dump_future(ckpt_id).result()
    return {
        name: cr.store.get_array(meta.chunk_ids, meta.shape, np.dtype(meta.dtype))
        for name, meta in image.entries.items()
    }, image


def _mk_state(seed, n_keys=3, n=2048):
    rng = np.random.default_rng(seed)
    return CowArrayState(
        {f"k{i}": rng.standard_normal(n).astype(np.float32) for i in range(n_keys)}
    )


def _run_chain(cr, seed, dirty_frac, steps=4):
    """Checkpoint chain with a controlled per-step dirty fraction."""
    rng = np.random.default_rng(seed)
    s = _mk_state(seed)
    cr.checkpoint(s, 1, None)
    for step in range(2, 2 + steps):
        for key in list(s.keys()):
            if rng.random() < dirty_frac:
                lo = int(rng.integers(0, 1024))
                s.mutate(key, lambda a, lo=lo, v=float(step): a.__setitem__(
                    slice(lo, lo + 64), v))
        cr.checkpoint(s, step, step - 1)
    cr.wait_dumps()
    return 1 + steps


# ---------------------------------------------------------------------------
# tentpole property: auto is bit-identical to every forced mode
# ---------------------------------------------------------------------------


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000), st.floats(0.0, 1.0))
def test_auto_bit_identical_to_every_forced_mode(seed, dirty_frac):
    crs = {
        mode: DeltaCR(restore_fn=_restore, chunk_bytes=CHUNK,
                      policy=DumpPolicy(mode=mode))
        for mode in ("auto", "delta", "digest", "legacy")
    }
    try:
        last = {m: _run_chain(cr, seed, dirty_frac) for m, cr in crs.items()}
        n_ckpts = last["auto"]
        for ckpt in range(1, n_ckpts + 1):
            ref_payload, _ = _payload_of(crs["legacy"], ckpt)
            for mode in ("auto", "delta", "digest"):
                payload, img = _payload_of(crs[mode], ckpt)
                assert sorted(payload) == sorted(ref_payload)
                for name in payload:
                    np.testing.assert_array_equal(payload[name], ref_payload[name])
    finally:
        for cr in crs.values():
            cr.shutdown()


def test_auto_flips_to_copy_once_calibrated():
    """At a measured ~100% dirty fraction the selector flips later dumps to
    the straight-copy path; images stay bit-identical to forced delta."""
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=CHUNK)
    ref = DeltaCR(restore_fn=_restore, chunk_bytes=CHUNK,
                  policy=DumpPolicy(mode="delta"))
    try:
        for c in (cr, ref):
            rng = np.random.default_rng(5)
            s = _mk_state(5)
            c.checkpoint(s, 1, None)
            for step in range(2, 6):
                for key in list(s.keys()):       # every chunk of every key
                    s.mutate(key, lambda a, v=float(step): a.__setitem__(
                        slice(None), a[:] + v))
                c.checkpoint(s, step, step - 1)
            c.wait_dumps()
        modes = [cr.dump_future(c).result().mode for c in range(1, 6)]
        assert modes[0] == "delta"               # parent-less: no prediction
        assert modes[1] == "delta"               # uncalibrated: default holds
        assert "copy" in modes[2:]               # calibrated 1.0 → crossover
        for ckpt in range(1, 6):
            pa, _ = _payload_of(cr, ckpt)
            pb, _ = _payload_of(ref, ckpt)
            for name in pa:
                np.testing.assert_array_equal(pa[name], pb[name])
        # observability: the flip is visible end to end
        h = cr.health()
        assert h["mode_histogram"].get("copy", 0) >= 1
        assert h["mode_histogram"].get("delta", 0) >= 2
        assert h["dirty_pred_samples"] >= 1
        assert h["dirty_pred_mae"] is not None and h["dirty_pred_mae"] < 0.2
        assert h["selector"]["hint_ratio_ewma"] == pytest.approx(1.0, abs=0.05)
    finally:
        cr.shutdown()
        ref.shutdown()


def test_low_dirty_fraction_stays_on_delta():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=CHUNK)
    try:
        rng = np.random.default_rng(11)
        s = _mk_state(11, n_keys=6, n=4096)
        cr.checkpoint(s, 1, None)
        for step in range(2, 7):                  # one slice of one key/step
            key = f"k{int(rng.integers(6))}"
            s.mutate(key, lambda a, v=float(step): a.__setitem__(slice(0, 32), v))
            cr.checkpoint(s, step, step - 1)
        cr.wait_dumps()
        for ckpt in range(2, 7):
            img = cr.dump_future(ckpt).result()
            assert img.mode == "delta"
            assert img.actual_dirty_frac is not None and img.actual_dirty_frac < 0.3
    finally:
        cr.shutdown()


def test_prediction_telemetry_on_images():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=CHUNK)
    try:
        s = _mk_state(3)
        cr.checkpoint(s, 1, None)
        s.mutate("k0", lambda a: a.__setitem__(slice(0, 64), 9.0))
        cr.checkpoint(s, 2, 1)
        s.mutate("k1", lambda a: a.__setitem__(slice(0, 64), 8.0))
        cr.checkpoint(s, 3, 2)
        cr.wait_dumps()
        img1 = cr.dump_future(1).result()
        assert img1.predicted_dirty_frac is None     # parent-less
        assert img1.actual_dirty_frac is None
        img3 = cr.dump_future(3).result()
        assert img3.actual_dirty_frac is not None and 0 < img3.actual_dirty_frac < 1
        assert img3.predicted_dirty_frac is not None  # ckpt2 calibrated the ratio
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# dirty-fraction hints
# ---------------------------------------------------------------------------


def test_cow_state_hint_is_byte_weighted():
    s = CowArrayState({
        "big": np.zeros(3 * CHUNK, np.uint8),     # 768 bytes
        "small": np.zeros(CHUNK, np.uint8),       # 256 bytes
    })
    assert dirty_fraction_hint(s) is None         # tracking not started
    s.reset_dirty_tracking(1)
    assert dirty_fraction_hint(s) == 0.0
    s.mutate("small", lambda a: a.__setitem__(0, 1))
    assert dirty_fraction_hint(s) == pytest.approx(0.25)
    s.mutate("big", lambda a: a.__setitem__(0, 1))
    assert dirty_fraction_hint(s) == pytest.approx(1.0)
    s.invalidate_dirty_tracking()
    assert dirty_fraction_hint(s) is None


def test_paged_session_hint_counts_active_dirty_pages():
    from repro_torch.configs import get_config
    from repro_torch.serve import PagePool, PagedSession

    cfg = get_config("olmo-1b-tiny")
    pool = PagePool(cfg, num_pages=32, page_size=4, max_pages_per_session=8, device="cpu")
    sess = PagedSession(pool)
    sess.ensure_writable(extra_tokens=8)          # 2 pages
    sess.seq_len = 8
    assert sess.dirty_fraction_hint() is None     # tracking not started
    sess.reset_dirty_tracking(1)
    assert sess.dirty_fraction_hint() == 0.0
    sess.ensure_writable(extra_tokens=1)          # tail page CoW → dirty
    sess.seq_len += 1
    hint = sess.dirty_fraction_hint()
    assert hint is not None and 0.0 < hint <= 1.0
    sess.release()


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


def test_recurrent_only_session_hint_reflects_extras_churn():
    """Zero attention pages must not pin the hint to 0.0 — recurrent-only
    sessions (mamba/xlstm) carry all their state in extras."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagePool, PagedSession

    cfg = get_config("olmo-1b-tiny")
    pool = PagePool(cfg, num_pages=8, page_size=4, max_pages_per_session=4, device="cpu")
    sess = PagedSession(pool)
    sess.extras["stage0/mamba"] = {"conv": np.zeros(256, np.float32)}
    sess.extras["seed"] = np.asarray([1], np.int64)
    sess.reset_dirty_tracking(1)
    assert sess.n_pages == 0
    assert sess.dirty_fraction_hint() == 0.0
    sess.extras["stage0/mamba"] = {"conv": np.ones(256, np.float32)}
    hint = sess.dirty_fraction_hint()
    assert hint == pytest.approx(1024 / (1024 + 8))
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

    def dirty_fraction_hint(self):
        if self._dirty is None:
            return None
        total = sum(a.nbytes for a in self.arrays.values())
        dirty = sum(self.arrays[k].nbytes for k in self._dirty if k in self.arrays)
        return dirty / total if total else 0.0

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
