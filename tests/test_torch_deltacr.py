"""The slice as a whole: DeltaCR over device state in both packages.

The JAX side runs a state whose chunk grids are jnp arrays, so its
pipeline takes the device plan (the fused or unfused Pallas kernel, in
interpret mode).  The port runs ``CowTensorState(device="cpu")`` built from
the same numpy dict with ``convert.state_from_numpy``, so its pipeline takes
the same plans through the kernels' plain versions.  Both get the same
seeded writes; their images, statistics and restores must agree.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import faults as j_faults
from repro.core.chunk_store import chunk_digest as j_chunk_digest
from repro.core.deltacr import DeltaCR as JDeltaCR
from repro.core.delta_pipeline import ChunkedView as JChunkedView
from repro.core.delta_pipeline import DeltaGeneration as JDeltaGeneration
from repro.core.delta_pipeline import mark_clean as j_mark_clean
from repro.core.policy import DumpPolicy as JDumpPolicy
from repro.kernels import ops as j_kops
from repro_torch.core import faults as t_faults
from repro_torch.core import (
    CowArrayState,
    CowTensorState,
    DeltaCR,
    DeltaFS,
    DumpPolicy,
    Sandbox,
    StateManager,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core.chunk_store import ChunkStore, chunk_digest
from repro_torch.core.delta_pipeline import (
    ChunkedView,
    DeltaDumpPipeline,
    DeltaGeneration,
    digest_encode_array,
    mark_clean,
)
from repro_torch.core.deltafs import read_meta_array
from repro_torch.kernels import KernelBuildError, KernelLaunchError
from repro_torch.kernels import ops as t_kops

torch.set_num_threads(1)

CHUNK = 256


# ---------------------------------------------------------------------------
# the JAX side's device state: numpy arrays of any dtype, jnp byte grids
# ---------------------------------------------------------------------------
class JnpGridState:
    """DeltaEncodable whose chunk grids are jnp arrays — the JAX package's
    device plan runs for every dirty key (the ``DeviceState`` of the JAX
    package's adaptive-mode tests, keeping each tensor's dtype)."""

    def __init__(self, arrays):
        self.arrays = {k: np.array(v, copy=True) for k, v in arrays.items()}
        self._dirty = None
        self._base = None

    def fork(self):
        c = JnpGridState(self.arrays)
        c._dirty = None if self._dirty is None else set(self._dirty)
        c._base = self._base
        return c

    def release(self):
        pass

    def warm(self):
        pass

    def dump_payload(self):
        return {k: v.copy() for k, v in self.arrays.items()}

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
        return min(dirty / total, 1.0) if total else 0.0

    def _mark(self, key):
        if self._dirty is not None:
            self._dirty.add(key)

    def write_bytes(self, key, lo, data):
        self.arrays[key].reshape(-1).view(np.uint8)[lo : lo + len(data)] = data
        self._mark(key)

    def set(self, key, arr):
        self.arrays[key] = np.array(arr, copy=True)
        self._mark(key)

    def delta_generation(self, chunk_bytes):
        views, extras = {}, {}
        for key, arr in self.arrays.items():
            if arr.nbytes < chunk_bytes:
                extras[key] = arr
                continue
            n = -(-arr.nbytes // chunk_bytes)
            pad = n * chunk_bytes - arr.nbytes

            def build(a=arr, n=n, cb=chunk_bytes):
                flat = np.zeros(n * cb, np.uint8)
                flat[: a.nbytes] = a.reshape(-1).view(np.uint8)
                return jnp.asarray(flat.reshape(n, cb))

            views[key] = JChunkedView(
                shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes,
                chunk_bytes=chunk_bytes, n_chunks=n, trailing_pad=pad, grid_fn=build,
            )
        dirty = None if self._dirty is None else frozenset(self._dirty)
        return JDeltaGeneration(views=views, extras=extras, dirty_keys=dirty)


def t_write_bytes(state, key, lo, data):
    src = torch.from_numpy(np.ascontiguousarray(data))
    state.mutate(key, lambda t: t.reshape(-1).view(torch.uint8)[lo : lo + len(data)].copy_(src))


def _bytes_of_jax(state):
    return {k: v.reshape(-1).view(np.uint8).copy() for k, v in state.arrays.items()}


def _bytes_of_port(state):
    return {k: v.reshape(-1).view(np.uint8).copy() for k, v in state_to_numpy(state).items()}


def _assert_same_bytes(jstate, tstate, what):
    jb, tb = _bytes_of_jax(jstate), _bytes_of_port(tstate)
    assert sorted(jb) == sorted(tb), what
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{what}: {k}")


def _image_view(store, image, digest_fn):
    """Image entries with store-local chunk ids replaced by chunk digests."""
    return {
        name: (
            tuple(meta.shape),
            meta.dtype,
            meta.trailing_pad,
            tuple((digest_fn(store.get(cid)), store.pad_of(cid)) for cid in meta.chunk_ids),
        )
        for name, meta in image.entries.items()
    }


def _initial_arrays(rng):
    kv = np.asarray(jnp.asarray(rng.standard_normal((64, 4, 16)), jnp.bfloat16))
    return {
        "kv": kv,                                                      # 8 KiB bf16
        "heap": rng.standard_normal(1500).astype(np.float32),          # ragged tail
        "ids": rng.integers(0, 1 << 30, 700, dtype=np.int32),
        "tiny": rng.integers(0, 9, 5, dtype=np.int64),                 # digest path
    }


class _Pair:
    """The same chain driven through both packages."""

    def __init__(self, mode, *, template_pool_size=2, seed=0, **policy):
        rng = np.random.default_rng(seed)
        arrays = _initial_arrays(rng)
        self.j = JDeltaCR(
            restore_fn=JnpGridState, chunk_bytes=CHUNK,
            template_pool_size=template_pool_size, policy=JDumpPolicy(mode=mode, **policy),
        )
        self.t = DeltaCR(
            restore_fn=lambda p: CowTensorState(p, device="cpu"), chunk_bytes=CHUNK,
            template_pool_size=template_pool_size, policy=DumpPolicy(mode=mode, **policy),
        )
        self.js = JnpGridState(arrays)
        self.ts = state_from_numpy(arrays, device="cpu")
        self.ckpts = []
        self.current = None

    def write(self, key, lo, data):
        self.js.write_bytes(key, lo, data)
        t_write_bytes(self.ts, key, lo, data)

    def set(self, key, arr):
        self.js.set(key, arr)
        self.ts.set(key, state_from_numpy({key: arr}, device="cpu").get(key))

    def checkpoint(self):
        c = len(self.ckpts) + 1
        for cr, s in ((self.j, self.js), (self.t, self.ts)):
            cr.checkpoint(s, c, self.current)
            # the generation cache is an LRU shared by dumps (worker thread)
            # and decodes (caller): landing each dump first keeps its order,
            # and so the plans, deterministic
            cr.wait_dumps()
        self.ckpts.append(c)
        self.current = c

    def restore(self, c):
        self.js.release()
        self.ts.release()
        self.js, jpath = self.j.restore(c)
        self.ts, tpath = self.t.restore(c)
        j_mark_clean(self.js, c)
        mark_clean(self.ts, c)
        self.current = c
        assert jpath == tpath
        _assert_same_bytes(self.js, self.ts, f"restore of {c} ({tpath})")
        return tpath

    def compare_images(self, *, stats=True):
        self.j.wait_dumps()
        self.t.wait_dumps()
        for c in self.ckpts:
            ji = self.j.dump_future(c).result()
            ti = self.t.dump_future(c).result()
            assert _image_view(self.j.store, ji, j_chunk_digest) == _image_view(
                self.t.store, ti, chunk_digest
            ), f"image {c}"
            assert ti.mode == ji.mode and ti.dirtied_chunks == ji.dirtied_chunks, f"image {c}"
        if stats:
            for f in ("kernel_keys", "full_keys", "clean_keys", "dumps"):
                assert getattr(self.t.stats, f) == getattr(self.j.stats, f), f

    def shutdown(self):
        self.j.shutdown()
        self.t.shutdown()


def _random_chain(pair, rng, steps=6):
    pair.checkpoint()
    for step in range(steps):
        for _ in range(int(rng.integers(1, 4))):
            key = ["kv", "heap", "ids", "tiny"][int(rng.integers(4))]
            nbytes = pair.js.arrays[key].nbytes
            n = int(rng.integers(1, 48)) if rng.random() < 0.85 else nbytes
            lo = int(rng.integers(0, nbytes - min(n, nbytes) + 1))
            pair.write(key, lo, rng.integers(0, 256, min(n, nbytes), dtype=np.uint8))
        if rng.random() < 0.2:
            pair.set(f"new{step}", rng.standard_normal(96).astype(np.float32))
        pair.checkpoint()
        if rng.random() < 0.3:
            pair.restore(pair.ckpts[int(rng.integers(len(pair.ckpts)))])
    pair.compare_images(stats=pair.t.dump_mode != "auto")
    if pair.t.dump_mode == "delta" and not pair.t.stats.fallback_dumps:
        assert pair.t.stats.kernel_keys > 0          # the device plans ran
    # every image restores the same bytes on the slow path too
    for c in pair.ckpts:
        pair.j.evict_template(c)
        pair.t.evict_template(c)
        assert pair.restore(c) == "slow"


@pytest.mark.parametrize("mode", ["legacy", "digest", "delta", "auto"])
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_write_checkpoint_rollback_chains_match(mode, seed):
    pair = _Pair(mode, seed=seed)
    try:
        _random_chain(pair, np.random.default_rng(seed))
    finally:
        pair.shutdown()


def test_unfused_plan_chain_matches():
    """The delta_diff + compaction plan (fused kernel off) agrees too."""
    pair = _Pair("delta", seed=5, fused_kernel=False)
    try:
        _random_chain(pair, np.random.default_rng(5))
    finally:
        pair.shutdown()


@pytest.mark.parametrize(
    "capacity_frac,rows,overflow",
    # "heap" is 24 rows, padded to 32: capacity 8 at 0.25, and 16 at 0.3
    # (ceil(9.6) rounded up to a power of two)
    [(0.25, 4, False), (0.25, 12, True), (0.3, 12, False), (0.3, 20, True)],
)
def test_capacity_overflow_falls_back_to_full_at_the_same_step(capacity_frac, rows, overflow):
    """More dirty chunks than the kernel capacity: both packages drain the
    tensor in full at the same checkpoint and agree on every image."""
    pair = _Pair("delta", seed=1, capacity_frac=capacity_frac)
    try:
        pair.checkpoint()
        full_before = pair.t.stats.full_keys
        pair.write("heap", 0, np.full(rows * CHUNK, 9, np.uint8))
        pair.checkpoint()
        pair.compare_images()
        assert pair.t.dump_future(2).result().dirtied_chunks == rows
        assert pair.t.stats.full_keys - full_before == int(overflow)
        assert pair.t.stats.kernel_keys == int(not overflow)
    finally:
        pair.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_injected_fused_fault_rolls_back_the_same_way():
    pair = _Pair("delta", seed=3)
    try:
        with j_faults.inject(j_faults.FaultPlan().add("kernels.fused", after=2)):
            with t_faults.inject(t_faults.FaultPlan().add("kernels.fused", after=2)):
                _random_chain(pair, np.random.default_rng(3), steps=4)
        jh, th = pair.j.health(), pair.t.health()
        assert th["dump_retries"] == jh["dump_retries"] >= 1
        assert th["dump_failures"] == jh["dump_failures"] == 0
        assert th["fallback_dumps"] == jh["fallback_dumps"]
    finally:
        pair.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_checksum_mismatch_rolls_back_the_same_way(monkeypatch):
    """Tampered device lanes: the host re-checksum catches them in both
    packages; the attempts roll back and the dumps degrade to legacy."""
    j_real, t_real = j_kops.fused_encode, t_kops.fused_encode

    def j_tampered(old, new, max_changed):
        data, idx, count, sums = j_real(old, new, max_changed)
        return data, idx, count, sums + np.uint32(1)

    def t_tampered(old, new, max_changed):
        data, idx, count, sums = t_real(old, new, max_changed)
        return data, idx, count, (sums.view(torch.int32) + 1).view(torch.uint32)

    monkeypatch.setattr(j_kops, "fused_encode", j_tampered)
    monkeypatch.setattr(t_kops, "fused_encode", t_tampered)
    pair = _Pair("delta", seed=4, retries=1)
    try:
        _random_chain(pair, np.random.default_rng(4), steps=3)
        jh, th = pair.j.health(), pair.t.health()
        assert th["fused_checksum_mismatches"] == jh["fused_checksum_mismatches"] >= 1
        assert th["fallback_dumps"] == jh["fallback_dumps"] >= 1
        assert th["dump_failures"] == jh["dump_failures"] == 0
    finally:
        pair.shutdown()


@pytest.mark.chaos
@pytest.mark.timeout(120)
@pytest.mark.parametrize("error", [KernelBuildError, KernelLaunchError])
def test_kernel_failure_fails_the_dump_without_host_fallback(monkeypatch, error):
    """A kernel that does not build or launch is a fault of the port, not a
    transient one: the dump fails at once, with no retry, and never lands
    on the host's legacy path."""
    def broken(old, new, max_changed):
        raise error("kernel unavailable")

    monkeypatch.setattr(t_kops, "fused_encode", broken)
    cr = DeltaCR(
        restore_fn=lambda p: CowTensorState(p, device="cpu"), chunk_bytes=CHUNK,
        policy=DumpPolicy(mode="delta", retries=2),
    )
    s = CowTensorState({"x": torch.zeros(8 * CHUNK, dtype=torch.uint8)}, device="cpu")
    try:
        cr.checkpoint(s, 1, None)
        cr.dump_future(1).result()            # no parent: every chunk, no kernel
        s.mutate("x", lambda t: t[:8].fill_(3))
        cr.checkpoint(s, 2, 1)
        with pytest.raises(error):
            cr.dump_future(2).result()
        h = cr.health()
        assert h["dump_failures"] == 1
        assert h["fallback_dumps"] == h["dump_retries"] == 0
        assert "legacy" not in cr.stats.mode_dumps
    finally:
        cr.drop_checkpoint(2)
        cr.shutdown()


# ---------------------------------------------------------------------------
# CowTensorState: CoW aliasing and the device entry point
# ---------------------------------------------------------------------------
def test_parent_generation_survives_a_child_write():
    """The parent generation's grid is a zero-copy view of the template's
    tensor: a write through mutate() must CoW-fault, never change it."""
    s = CowTensorState({"x": torch.zeros(4 * CHUNK, dtype=torch.uint8)}, device="cpu")
    s.reset_dirty_tracking(1)
    parent = s.fork()                                   # the template
    grid = parent.delta_generation(CHUNK).views["x"].grid
    assert grid.data_ptr() == parent.get("x").data_ptr()  # zero-copy
    s.mutate("x", lambda t: t[:8].fill_(5))
    assert s.cow_faults == 1 and int(grid.sum()) == 0
    assert int(s.get("x")[:8].sum()) == 40


def test_slow_restore_leaves_the_parent_generation_intact():
    """delta_apply scatters in place, so the slow restore must hand it a
    clone: the parent generation's grid is the parent template's tensor,
    and a later fast restore of the parent must still read its bytes."""
    pair = _Pair("delta", seed=6, template_pool_size=8)
    try:
        pair.checkpoint()
        pair.write("kv", 0, np.full(3 * CHUNK, 7, np.uint8))      # zero-copy grid
        pair.checkpoint()
        for cr in (pair.j, pair.t):
            cr.evict_template(2)
        assert pair.restore(2) == "slow"
        assert pair.restore(1) == "fast"
        assert not (_bytes_of_port(pair.ts)["kv"][: 3 * CHUNK] == 7).all()
    finally:
        pair.shutdown()


def test_ragged_tail_grid_is_padded_on_device():
    s = CowTensorState({"x": torch.arange(100, dtype=torch.float32)}, device="cpu")
    v = s.delta_generation(CHUNK).views["x"]
    assert (v.n_chunks, v.trailing_pad) == (2, 2 * CHUNK - 400)
    g = v.grid
    assert g.shape == (2, CHUNK) and g.dtype == torch.uint8
    assert int(g.reshape(-1)[400:].sum()) == 0


def test_warm_absorbs_faults_and_forks_are_isolated():
    s = CowTensorState(
        {"a": torch.zeros(64), "b": torch.zeros(64, dtype=torch.int64)},
        hot_keys=("a",), device="cpu",
    )
    f = s.fork()
    f.warm()
    assert f.warmed_copies == 1
    f.mutate("a", lambda a: a.__setitem__(0, 1.0))
    assert f.cow_faults == 0 and float(s.get("a")[0]) == 0.0
    f.mutate("b", lambda b: b.__setitem__(0, 1))
    assert f.cow_faults == 1 and int(s.get("b")[0]) == 0


def test_state_round_trips_through_numpy_with_bf16_bits():
    rng = np.random.default_rng(0)
    arrays = _initial_arrays(rng)
    s = state_from_numpy(arrays, device="cpu")
    assert s.get("kv").dtype == torch.bfloat16
    back = state_to_numpy(s)
    np.testing.assert_array_equal(back["kv"], arrays["kv"].view(np.uint16))
    np.testing.assert_array_equal(back["heap"], arrays["heap"])


# ---------------------------------------------------------------------------
# the JAX package's DeltaCR / pipeline cases, ported (host and tensor state)
# ---------------------------------------------------------------------------
def _mk(kind, arrays, **kw):
    if kind == "array":
        return CowArrayState(arrays, **kw)
    return CowTensorState({k: torch.from_numpy(v) for k, v in arrays.items()}, device="cpu", **kw)


def _restore_fn(kind):
    if kind == "array":
        return lambda p: CowArrayState({k: np.array(v, copy=True) for k, v in p.items()})
    return lambda p: CowTensorState(p, device="cpu")


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _payload_of(cr, ckpt_id):
    image = cr.dump_future(ckpt_id).result()
    return {n: read_meta_array(cr.store, m) for n, m in image.entries.items()}, image


KINDS = pytest.mark.parametrize("kind", ["array", "tensor"])


@KINDS
def test_template_fast_path_and_eviction_slow_path(kind):
    rng = np.random.default_rng(1)
    arrays = {"a": rng.standard_normal(256).astype(np.float32), "b": np.zeros(256, np.int64)}
    cr = DeltaCR(template_pool_size=2, restore_fn=_restore_fn(kind), chunk_bytes=64)
    s = _mk(kind, {k: v.copy() for k, v in arrays.items()})
    cr.checkpoint(s, 1, None)
    s2, path = cr.restore(1)
    assert path == "fast"
    cr.checkpoint(s2, 2, 1)
    cr.checkpoint(s2, 3, 2)
    assert not cr.has_template(1)
    s3, path = cr.restore(1)
    assert path == "slow"
    np.testing.assert_array_equal(_host(s3.get("a")), arrays["a"])
    _, path = cr.restore(1)
    assert path == "fast"
    cr.shutdown()


@KINDS
def test_dump_is_delta_encoded(kind):
    cr = DeltaCR(template_pool_size=8, restore_fn=_restore_fn(kind), chunk_bytes=64)
    s = _mk(kind, {"a": np.random.default_rng(2).standard_normal(4096).astype(np.float32)})
    cr.checkpoint(s, 1, None)
    s.mutate("a", lambda a: a.__setitem__(slice(0, 4), 7.0))
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    img1, img2 = cr.dump_future(1).result(), cr.dump_future(2).result()
    assert img2.parent_id == img1.image_id
    assert img2.dirtied_chunks == 1 and img1.dirtied_chunks == 256
    cr.shutdown()


@KINDS
def test_drop_checkpoint_reclaims_storage(kind):
    cr = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=64)
    cr.checkpoint(_mk(kind, {"a": np.arange(4096, dtype=np.float32)}), 1, None)
    cr.wait_dumps()
    before = cr.store.stats.physical_bytes
    cr.drop_checkpoint(1)
    assert 0 < before and cr.store.stats.physical_bytes < before
    cr.shutdown()


@KINDS
def test_odd_sized_array_roundtrip_through_dump(kind):
    cr = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=64)
    arrays = {
        "a": np.arange(37, dtype=np.int8),
        "b": np.arange(1000, dtype=np.int64),
        "c": np.arange(333, dtype=np.float32),
    }
    cr.checkpoint(_mk(kind, {k: v.copy() for k, v in arrays.items()}), 1, None)
    cr.wait_dumps()
    payload, image = _payload_of(cr, 1)
    for k, v in arrays.items():
        np.testing.assert_array_equal(payload[k], v)
    assert image.entries["c"].trailing_pad == 64 - (1332 % 64)
    cr.shutdown()


def _run_workload(cr, kind, seed=3):
    rng = np.random.default_rng(seed)
    r1 = np.random.default_rng(1)
    s = _mk(kind, {f"k{i}": r1.standard_normal(4096).astype(np.float32) for i in range(6)})
    cr.checkpoint(s, 1, None)
    for step in range(2, 7):
        key = f"k{int(rng.integers(6))}"
        lo = int(rng.integers(0, 4000))
        s.mutate(key, lambda a, lo=lo: a.__setitem__(slice(lo, lo + 16), float(step)))
        if step % 3 == 0:
            new = rng.standard_normal(100).astype(np.float32)
            s.set(f"new{step}", new if kind == "array" else torch.from_numpy(new))
        cr.checkpoint(s, step, step - 1)
    cr.wait_dumps()
    return s


@KINDS
def test_pipeline_images_bit_identical_to_legacy(kind):
    cr_new = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=1024, policy=DumpPolicy(mode="auto"))
    cr_old = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=1024, policy=DumpPolicy(mode="legacy"))
    _run_workload(cr_new, kind)
    _run_workload(cr_old, kind)
    for ckpt in range(1, 7):
        pl_new, img_new = _payload_of(cr_new, ckpt)
        pl_old, img_old = _payload_of(cr_old, ckpt)
        assert img_new.mode == "delta" and img_old.mode == "legacy"
        assert sorted(pl_new) == sorted(pl_old)
        for name in pl_new:
            np.testing.assert_array_equal(pl_new[name], pl_old[name])
    cr_new.shutdown()
    cr_old.shutdown()


@KINDS
def test_pipeline_restore_matches_live_state(kind):
    cr = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=1024, template_pool_size=1)
    s = _run_workload(cr, kind, seed=9)
    want = {k: _host(s.get(k)).copy() for k in s.keys()}
    restored, _ = cr.restore(6)
    for k in want:
        np.testing.assert_array_equal(_host(restored.get(k)), want[k])
    for ckpt in (5, 3, 1):
        r, _ = cr.restore(ckpt)
        pl, _ = _payload_of(cr, ckpt)
        for k in pl:
            np.testing.assert_array_equal(_host(r.get(k)), pl[k])
    cr.shutdown()


@KINDS
@pytest.mark.parametrize("dirty_chunks", [0, 1, 8, 16, 32])
def test_dirty_ratio_sweep_and_overflow(kind, dirty_chunks):
    n_chunks, cb = 32, 256
    cr = DeltaCR(
        restore_fn=_restore_fn(kind), chunk_bytes=cb, template_pool_size=1,
        policy=DumpPolicy(capacity_frac=0.25),
    )
    base = np.zeros(n_chunks * cb, np.uint8)
    s = _mk(kind, {"x": base.copy()})
    cr.checkpoint(s, 1, None)

    def dirty(a):
        for i in range(dirty_chunks):
            a[i * cb : i * cb + 4] = 255

    s.mutate("x", dirty)
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    assert cr.dump_future(2).result().dirtied_chunks == dirty_chunks
    restored, _ = cr.restore(1)
    np.testing.assert_array_equal(_host(restored.get("x")), base)
    want = _host(s.get("x")).copy()
    restored2, _ = cr.restore(2)
    np.testing.assert_array_equal(_host(restored2.get("x")), want)
    # host grids diff exactly (never overflow); tensor grids overflow past
    # the capacity of 8 and fall back to the full chunk set
    overflow = kind == "tensor" and dirty_chunks > 8
    assert cr.stats.kernel_keys == (0 if overflow else 1)
    cr.shutdown()


def test_kernel_branch_capacity_overflow_falls_back_to_full():
    n, cb = 16, 256
    store = ChunkStore(chunk_bytes=cb)
    pipe = DeltaDumpPipeline(store, capacity_frac=0.25)

    def dev_view(arr):
        grid = torch.from_numpy(arr.reshape(n, cb).copy())
        return ChunkedView(
            shape=arr.shape, dtype=str(arr.dtype), nbytes=arr.nbytes,
            chunk_bytes=cb, n_chunks=n, trailing_pad=0, grid_fn=lambda g=grid: g,
        )

    base = np.zeros(n * cb, np.uint8)
    res1 = pipe.encode_generation(DeltaGeneration(views={"x": dev_view(base)}), None)

    class _Img:
        image_id = 1
        entries = res1.entries

    pipe.register(1, {"x": dev_view(base)}, anchor=None)
    changed = base.copy()
    changed[: 10 * cb] = 7
    res2 = pipe.encode_generation(DeltaGeneration(views={"x": dev_view(changed)}), _Img)
    assert res2.full_keys == 1 and res2.kernel_keys == 0 and res2.dirtied == 10
    got = store.get_array(res2.entries["x"].chunk_ids, changed.shape, np.uint8)
    np.testing.assert_array_equal(got, changed)


@KINDS
def test_clean_keys_never_materialize_bytes(kind):
    cr = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=1024)
    r = np.random.default_rng(4)
    s = _mk(kind, {f"k{i}": r.standard_normal(4096).astype(np.float32) for i in range(8)})
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    puts, written = cr.store.stats.puts, cr.store.stats.bytes_written
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    assert cr.dump_future(2).result().dirtied_chunks == 0
    assert (cr.store.stats.puts, cr.store.stats.bytes_written) == (puts, written)
    assert cr.stats.clean_keys >= 8
    cr.shutdown()


@KINDS
def test_transient_checkpoint_invalidates_dirty_tracking(kind):
    fs = DeltaFS(chunk_bytes=256)
    cr = DeltaCR(store=fs.store, restore_fn=_restore_fn(kind), chunk_bytes=256)
    sm = StateManager(Sandbox(fs, _mk(kind, {"heap": np.zeros(1024, np.float32)})), cr)
    sm.checkpoint()
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(0, 1.0))

    def eval_fn(sb):
        sb.proc.mutate("heap", lambda h: h.__setitem__(1, 99.0))
        return 1.0

    sm.isolated_eval(eval_fn)
    c2 = sm.checkpoint()
    cr.wait_dumps()
    restored, _ = cr.restore(c2)
    assert float(restored.get("heap")[0]) == 1.0 and float(restored.get("heap")[1]) == 0.0
    cr.evict_template(c2)
    slow, path = cr.restore(c2)
    assert path == "slow"
    np.testing.assert_array_equal(_host(slow.get("heap")), _host(restored.get("heap")))
    cr.shutdown()


@KINDS
def test_branch_checkpoint_ignores_stale_dirty_hint(kind):
    cr = DeltaCR(restore_fn=_restore_fn(kind), chunk_bytes=1024, template_pool_size=1)
    s = _mk(kind, {"k": np.zeros(4096, np.float32)})
    cr.checkpoint(s, 1, None)
    s.mutate("k", lambda a: a.__setitem__(slice(0, 8), 7.0))
    cr.checkpoint(s, 2, 1)
    cr.checkpoint(s, 3, 1)
    cr.wait_dumps()
    payload, _ = _payload_of(cr, 3)
    assert payload["k"][0] == 7.0
    cr.evict_template(3)
    restored, path = cr.restore(3)
    assert path == "slow" and float(restored.get("k")[0]) == 7.0
    cr.shutdown()


@KINDS
def test_restore_then_checkpoint_delta_is_exact(kind):
    fs = DeltaFS(chunk_bytes=512)
    proc = _mk(kind, {"a": np.zeros(4096, np.float32), "b": np.ones(4096, np.float32)})
    cr = DeltaCR(store=fs.store, restore_fn=_restore_fn(kind), chunk_bytes=512)
    sm = StateManager(Sandbox(fs, proc), cr)
    c1 = sm.checkpoint()
    sm.sandbox.proc.mutate("a", lambda x: x.__setitem__(slice(0, 4), 5.0))
    sm.checkpoint()
    sm.restore(c1)
    sm.sandbox.proc.mutate("b", lambda x: x.__setitem__(slice(0, 4), 7.0))
    c3 = sm.checkpoint()
    cr.wait_dumps()
    img3 = cr.dump_future(c3).result()
    assert img3.dirtied_chunks == 1
    slow, _ = _payload_of(cr, c3)
    assert slow["a"][0] == 0.0 and slow["b"][0] == 7.0
    cr.shutdown()


def test_digest_encode_array_reuses_parent_chunks():
    cs = ChunkStore(chunk_bytes=128)
    a = torch.arange(1024, dtype=torch.int32).to(torch.uint8)
    meta1, d1 = digest_encode_array(cs, a, None)
    b = a.clone()
    b[200] = 0
    meta2, d2 = digest_encode_array(cs, b, meta1)
    assert (d1, d2) == (8, 1) and len(meta1.digests) == 8
    assert meta2.chunk_ids[0] == meta1.chunk_ids[0] and meta2.chunk_ids[1] != meta1.chunk_ids[1]
    np.testing.assert_array_equal(read_meta_array(cs, meta2), b.numpy())


def test_chunked_view_zero_copy_and_pad():
    arr = np.arange(96, dtype=np.float32)
    v = ChunkedView.from_host_array(arr, 256)
    assert (v.n_chunks, v.trailing_pad) == (2, 128)
    np.testing.assert_array_equal(v.grid.reshape(-1)[: arr.nbytes], arr.view(np.uint8))
    assert not v.grid.reshape(-1)[arr.nbytes :].any()
    assert ChunkedView.from_host_array(np.arange(128, dtype=np.float32), 256).grid.base is not None


# ---------------------------------------------------------------------------
# the quickstart flow through repro_torch.core, with a bf16 tensor
# ---------------------------------------------------------------------------
def test_quickstart_flow_on_tensor_state():
    fs = DeltaFS(chunk_bytes=4096)
    fs.write("repo/main.py", np.arange(50_000, dtype=np.int32))
    rng = np.random.default_rng(0)
    kv = np.asarray(jnp.asarray(rng.standard_normal((512, 4, 32)), jnp.bfloat16))
    proc = state_from_numpy(
        {"heap": np.zeros(100_000, np.float32), "kv": kv}, device="cpu", hot_keys=("heap",)
    )
    cr = DeltaCR(
        store=fs.store, restore_fn=lambda p: CowTensorState(p, device="cpu"),
        template_pool_size=8, policy=DumpPolicy(mode="delta"),
    )
    sm = StateManager(Sandbox(fs, proc), cr)
    c1 = sm.checkpoint()
    sm.sandbox.fs.write("repo/main.py", np.ones(50_000, np.int32))
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(0, 10), 1.0))
    sm.sandbox.proc.mutate("kv", lambda t: t[:64].fill_(2.0))
    c2 = sm.checkpoint()
    assert sm.restore(c1) == "fast"
    assert sm.sandbox.fs.read("repo/main.py")[0] == 0
    assert float(sm.sandbox.proc.get("heap")[0]) == 0.0
    np.testing.assert_array_equal(state_to_numpy(sm.sandbox.proc)["kv"], kv.view(np.uint16))
    sm.restore(c2)
    assert float(sm.sandbox.proc.get("heap")[0]) == 1.0

    def run_tests(sb):
        sb.fs.write("repo/__pycache__", np.zeros(8, np.int8))
        return 0.83

    assert sm.isolated_eval(run_tests) == 0.83
    assert not sm.sandbox.fs.exists("repo/__pycache__")
    cr.wait_dumps()
    img1, img2 = cr.dump_future(c1).result(), cr.dump_future(c2).result()
    assert img1.entries["kv"].dtype == "bfloat16" and img2.mode == "delta"
    # slow restore of c2 rebuilds the bf16 tensor byte for byte
    cr.evict_template(c2)
    assert sm.restore(c2) == "slow"
    got = sm.sandbox.proc.get("kv")
    assert got.dtype == torch.bfloat16 and float(got[0, 0, 0]) == 2.0
    np.testing.assert_array_equal(got[64:].view(torch.int16).numpy(), kv[64:].view(np.int16))
    cr.shutdown()
