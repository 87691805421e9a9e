"""DeltaCR: templates, eviction→slow-path, delta dumps, CowArrayState CoW."""
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.core.chunk_store import ChunkStore
from repro_torch.core.deltacr import CowArrayState, DeltaCR


def _state(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return CowArrayState(
        {"a": rng.standard_normal(n).astype(np.float32), "b": np.zeros(n, np.int64)},
        hot_keys=("a",),
    )


def _restore(payload):
    return CowArrayState({k: v.copy() for k, v in payload.items()})


def test_fork_is_isolated():
    s = _state()
    f = s.fork()
    s.mutate("a", lambda a: a.__setitem__(0, 99.0))
    assert f.get("a")[0] != 99.0
    assert s.cow_faults == 1            # the mutation privatized a shared array
    f.release()


def test_fork_metadata_only():
    """Fork must not copy array data (CoW until first write)."""
    s = _state(n=1 << 20)               # 4 MB array
    t0 = time.perf_counter()
    forks = [s.fork() for _ in range(64)]
    dt = time.perf_counter() - t0
    assert dt < 0.5, f"64 forks took {dt:.3f}s — data is being copied"
    # shared footprint: each fork's attributable share shrinks with refs
    assert forks[0].resident_bytes() < s.get("a").nbytes
    for f in forks:
        f.release()


def test_warm_absorbs_faults():
    s = _state()
    f = s.fork()
    f.warm()                            # privatize hot keys off-path
    assert f.warmed_copies == 1
    f.mutate("a", lambda a: a.__setitem__(0, 1.0))
    assert f.cow_faults == 0            # warm pre-paid the fault
    f.mutate("b", lambda b: b.__setitem__(0, 1))
    assert f.cow_faults == 1            # non-hot key still faults inline


def test_template_fast_path_and_eviction_slow_path():
    cr = DeltaCR(template_pool_size=2, restore_fn=_restore, chunk_bytes=64)
    s = _state(1)
    cr.checkpoint(s, 1, None)
    s2, path = cr.restore(1)
    assert path == "fast"
    # push two more checkpoints -> ckpt 1 evicted (LRU)
    cr.checkpoint(s2, 2, 1)
    cr.checkpoint(s2, 3, 2)
    assert not cr.has_template(1)
    s3, path = cr.restore(1)
    assert path == "slow"
    np.testing.assert_array_equal(s3.get("a"), _state(1).get("a"))
    # slow-path restore re-injects the template
    _, path = cr.restore(1)
    assert path == "fast"
    cr.shutdown()


def test_dump_is_delta_encoded():
    cr = DeltaCR(template_pool_size=8, restore_fn=_restore, chunk_bytes=64)
    s = _state(2, n=4096)
    cr.checkpoint(s, 1, None)
    s.mutate("a", lambda a: a.__setitem__(slice(0, 4), 7.0))   # dirty 1 chunk
    cr.checkpoint(s, 2, 1)
    cr.wait_dumps()
    img1 = cr.dump_future(1).result()
    img2 = cr.dump_future(2).result()
    assert img2.parent_id == img1.image_id
    # second dump must write far fewer chunks than the first
    assert img2.dirtied_chunks <= img1.dirtied_chunks // 4
    cr.shutdown()


def test_dump_async_nonblocking():
    """checkpoint() returns before serialization completes (masked dump)."""
    big = CowArrayState({"x": np.zeros(1 << 22, np.float32)})   # 16 MB
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=1 << 16)
    t0 = time.perf_counter()
    cr.checkpoint(big, 1, None)
    blocking = time.perf_counter() - t0
    cr.wait_dumps()
    total = time.perf_counter() - t0
    assert blocking < total or blocking < 0.05
    cr.shutdown()


def test_drop_checkpoint_reclaims_storage():
    cr = DeltaCR(restore_fn=_restore, chunk_bytes=64)
    s = _state(3, n=4096)
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    before = cr.store.stats.physical_bytes
    assert before > 0
    cr.drop_checkpoint(1)
    assert cr.store.stats.physical_bytes < before


@settings(max_examples=20, deadline=None)
@given(st.lists(st.sampled_from(["fork", "mutate", "release", "warm"]), min_size=1, max_size=30))
def test_cow_state_isolation_property(ops):
    """Random fork/mutate interleavings never leak writes between clones."""
    rng = np.random.default_rng(0)
    root = CowArrayState({"a": np.zeros(64, np.float32)}, hot_keys=("a",))
    clones = [(root, [0.0])]            # (state, expected a[0] history)
    counter = 1.0
    for op in ops:
        idx = int(rng.integers(len(clones)))
        state, expect = clones[idx]
        if op == "fork":
            clones.append((state.fork(), list(expect)))
        elif op == "mutate":
            state.mutate("a", lambda a, v=counter: a.__setitem__(0, v))
            expect[0] = counter
            counter += 1.0
        elif op == "warm":
            state.warm()
        elif op == "release" and len(clones) > 1:
            clones.pop(idx)[0].release()
    for state, expect in clones:
        assert state.get("a")[0] == expect[0]
