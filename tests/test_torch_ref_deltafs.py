"""DeltaFS: layer semantics, O(1) rollback, lazy re-resolution, the
LayerStore/NamespaceView split (sibling views sharing frozen layers), and a
hypothesis state machine checking the overlay against a dict-of-snapshots
reference model."""
import pytest

pytest.importorskip("torch")

import numpy as np
from hypothesis import given, settings, strategies as st

from repro_torch.core.deltafs import DeltaFS, LayerStore, NamespaceView


def _arr(seed, n=64):
    return np.random.default_rng(seed).integers(0, 255, size=n).astype(np.uint8)


def test_write_read_delete():
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(0))
    np.testing.assert_array_equal(fs.read("a"), _arr(0))
    fs.delete("a")
    assert not fs.exists("a")
    with pytest.raises(KeyError):
        fs.read("a")


def test_checkpoint_is_o1_metadata():
    """Checkpoint must not copy data: physical bytes unchanged."""
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(1, 4096))
    before = fs.store.stats.physical_bytes
    cfg = fs.checkpoint()
    assert fs.store.stats.physical_bytes == before
    fs.release_config(cfg)


def test_rollback_restores_exact_state():
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(1))
    fs.write("b", _arr(2))
    c1 = fs.checkpoint()
    fs.write("a", _arr(3))
    fs.delete("b")
    fs.write("c", _arr(4))
    c2 = fs.checkpoint()
    fs.switch(c1)
    np.testing.assert_array_equal(fs.read("a"), _arr(1))
    np.testing.assert_array_equal(fs.read("b"), _arr(2))
    assert not fs.exists("c")
    fs.switch(c2)
    np.testing.assert_array_equal(fs.read("a"), _arr(3))
    assert not fs.exists("b")
    assert fs.exists("c")


def test_write_amplification_proportional_to_dirty_chunks():
    """R2: unchanged chunks are shared with the parent generation."""
    fs = DeltaFS(chunk_bytes=64)
    base = np.zeros(64 * 100, np.uint8)          # 100 chunks
    fs.write("f", base)
    fs.checkpoint()
    mod = base.copy()
    mod[0] = 1                                    # dirty exactly one chunk
    dirtied = fs.write("f", mod)
    assert dirtied == 1
    # physical growth ≈ one chunk
    meta_old_bytes = 64
    assert fs.store.stats.physical_bytes <= base.nbytes + 2 * meta_old_bytes


def test_generation_counter_lazy_reresolve():
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(1))
    fs.read("a")                                  # populate resolve cache
    gen0 = fs.checkpoint_gen
    cfg = fs.checkpoint()                         # bump generation
    assert fs.checkpoint_gen == gen0 + 1
    before = fs.lazy_reresolves
    fs.read("a")                                  # stale cache -> slow path
    assert fs.lazy_reresolves == before + 1
    fs.read("a")                                  # fresh cache -> fast path
    assert fs.lazy_reresolves == before + 1
    fs.release_config(cfg)


def test_release_config_frees_unshared_chunks():
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(1, 1024))
    c1 = fs.checkpoint()
    fs.write("a", _arr(2, 1024))                  # fully different content
    c2 = fs.checkpoint()
    phys_with_both = fs.store.stats.physical_bytes
    fs.switch(c1)                                 # live stack no longer uses gen-2
    fs.release_config(c2)                         # last ref to gen-2's layer
    assert fs.store.stats.physical_bytes < phys_with_both
    np.testing.assert_array_equal(fs.read("a"), _arr(1, 1024))
    fs.release_config(c1)                         # still held by live stack: no-op free
    np.testing.assert_array_equal(fs.read("a"), _arr(1, 1024))
    fs.debug_validate()


def test_abandoned_upper_released_on_switch():
    fs = DeltaFS(chunk_bytes=16)
    fs.write("a", _arr(1))
    c1 = fs.checkpoint()
    fs.write("junk", _arr(9, 4096))               # dirty, never checkpointed
    before = fs.store.stats.physical_bytes
    fs.switch(c1)                                 # rollback discards junk
    assert fs.store.stats.physical_bytes < before
    assert not fs.exists("junk")


# ---------------------------------------------------------------------------
# LayerStore / NamespaceView: sibling views over shared frozen layers
# ---------------------------------------------------------------------------

def test_sibling_views_share_layers_and_isolate_writes():
    fs = DeltaFS(chunk_bytes=32)
    fs.write("shared", _arr(1, 1024))
    cfg = fs.checkpoint()
    phys = fs.store.stats.physical_bytes
    views = [NamespaceView(fs.layers, base_config=cfg) for _ in range(3)]
    assert fs.store.stats.physical_bytes == phys          # mounting copies nothing
    for v in views:
        np.testing.assert_array_equal(v.read("shared"), _arr(1, 1024))
    for i, v in enumerate(views):
        v.write(f"own{i}", _arr(10 + i))
    for i, v in enumerate(views):
        for j in range(3):
            assert v.exists(f"own{j}") == (i == j)        # private uppers
    assert not fs.exists("own0")                          # original view untouched
    for v in views:
        v.close()
    assert fs.store.stats.physical_bytes == phys          # private deltas freed
    fs.release_config(cfg)
    fs.debug_validate()


def test_view_checkpoint_configs_cross_views():
    """A config frozen by one view is switchable/mountable by another —
    the substrate for SandboxTree.commit splicing a child's layers onto
    the trunk lineage."""
    fs = DeltaFS(chunk_bytes=32)
    fs.write("a", _arr(1))
    base = fs.checkpoint()
    view = NamespaceView(fs.layers, base_config=base)
    view.write("a", _arr(2))
    view.write("b", _arr(3))
    child_cfg = view.checkpoint()
    view.close()
    fs.switch(child_cfg)                                  # trunk adopts child's layers
    np.testing.assert_array_equal(fs.read("a"), _arr(2))
    np.testing.assert_array_equal(fs.read("b"), _arr(3))
    fs.release_config(child_cfg)
    fs.release_config(base)
    fs.debug_validate()


def test_view_requires_frozen_base():
    fs = DeltaFS(chunk_bytes=32)
    fs.write("a", _arr(1))
    with pytest.raises(ValueError):
        NamespaceView(fs.layers, base_config=(fs.upper_id,))   # mutable upper
    with pytest.raises(ValueError):
        NamespaceView(fs.layers, base_config=(999,))           # unknown layer


def test_layerstore_debug_validate_catches_leaks():
    store = LayerStore(chunk_bytes=32)
    layer = store.new_layer()                             # refs=0: a leak
    with pytest.raises(AssertionError):
        store.debug_validate()
    store.retain_layer(layer.layer_id)
    store.debug_validate()
    store.release_layer(layer.layer_id)


# ---------------------------------------------------------------------------
# Property: random op sequences vs a snapshot-dict reference model
# ---------------------------------------------------------------------------

ops_strategy = st.lists(
    st.one_of(
        st.tuples(st.just("write"), st.integers(0, 4), st.integers(0, 1000)),
        st.tuples(st.just("delete"), st.integers(0, 4), st.just(0)),
        st.tuples(st.just("checkpoint"), st.just(0), st.just(0)),
        st.tuples(st.just("rollback"), st.integers(0, 30), st.just(0)),
    ),
    min_size=1,
    max_size=40,
)


@settings(max_examples=30, deadline=None)
@given(ops_strategy)
def test_deltafs_matches_reference_model(ops):
    fs = DeltaFS(chunk_bytes=8)
    model = {}                  # current key -> seed
    snapshots = []              # list of (config, model-copy)
    for op, k, seed in ops:
        key = f"k{k}"
        if op == "write":
            fs.write(key, _arr(seed, 24))
            model[key] = seed
        elif op == "delete":
            if key in model:
                fs.delete(key)
                del model[key]
        elif op == "checkpoint":
            snapshots.append((fs.checkpoint(), dict(model)))
        elif op == "rollback" and snapshots:
            cfg, snap = snapshots[seed % len(snapshots)]
            fs.switch(cfg)
            model = dict(snap)
        # invariant: live view matches the model
        assert sorted(fs.keys()) == sorted(model.keys())
        for kk, ss in model.items():
            np.testing.assert_array_equal(fs.read(kk), _arr(ss, 24))
        fs.debug_validate()


def test_sibling_view_metadata_contention_microbench():
    """Per-view resolve locks: sibling views' metadata ops (resolve-cached
    reads + copy-up writes) run concurrently instead of serializing on the
    one shared LayerStore lock.  Correctness-asserted; throughput printed
    (the satellite's contention microbenchmark — numbers are informational,
    never gated, so oversubscribed CI can't flake)."""
    import threading
    import time

    store = LayerStore(chunk_bytes=256)
    base = NamespaceView(store)
    base.write("seed", _arr(0, 4096))
    config = base.checkpoint()

    n_views, per_thread_ops = 4, 150
    views = [NamespaceView(store, base_config=config) for _ in range(n_views)]
    errors = []

    def worker(i):
        rng = np.random.default_rng(i)
        v = views[i]
        try:
            for op in range(per_thread_ops):
                key = f"v{i}/k{op % 8}"
                v.write(key, rng.integers(0, 255, 512).astype(np.uint8))
                np.testing.assert_array_equal(v.read("seed"), _arr(0, 4096))
                assert v.exists(key)
        except Exception as exc:  # pragma: no cover - failure reporting
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_views)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    assert not errors, errors
    total_ops = n_views * per_thread_ops * 3
    print(
        f"\n[contention-microbench] {n_views} sibling views × "
        f"{per_thread_ops} write+read+exists rounds: "
        f"{total_ops / max(wall, 1e-9):,.0f} metadata ops/s ({wall * 1e3:.1f} ms)"
    )
    # isolation held: every view sees its own keys, nobody else's
    for i, v in enumerate(views):
        assert v.exists(f"v{i}/k0")
        assert not v.exists(f"v{(i + 1) % n_views}/k0")
        v.close()
    base.close()
    store.debug_validate()
