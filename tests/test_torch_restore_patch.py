"""A slow restore forks the live template nearest its image and writes
only the pages whose chunks differ.

``DeltaCR._patch_restore`` picks, among the live templates whose images
have committed, the one whose image differs from the restored node's in
the fewest page positions, forks it and hands the fork the image
(``PagedSession.apply_patch``): the differing positions get fresh pages
written by ``kops.delta_apply`` through the pool's row view, and every
other page stays shared with the template.  The result has to be what a
fast fork of the node's own template read, bit for bit, and what the
whole-image decode gives, on a dense pool (``qwen3-tiny``) and on a hybrid
one whose sessions carry recurrent state (``jamba-tiny``).
"""
import pytest

pytest.importorskip("torch")

import json
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.core.delta_pipeline import mark_clean
from repro_torch.serve import PagedSession, PagePool

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "bench" / "tests" / "data"
PSZ = 4
CONFIGS = ["qwen3-tiny", "jamba-tiny"]


def _pool(config, num_pages=128, **kw):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.harness import registry

    cfg = json.loads((DATA / "configs" / f"{config}.json").read_text())
    port = registry.load_module("models", cfg["family"]).port_config(cfg)
    return PagePool(port, num_pages=num_pages, page_size=PSZ, max_pages_per_session=24,
                    device="cpu", **kw)


def _append(sess, rng, n):
    """``n`` positions of random K/V, tokens, logits and recurrent states,
    written as a decode step writes them (planned CoW copies, dirty pages
    noted, extras rebound)."""
    pool = sess.pool
    sess.ensure_writable(extra_tokens=n)
    for pos in range(sess.seq_len, sess.seq_len + n):
        page, slot = int(sess.table[pos // PSZ]), pos % PSZ
        for skey, tag in pool.attn_tags:
            for pools in (pool.pools_k, pool.pools_v):
                t = pools[skey][tag]
                t[:, page, slot] = torch.from_numpy(
                    rng.standard_normal(t[:, page, slot].shape).astype(np.float32)).to(t.dtype)
    sess.seq_len += n
    sess.tokens += [int(x) for x in rng.integers(0, 256, n)]
    sess.extras["last_logits"] = rng.standard_normal(64).astype(np.float32)
    sess.extras["prompt_len"] = np.asarray([37], np.int64)
    for key in sorted(pool.state_keys):
        sess.extras[key] = {leaf: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                            for leaf, shape in (("conv", (1, 1, 3, 8)), ("ssm", (1, 1, 8, 16)))}


def _leaf(v):
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return str(t.dtype), tuple(t.shape), raw


def _read(sess):
    """Everything a session holds, as bytes: length, tokens, each active
    page's K and V in every layer, every extras leaf."""
    pool = sess.pool
    pages = torch.as_tensor(sess.active_pages().astype(np.int64))
    kv = {}
    for skey, tag in pool.attn_tags:
        for which, pools in (("k", pool.pools_k), ("v", pool.pools_v)):
            t = pools[skey][tag].index_select(1, pages).contiguous()
            kv[f"{skey}/{tag}/{which}"] = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"seq_len": sess.seq_len, "tokens": list(sess.tokens), "n_pages": sess.n_pages,
            "kv": kv, "extras": {k: _leaf(v) for k, v in sess._flat_extras().items()}}


class _Tree:
    """R (1) from a 37-position root; A (2) R's child, 6 positions on (43,
    11 pages of 4); B (3) A's child, 5 more (48, 12 pages); C (4) R's
    child, 2 positions on (39).  B differs from A at pages 10 and 11, from
    R and C at pages 9 to 11.  The cache of generations and the template
    pool are large enough that nothing is evicted but by the test."""

    def __init__(self, config, seed=0, pool_kw=None, **policy):
        self.pool = pool = _pool(config, **(pool_kw or {}))
        self.rng = np.random.default_rng(seed)
        self.root = PagedSession(pool)
        _append(self.root, self.rng, 37)
        self.cr = cr = DeltaCR(
            restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
            policy=DumpPolicy(**{"mode": "delta", "max_generations": 16, **policy}),
            template_pool_size=8, async_warm=False)
        self.live = []
        cr.checkpoint(self.root, 1, None)
        cr.wait_dumps()
        self.ckpts = [1]

    def child(self, parent, ckpt, n):
        s, _ = self.cr.restore(parent)
        mark_clean(s, parent)
        _append(s, self.rng, n)
        self.cr.checkpoint(s, ckpt, parent)
        self.cr.wait_dumps()
        s.release()
        self.ckpts.append(ckpt)

    def abc(self):
        self.child(1, 2, 6)
        self.child(2, 3, 5)
        self.child(1, 4, 2)
        return self

    def fast_read(self, c):
        s, path = self.cr.restore(c)
        assert path == "fast"
        out = _read(s)
        s.release()
        return out

    def restore(self, c):
        """A restore of ``c`` under a run of its own; returns the state,
        its path and the run's counters."""
        run = trace.new_run()
        with trace.scope(run):
            s, path = self.cr.restore(c)
        self.live.append(s)
        return s, path, trace.snapshot(run)["counters"]

    def own_image(self, c):
        return self.cr.dump_future(c).result()

    def close(self):
        """Every checkpoint dropped, every session released and the
        pipeline's generations given back: the pool is all free again, with
        no reference left over."""
        cr = self.cr
        try:
            for c in self.ckpts:
                cr.drop_checkpoint(c)
            for s in self.live + [self.root]:
                s.release()
            cr.wait_dumps()
            cr.pipeline.clear()
            assert self.pool.free_pages() == self.pool.num_pages - 1
            assert int(self.pool.refs[1:].sum()) == 0
            self.pool.debug_validate()
        finally:
            cr.shutdown()


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.reset()
    yield
    trace.reset()


def _spy_patches(monkeypatch):
    """Records each ``apply_patch`` as (the base image's id, positions)."""
    seen = []
    real = PagedSession.apply_patch

    def spy(self, image, own_image, positions, store):
        seen.append((own_image.image_id, [int(p) for p in positions]))
        return real(self, image, own_image, positions, store)

    monkeypatch.setattr(PagedSession, "apply_patch", spy)
    return seen


# ---------------------------------------------------------------------------
# bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", CONFIGS)
def test_patched_restore_is_the_fast_fork_and_the_whole_decode(config):
    """B's template evicted just after a fast fork of it was read: the slow
    restore patches a fork of A (a target longer than its base) and holds
    what the fast fork held, bit for bit; with every template gone, the
    whole-image decode gives the same again."""
    tree = _Tree(config).abc()
    try:
        want = tree.fast_read(3)
        assert tree.cr.evict_template(3)
        s, path, counters = tree.restore(3)
        assert path == "slow"
        assert counters.get("cr.restore.patch") == 1
        assert counters.get("cr.restore.patch_pages") == 2
        got = _read(s)
        assert got == want
        if config == "jamba-tiny":
            assert tree.pool.state_keys and any("::" in k for k in got["extras"])
        for c in list(tree.cr._templates):
            tree.cr.evict_template(c)
        whole, path, counters = tree.restore(3)
        assert path == "slow" and "cr.restore.patch" not in counters
        assert _read(whole) == got
    finally:
        tree.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_a_target_shorter_than_its_base(config, monkeypatch):
    """A restored with B's template the only one left: A is a page shorter,
    so one position is written and B's last page is given back."""
    tree = _Tree(config).abc()
    seen = _spy_patches(monkeypatch)
    try:
        want = tree.fast_read(2)
        for c in (1, 2, 4):
            tree.cr.evict_template(c)
        s, path, counters = tree.restore(2)
        assert path == "slow" and seen == [(tree.own_image(3).image_id, [10])]
        assert counters.get("cr.restore.patch_pages") == 1
        assert _read(s) == want and s.n_pages == 11
        assert not s.table[11:].any()
    finally:
        tree.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_the_base_is_the_template_nearest_the_image(config, monkeypatch):
    """B's image differs from A's in 2 positions and from R's and C's in 3:
    A is forked.  Without A, R and C tie, and the most recently used of
    them is forked."""
    tree = _Tree(config).abc()
    seen = _spy_patches(monkeypatch)
    try:
        image = tree.own_image(3)
        dist = {c: tree.cr._templates[c].patch_positions(image, tree.own_image(c)).tolist()
                for c in (1, 2, 4)}
        assert dist == {1: [9, 10, 11], 2: [10, 11], 4: [9, 10, 11]}
        want = tree.fast_read(3)
        tree.cr.evict_template(3)
        s, _, _ = tree.restore(3)
        assert seen[-1] == (tree.own_image(2).image_id, [10, 11]) and _read(s) == want
        for recent, other in ((4, 1), (1, 4)):
            tree.cr.evict_template(3)
            tree.cr.evict_template(2)
            tree.fast_read(other)
            tree.fast_read(recent)                    # the most recently used
            s, _, _ = tree.restore(3)
            assert seen[-1] == (tree.own_image(recent).image_id, [9, 10, 11])
            assert _read(s) == want
    finally:
        tree.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_only_the_differing_positions_take_new_pages(config):
    """The pool's free pages drop by the positions written alone; every
    other position holds the base template's own page.  (B's own dump
    generation is let go first: its anchor holds pages of B that the
    restore's registration would give back.)"""
    tree = _Tree(config).abc()
    try:
        tree.cr.evict_template(3)
        assert tree.cr.release_dump_anchor(3)
        base = tree.cr._templates[2]
        free = tree.pool.free_pages()
        s, _, counters = tree.restore(3)
        assert counters["cr.restore.patch_pages"] == 2
        assert tree.pool.free_pages() == free - 2
        np.testing.assert_array_equal(s.table[:10], base.table[:10])
        assert not set(s.table[10:12].tolist()) & set(base.table[:12].tolist())
        assert all(tree.pool.refs[p] == 3 for p in s.table[10:12])   # s, its template, the anchor
    finally:
        tree.close()


# ---------------------------------------------------------------------------
# concurrency and what comes after
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", CONFIGS)
def test_base_evicted_in_another_thread_mid_restore(config, monkeypatch):
    """A's template, the base, is evicted by another thread once the
    restore has forked it and before the patch is read and written: the
    fork holds A's pages, and the restore still holds what B's fast fork
    held."""
    tree = _Tree(config).abc()
    real = PagedSession.apply_patch
    evicted = []

    def evict_then_patch(self, image, own_image, positions, store):
        t = threading.Thread(target=lambda: evicted.append(tree.cr.evict_template(2)))
        t.start()
        t.join(timeout=30)
        tree.pool.debug_validate()
        return real(self, image, own_image, positions, store)

    try:
        want = tree.fast_read(3)
        for c in (1, 3, 4):
            tree.cr.evict_template(c)
        monkeypatch.setattr(PagedSession, "apply_patch", evict_then_patch)
        s, path, counters = tree.restore(3)
        monkeypatch.undo()
        assert evicted == [True] and not tree.cr.has_template(2)
        assert path == "slow" and counters["cr.restore.patch"] == 1
        assert _read(s) == want
    finally:
        tree.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_a_childs_dump_diffs_against_the_registered_generation(config):
    """After a patched restore of B, its template evicted, B's child D is
    checkpointed: no template of B to carry, so the dump diffs against the
    generation the restore registered, drains nothing in full, and D
    restores to what it held."""
    tree = _Tree(config).abc()
    try:
        tree.cr.evict_template(3)
        s, _, _ = tree.restore(3)
        assert tree.own_image(3).image_id in tree.cr.pipeline.anchored_ids()
        mark_clean(s, 3)
        _append(s, tree.rng, 3)
        want = _read(s)
        tree.cr.evict_template(3)
        full0 = tree.cr.stats.full_keys
        run = trace.new_run()
        with trace.scope(run):
            tree.cr.checkpoint(s, 5, 3)
        tree.ckpts.append(5)
        tree.cr.wait_dumps()
        counters = trace.snapshot(run)["counters"]
        assert counters.get("dump.with_parent") == 1
        assert counters.get("dump.base_miss", 0) == 0 and counters.get("dump.parent_fork", 0) == 0
        assert tree.cr.stats.full_keys == full0
        tree.cr.evict_template(5)
        d, path, _ = tree.restore(5)
        assert path == "slow" and _read(d) == want
    finally:
        tree.close()


# ---------------------------------------------------------------------------
# where the whole image is decoded as before
# ---------------------------------------------------------------------------
def test_no_patch_for_a_tensor_state():
    from repro_torch.core import CowTensorState

    rng = np.random.default_rng(3)
    cr = DeltaCR(restore_fn=lambda p: CowTensorState(p, device="cpu"), chunk_bytes=1024,
                 policy=DumpPolicy(mode="delta"), async_warm=False)
    try:
        s = CowTensorState({"w": rng.standard_normal(2048).astype(np.float32)}, device="cpu")
        cr.checkpoint(s, 1, None)
        s.mutate("w", lambda t: t[:8].fill_(1.0))
        cr.checkpoint(s, 2, 1)
        cr.wait_dumps()
        cr.evict_template(2)
        run = trace.new_run()
        with trace.scope(run):
            got, path = cr.restore(2)
        assert path == "slow" and "cr.restore.patch" not in trace.snapshot(run)["counters"]
        assert torch.equal(got.get("w"), s.get("w"))
    finally:
        cr.shutdown()


def test_no_patch_for_tiled_entries():
    """A pool laid over a (2, 2) logical mesh dumps tiled K/V: its images
    are decoded whole, and ``page_chunk_ids`` refuses their entries."""
    from repro_torch.dist.placement import NamedSharding, PartitionSpec
    from repro_torch.launch.mesh import make_logical_mesh

    mesh = make_logical_mesh((2, 2), device="cpu")
    sharding = NamedSharding(mesh, PartitionSpec(None, None, None, "model", None))
    tree = _Tree("qwen3-tiny", pool_kw={"sharding": sharding})
    try:
        tree.child(1, 2, 6)
        assert tree.pool.multi_device()
        image = tree.own_image(2)
        assert all(image.entries[k].tile_grid for k in tree.pool.kv_keys())
        assert tree.pool.page_chunk_ids(image.entries) is None
        want = tree.fast_read(2)
        tree.cr.evict_template(2)
        s, path, counters = tree.restore(2)
        assert path == "slow" and "cr.restore.patch" not in counters
        assert _read(s) == want
    finally:
        tree.close()


@pytest.mark.parametrize("config", CONFIGS)
def test_no_patch_without_a_committed_template_image(config):
    """The only live templates have no image yet: one checkpointed without
    a dump, one whose dump waits behind a stalled worker."""
    tree = _Tree(config)
    try:
        tree.child(1, 2, 6)
        want = tree.fast_read(2)
        s, _ = tree.cr.restore(1)
        tree.live.append(s)
        tree.cr.checkpoint(s, 6, 1, dump=False)
        tree.ckpts.append(6)
        gate = threading.Event()
        tree.cr._dump_executor.submit(gate.wait)
        tree.cr.checkpoint(s, 7, 1)
        tree.ckpts.append(7)
        tree.cr.evict_template(1)
        tree.cr.evict_template(2)
        assert sorted(tree.cr._templates) == [6, 7]
        got, path, counters = tree.restore(2)
        gate.set()
        tree.cr.dump_future(7).result(timeout=60)
        assert path == "slow" and "cr.restore.patch" not in counters
        assert _read(got) == want
    finally:
        tree.close()


def test_page_chunk_ids_takes_one_chunk_a_page_alone():
    """The layouts a patch takes: K and V entries of one chunk a page, in
    the pool's page shape and dtype; none at all for an empty session."""
    from repro_torch.core.deltafs import TensorMeta

    pool = _pool("qwen3-tiny")
    proto = pool.pools_k[pool.attn_tags[0][0]][pool.attn_tags[0][1]]
    page = (proto.shape[0],) + tuple(proto.shape[2:])
    good = {k: TensorMeta((3,) + page, "float32", (i, i + 1, i + 2))
            for i, k in enumerate(pool.kv_keys())}
    np.testing.assert_array_equal(pool.page_chunk_ids(good),
                                  [[i, i + 1, i + 2] for i in range(len(good))])
    assert pool.page_chunk_ids({"meta/seq_len": None}).shape == (len(good), 0)
    k0 = pool.kv_keys()[0]
    for bad in (TensorMeta((3,) + page, "float32", (1, 2, 3), tile_grid=(3, 1, 1, 1, 1)),
                TensorMeta((3,) + page, "bfloat16", (1, 2, 3)),
                TensorMeta((3,) + page, "float32", (1, 2, 3, 4, 5, 6)),
                TensorMeta((3, 1) + page[1:], "float32", (1, 2, 3))):
        assert pool.page_chunk_ids({**good, k0: bad}) is None
    assert pool.page_chunk_ids({k: m for k, m in good.items() if k != k0}) is None


# ---------------------------------------------------------------------------
# the benchmark's check sees a patch written wrong
# ---------------------------------------------------------------------------
def _run_tiny_search(seed):
    """The benchmark's tiny search cell on the CPU, as its own tests run it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.harness import registry
    from bench.harness.main import run_cell, set_caches

    set_caches()
    spec = registry.benchmark_spec()
    name = "qwen3-tiny.search"
    spec["workloads"].append({"name": name, "config": "qwen3-tiny", "traffic": "search",
                              "chips": 1, "why": "CPU test"})
    for m in spec["per_layer"] + spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    return run_cell(name, seed, 2.0, False, torch.device("cpu"), spec=spec, base=DATA)


@pytest.mark.parametrize("fault", ["every_page", "last_page"])
def test_a_patch_written_wrong_is_not_correct(fault, monkeypatch):
    """The slow restores of the cell's check write their pages through the
    patch; a patch whose pages, or whose last page alone (the node's own
    positions), are negated is caught, as a wrong decoded image is."""
    real = PagePool.write_pages

    def negated(pool, chunks):
        out = {}
        for key, rows in chunks.items():
            _, skey, tag, _ = key.split("/")
            t = torch.from_numpy(rows.copy()).view(pool.pools_k[skey][tag].dtype)
            lo = 0 if fault == "every_page" else len(t) - 1
            t[lo:] = -t[lo:]
            out[key] = t.view(torch.uint8).numpy()
        return real(pool, out)

    monkeypatch.setattr(PagePool, "write_pages", negated)
    r = _run_tiny_search(3_000_000_003)
    n = r["info"]["numbers"]
    assert r["checks"]["slow_not_bit_equal"]["value"] >= 1
    assert n["kv_rel_err_slow"] > r["checks"]["kv_rel_err"]["limit"]
    if fault == "last_page":
        assert n["kv_rel_err_slow_own"] > n["kv_rel_err_slow"]
    assert r["correct"] is False


def test_the_tiny_search_cell_patches_its_slow_restores():
    """Unplanted, the same run is correct and its check's slow restores
    went through the patch."""
    patched = []
    real = PagedSession.apply_patch

    def noting(self, image, own_image, positions, store):
        patched.append(len(positions))
        return real(self, image, own_image, positions, store)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PagedSession, "apply_patch", noting)
        r = _run_tiny_search(3_000_000_003)
    assert r["correct"] is True and r["checks"]["slow_not_bit_equal"]["value"] == 0
    assert patched and max(patched) > 0
