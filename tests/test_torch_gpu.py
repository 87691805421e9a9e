"""The port on the card: CUDA kernels against their plain versions, and a
short checkpoint/rollback chain over CUDA tensors.

Every test here needs a CUDA card and skips without one; run them on the
GPU machine with ``python -m pytest -m gpu tests/test_torch_gpu.py``.  This
file imports no JAX, so it runs where the JAX package is not installed.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.core import CowTensorState, DeltaCR, DumpPolicy, state_to_numpy
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pair(gen, N, C, n_dirty, device):
    old = torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8)
    new = old.clone()
    rows = torch.randperm(N, generator=gen, device=device)[:n_dirty]
    new[rows, 0] ^= 0x5A
    return old, new


@pytest.mark.gpu
@pytest.mark.parametrize(
    "N,C,n_dirty,cap",
    [(8, 128, 2, 4), (37, 256, 12, 16), (64, 512, 21, 8), (37, 100, 5, 8), (256, 65536, 8, 128)],
)
def test_cuda_kernels_match_plain_versions(cuda, N, C, n_dirty, cap):
    """Each CUDA kernel equals its plain version bit for bit (overflow
    included) and counts one launch per call."""
    gen = torch.Generator(device=cuda).manual_seed(N * C)
    old, new = _pair(gen, N, C, n_dirty, cuda)
    ops.reset_launch_counts()
    got = ops.fused_encode(old, new, cap)
    for g, w in zip(got, ref.fused_encode_ref(old, new, cap)):
        assert torch.equal(g, w)
    assert int(got[2]) == n_dirty
    assert torch.equal(ops.delta_diff(old, new), ref.delta_diff_ref(old, new))
    base = old.clone()
    assert ops.delta_apply(base, got[0], got[1]) is base
    assert torch.equal(base, ref.delta_apply_ref(old, got[0], got[1]))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "delta_diff": 1, "delta_fused": 1, "delta_apply": 1,
        "page_copy": 0, "page_copy_stacked": 0, "paged_attention": 0,
    }


@pytest.mark.gpu
def test_cuda_host_fetch_waits_on_its_event(cuda):
    t = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    fetch = ops.start_host_fetch(t, t[:3].sum())
    assert fetch.from_device and fetch.nbytes == 4 * (1 << 20) + 8
    arr, total = fetch.wait()
    np.testing.assert_array_equal(arr, np.arange(1 << 20, dtype=np.int32))
    assert int(total) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_checkpoint_rollback_chain(cuda, fused):
    """Writes, checkpoints and restores over CUDA tensors: every image is a
    delta image through the kernels, fast and slow restores give back the
    bytes of their checkpoint."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = CowTensorState(
        {
            "kv": torch.randn((512, 8, 128), generator=gen, device=cuda).to(torch.bfloat16),
            "heap": torch.randn(1 << 20, generator=gen, device=cuda),
        },
        device=cuda,
    )
    cr = DeltaCR(
        restore_fn=lambda p: CowTensorState(p, device=cuda), template_pool_size=2,
        policy=DumpPolicy(mode="delta", fused_kernel=fused),
    )
    ops.reset_launch_counts()
    saved = {}
    try:
        for c in range(1, 6):
            if c > 1:
                state.mutate("kv", lambda t, c=c: t[32 * c : 32 * c + 32].fill_(float(c)))
                state.mutate("heap", lambda t, c=c: t[4096 * c : 4096 * c + 7].add_(1.0))
            cr.checkpoint(state, c, c - 1 if c > 1 else None)
            cr.wait_dumps()
            saved[c] = state_to_numpy(state)
            img = cr.dump_future(c).result()
            assert img.mode == "delta"
            if c > 1:
                assert img.dirtied_chunks == 2
        assert cr.stats.kernel_keys == 8 and cr.stats.full_keys == 2
        for c in (5, 2):
            restored, path = cr.restore(c)
            assert path == ("fast" if c == 5 else "slow")
            for k, v in state_to_numpy(restored).items():
                np.testing.assert_array_equal(v, saved[c][k])
        cr.evict_template(5)
        restored, path = cr.restore(5)
        assert path == "slow"
        for k, v in state_to_numpy(restored).items():
            np.testing.assert_array_equal(v, saved[5][k])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["delta_apply"] > 0
        assert counts["delta_fused" if fused else "delta_diff"] > 0
    finally:
        cr.shutdown()


PA_CASES = [
    # B, KVH, G, D, page_size, P, max_pages, dtype (the sweep of tests/test_kernels.py)
    (1, 1, 1, 128, 16, 8, 2, torch.float32),
    (2, 2, 4, 128, 64, 16, 4, torch.float32),
    (3, 4, 2, 128, 32, 12, 3, torch.float32),
    (2, 1, 8, 256, 16, 8, 4, torch.float32),
    (2, 2, 5, 128, 16, 8, 3, torch.float32),
    (2, 2, 4, 64, 16, 8, 3, torch.float32),
    (2, 2, 4, 128, 64, 16, 4, torch.bfloat16),
    (4, 8, 5, 128, 16, 1024, 256, torch.bfloat16),   # the served qwen3-14b shape
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,KVH,G,D,psz,P,maxp,dtype", PA_CASES)
def test_cuda_paged_attention_matches_plain_version(cuda, B, KVH, G, D, psz, P, maxp, dtype):
    gen = torch.Generator(device=cuda).manual_seed(B * D + G)
    q = torch.randn((B, KVH, G, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((P, psz, KVH, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, psz, KVH, D), generator=gen, device=cuda).to(dtype)
    table = torch.randint(0, P, (B, maxp), generator=gen, device=cuda, dtype=torch.int32)
    lens = torch.randint(1, maxp * psz + 1, (B,), generator=gen, device=cuda, dtype=torch.int32)
    if B > 1:
        lens[0] = 0                               # an empty session gives exactly 0
    ops.reset_launch_counts()
    got = ops.paged_attention(q, k, v, table, lens)
    want = ref.paged_attention_ref(q, k, v, table, lens)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert B == 1 or not got[0].any()
    assert ops.launch_counts()["paged_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("N,P,psz,KVH,D,n", [
    (1, 8, 16, 2, 128, 3), (3, 12, 64, 1, 256, 5), (2, 6, 16, 4, 64, 1), (40, 64, 16, 8, 128, 4),
])
def test_cuda_page_copy_matches_plain_version(cuda, dtype, N, P, psz, KVH, D, n):
    gen = torch.Generator(device=cuda).manual_seed(P * D + n)
    pool = torch.randint(-1000, 1000, (N, P, psz, KVH, D), generator=gen, device=cuda).to(dtype)
    perm = torch.randperm(P, generator=gen, device=cuda).tolist()
    src, dst = perm[:n], perm[n : 2 * n]
    ops.reset_launch_counts()
    want = ref.page_copy_stacked_ref(pool, torch.tensor(src), torch.tensor(dst))
    got = ops.page_copy_stacked(pool, src, dst)
    assert got is pool and torch.equal(pool, want)
    flat = pool[0].clone()
    ops.page_copy(flat, src, dst)
    assert torch.equal(flat, ref.page_copy_ref(pool[0], torch.tensor(src), torch.tensor(dst)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["page_copy_stacked"] == 1 and counts["page_copy"] == 1
    ops.page_copy_stacked(pool, [], [])
    assert ops.launch_counts()["page_copy_stacked"] == 1


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_engine(cuda):
    """The serving path on the card: prefill, batched decode of a session
    and its fork (the shared tail page copied for each), through the
    kernels; float32 logits agree with the same engine on the CPU (plain
    versions) and tokens are equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Engine, PagePool

    # the tiny qwen3 config widened to a head_dim the kernel takes, odd G = 5
    cfg = dataclasses.replace(get_config("qwen3-14b-tiny"), n_heads=10, n_kv_heads=2, head_dim=64)
    cpu_model = Model(cfg, device="cpu")
    cpu_model.init(torch.Generator().manual_seed(0))

    def to_cuda(t):
        return {k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict) else t.to(cuda)

    cuda_model = Model(cfg, device=cuda, params=to_cuda(cpu_model.params))
    engines = [
        Engine(m, PagePool(cfg, num_pages=32, page_size=16, max_pages_per_session=8, device=d))
        for m, d in ((cpu_model, "cpu"), (cuda_model, cuda))
    ]
    ops.reset_launch_counts()
    runs = []
    for eng in engines:
        trunk = eng.new_session(list(range(3, 24)))        # 21 tokens: tail page part-full
        kid = trunk.fork()
        kid.tokens[-1] = 7
        logits, toks = [], []
        for _ in range(4):
            toks.append(eng.step([trunk, kid]))
            logits.append(np.stack([trunk.extras["last_logits"], kid.extras["last_logits"]]))
        runs.append((toks, logits, eng.pool.stats.cow_copies))
    torch.cuda.synchronize()
    (cpu_toks, cpu_logits, cpu_cow), (gpu_toks, gpu_logits, gpu_cow) = runs
    assert gpu_toks == cpu_toks and gpu_cow == cpu_cow == 2
    for a, b in zip(gpu_logits, cpu_logits):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
    counts = ops.launch_counts()
    assert counts["paged_attention"] == cfg.n_layers * 4
    assert counts["page_copy_stacked"] == 1          # one materialize: K and V in one launch


# the cluster split's edges: (B, KVH, G, D, page_size, P, max_pages, lengths, split it must take)
SPLIT_CASES = [
    (3, 8, 5, 128, 16, 1024, 256, [0, 1, 2000], 8),     # lengths 0, 1 and ~2000 in one batch
    (1, 8, 5, 128, 16, 64, 64, [20], 16),                # 2 active pages over 16 blocks
    (1, 8, 5, 128, 16, 1024, 256, [2043], 16),           # B = 1 at the served width
    (2, 2, 8, 256, 16, 64, 64, [1000, 7], 16),           # largest shared memory and registers
    (2, 2, 4, 128, 16, 64, 37, [592, 300], 8),           # 37 pages over 8 blocks
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,G,D,psz,P,maxp,lens,split", SPLIT_CASES)
def test_cuda_paged_attention_split_edges(cuda, dtype, B, KVH, G, D, psz, P, maxp, lens, split):
    from repro_torch.kernels.paged_attention import split_count

    assert split_count(B, KVH, maxp) == split
    gen = torch.Generator(device=cuda).manual_seed(P + maxp + G)
    q = torch.randn((B, KVH, G, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((P, psz, KVH, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, psz, KVH, D), generator=gen, device=cuda).to(dtype)
    table = torch.randint(0, P, (B, maxp), generator=gen, device=cuda, dtype=torch.int32)
    seq = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.paged_attention(q, k, v, table, seq)
    want = ref.paged_attention_ref(q, k, v, table, seq)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for b, n in enumerate(lens):
        assert n > 0 or not got[b].any()
    assert ops.launch_counts()["paged_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("N,C,n_valid,M,misaligned", [
    (128, 1310720, 2, 2, False),     # the serving restore: 2 page rows of 1.31 MB
    (37, 10000, 12, 16, False),      # 16-byte rows, a ragged last 4 KiB segment
    (37, 5001, 12, 16, False),       # rows that are not 16-byte aligned: the byte path
    (37, 4096, 9, 16, True),         # a misaligned data pointer: the byte path
    (8, 65536, 0, 8, False),         # only padding
])
def test_cuda_delta_apply_segments(cuda, N, C, n_valid, M, misaligned):
    gen = torch.Generator(device=cuda).manual_seed(N + C)
    base = torch.randint(0, 256, (N, C), generator=gen, device=cuda, dtype=torch.uint8)
    data = torch.randint(0, 256, (M, C), generator=gen, device=cuda, dtype=torch.uint8)
    if misaligned:
        data = torch.empty(M * C + 1, dtype=torch.uint8, device=cuda)[1:].view(M, C).copy_(data)
        assert data.data_ptr() % 16
    idx = torch.full((M,), -1, dtype=torch.int32, device=cuda)
    idx[:n_valid] = torch.randperm(N, generator=gen, device=cuda)[:n_valid].to(torch.int32)
    want = ref.delta_apply_ref(base, data, idx)
    ops.reset_launch_counts()
    got = ops.delta_apply(base.clone(), data, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.launch_counts()["delta_apply"] == 1


@pytest.mark.gpu
def test_cuda_served_attention_launch_fits_one_wave(cuda):
    """The served decode launch (B = 4 forks, 8 kv heads, 256-page table:
    32 clusters of 8 bf16 blocks) fits the card at once, so no cluster
    waits for a second wave."""
    from repro_torch.kernels.paged_attention import max_active_clusters, split_count

    split = split_count(4, 8, 256)
    assert split == 8
    assert max_active_clusters(5, 128, torch.bfloat16, split) >= 4 * 8


def _fused_pair(gen, N, C, n_dirty, device, misaligned=False):
    """Two (N, C) grids differing in ``n_dirty`` random rows (one byte
    each, at a random column)."""
    if misaligned:
        old = torch.empty(N * C + 1, dtype=torch.uint8, device=device)[1:].view(N, C)
        old.copy_(torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8))
        assert old.data_ptr() % 16
    else:
        old = torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8)
    new = old.clone()
    rows = torch.randperm(N, generator=gen, device=device)[:n_dirty]
    cols = torch.randint(0, C, (n_dirty,), generator=gen, device=device)
    new[rows, cols] ^= 0x5A
    return old, new


def _assert_fused_equal(got, old, new, cap):
    want = ref.fused_encode_ref(old, new, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("N,C,n_dirty,cap,misaligned", [
    (5000, 96, 1500, 2048, False),      # 40 tiles of 128 rows: look-back past 32 tiles
    (20000, 2048, 3000, 4096, False),   # 625 tiles of 32 rows
    (200000, 96, 5000, 8192, False),    # 1,563 tiles: more than 132 SMs x 8 blocks hold
    (37, 256, 9, 300, False),           # cap > N: two tiles past the rows
    (300, 96, 200, 64, False),          # overflow: count > cap
    (256, 65536, 0, 128, False),        # all clean at the dump path's shape
    (256, 65536, 256, 128, False),      # all dirty, overflow, one row a tile
    (37, 256, 9, 16, True),             # misaligned pointer: the byte path
    (700, 100, 250, 512, False),        # rows that are not 16-byte multiples
])
def test_cuda_delta_fused_one_pass_edges(cuda, N, C, n_dirty, cap, misaligned):
    gen = torch.Generator(device=cuda).manual_seed(N + C + cap)
    old, new = _fused_pair(gen, N, C, n_dirty, cuda, misaligned)
    ops.reset_launch_counts()
    got = ops.delta_fused(old, new, max_changed=cap)
    torch.cuda.synchronize()
    _assert_fused_equal(got, old, new, cap)
    assert int(got[2]) == n_dirty
    assert ops.launch_counts()["delta_fused"] == 1


@pytest.mark.gpu
def test_cuda_delta_fused_back_to_back_calls(cuda):
    """100 calls queued without a synchronisation, each with its own
    scratch, all equal to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    old, new = _fused_pair(gen, 256, 65536, 8, cuda)
    outs = [ops.delta_fused(old, new, max_changed=128) for _ in range(100)]
    torch.cuda.synchronize()
    for got in outs:
        _assert_fused_equal(got, old, new, 128)


@pytest.mark.gpu
def test_cuda_delta_fused_graph_replays(cuda):
    """One call captured in a CUDA graph and replayed 20 times over new
    dirty rows each time: the memset node resets the ticket and the status
    words before every replay."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    N, C, cap = 512, 2048, 64
    old, new = _fused_pair(gen, N, C, 10, cuda)
    ops.delta_fused(old, new, max_changed=cap)            # build, warm the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.delta_fused(old, new, max_changed=cap)
    for i in range(20):
        new.copy_(old)
        rows = torch.randperm(N, generator=gen, device=cuda)[: 5 + 4 * i]
        new[rows, i] ^= 0x33
        graph.replay()
        torch.cuda.synchronize()
        _assert_fused_equal(out, old, new, cap)
        assert int(out[2]) == 5 + 4 * i


@pytest.mark.gpu
def test_cuda_delta_fused_from_two_threads(cuda):
    """Two host threads, each on its own stream, calling at once."""
    import threading

    gen = torch.Generator(device=cuda).manual_seed(13)
    grids = [_fused_pair(gen, 4096, 2048, 300, cuda), _fused_pair(gen, 256, 65536, 8, cuda)]
    wants = [ref.fused_encode_ref(o, n, 128) for o, n in grids]
    torch.cuda.synchronize()
    errors = []

    def work(k):
        try:
            stream = torch.cuda.Stream(device=cuda)
            old, new = grids[k]
            with torch.cuda.stream(stream):
                outs = [ops.delta_fused(old, new, max_changed=128) for _ in range(20)]
            stream.synchronize()
            for got in outs:
                for g, w in zip(got, wants[k]):
                    if not torch.equal(g, w):
                        errors.append(k)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


@pytest.mark.gpu
@pytest.mark.parametrize("n_pools,n_pairs,launches", [
    (1, 4, 1), (2, 4, 1), (8, 4, 1), (2, 300, 2), (9, 300, 4),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_page_copy_stacked_over_pools(cuda, n_pools, n_pairs, launches, dtype):
    """Several pools in one call: one launch for up to 8 pools and 256
    pairs, chunks beyond, every pool bit-exact with its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(n_pools * 1000 + n_pairs)
    P = 2 * n_pairs + 8
    pools = [torch.randn((3, P, 16, 2, 64), generator=gen, device=cuda).to(dtype)
             for _ in range(n_pools)]
    perm = torch.randperm(P, generator=gen, device=cuda).tolist()
    src, dst = perm[:n_pairs], perm[n_pairs : 2 * n_pairs]
    wants = [ref.page_copy_stacked_ref(p, torch.tensor(src), torch.tensor(dst)) for p in pools]
    ops.reset_launch_counts()
    got = ops.page_copy_stacked(pools, src, dst)
    torch.cuda.synchronize()
    assert got is pools
    for p, w in zip(pools, wants):
        assert torch.equal(p, w)
    assert ops.launch_counts()["page_copy_stacked"] == launches


@pytest.mark.gpu
def test_cuda_page_copy_unaligned_pages(cuda):
    """Pages of 5 x 3 bytes are not 16-byte multiples: the byte path."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    pools = [torch.randint(0, 256, (2, 12, 5, 3), generator=gen, device=cuda, dtype=torch.uint8)
             for _ in range(2)]
    wants = [ref.page_copy_stacked_ref(p, torch.tensor([1, 2]), torch.tensor([7, 9]))
             for p in pools]
    ops.page_copy_stacked(pools, [1, 2], [7, 9])
    torch.cuda.synchronize()
    for p, w in zip(pools, wants):
        assert torch.equal(p, w)


# ---------------------------------------------------------------------------
# persistence: a CUDA chain saved and recovered onto the card
# ---------------------------------------------------------------------------
def _saved_cuda_chain(cuda, root, fused):
    """Three checkpoints of a CUDA state under a StateManager, saved to
    ``root``; returns the current checkpoint's bytes and its id."""
    from repro_torch.core import DeltaFS, Sandbox, StateManager, save_state

    gen = torch.Generator(device=cuda).manual_seed(11)
    state = CowTensorState(
        {
            "kv": torch.randn((512, 8, 128), generator=gen, device=cuda).to(torch.bfloat16),
            "heap": torch.randn(1 << 20, generator=gen, device=cuda),
        },
        device=cuda,
    )
    fs = DeltaFS(chunk_bytes=1 << 16)
    fs.write("repo/a", np.arange(4096, dtype=np.int32))
    cr = DeltaCR(store=fs.store, restore_fn=lambda p: CowTensorState(p, device=cuda),
                 policy=DumpPolicy(mode="delta", fused_kernel=fused), chunk_bytes=1 << 16)
    sm = StateManager(Sandbox(fs, state), cr)
    for c in range(3):
        if c:
            sm.sandbox.proc.mutate("kv", lambda t, c=c: t[64 * c : 64 * c + 64].fill_(float(c)))
            sm.sandbox.proc.mutate("heap", lambda t, c=c: t[9000 * c : 9000 * c + 5].add_(1.0))
        current = sm.checkpoint()
    cr.wait_dumps()
    save_state(root, sm=sm)
    want = state_to_numpy(sm.sandbox.proc)
    cr.shutdown()
    return want, current


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_chain_recovers_onto_the_card(cuda, tmp_path, fused):
    """Recovered with ``device="cuda"``: the rebuilt anchors are CUDA uint8
    tensors, the trunk's restore scatters with ``delta_apply`` over the
    anchored parent, and the first dump after it is on the kernel path
    (``delta_fused``, or ``delta_diff`` with the fused plan off) with no
    tensor on the full path."""
    from repro_torch.core import recover

    root = str(tmp_path / "root")
    want, current = _saved_cuda_chain(cuda, root, fused)
    ops.reset_launch_counts()
    rec = recover(root, device="cuda", policy=DumpPolicy(mode="delta", fused_kernel=fused))
    cr, sm = rec.deltacr, rec.state_manager
    try:
        torch.cuda.synchronize()
        assert ops.launch_counts()["delta_apply"] > 0
        assert rec.trunk_restore_mode == "slow" and rec.current == current
        anchors = cr.pipeline.anchored_ids()
        assert anchors
        for image_id in anchors:
            record = cr.pipeline.record_for(image_id)
            try:
                for view in record.views.values():
                    assert isinstance(view.grid, torch.Tensor)
                    assert view.grid.device.type == "cuda" and view.grid.dtype == torch.uint8
            finally:
                cr.pipeline.release_record(record)
        for k, v in state_to_numpy(sm.sandbox.proc).items():
            np.testing.assert_array_equal(v, want[k])
        sm.sandbox.proc.mutate("heap", lambda t: t[:3].add_(2.0))
        kernel_before, full_before = cr.stats.kernel_keys, cr.stats.full_keys
        ops.reset_launch_counts()
        c = sm.checkpoint()
        cr.wait_dumps()
        torch.cuda.synchronize()
        assert cr.dump_future(c).result().mode == "delta"
        assert cr.stats.full_keys == full_before
        assert cr.stats.kernel_keys > kernel_before         # the dirtied heap
        counts = ops.launch_counts()
        assert counts["delta_fused" if fused else "delta_diff"] > 0
    finally:
        cr.shutdown()


@pytest.mark.gpu
def test_cuda_anchor_upload_failure_raises(cuda, tmp_path, monkeypatch):
    """A failed upload of a rebuilt anchor fails the recovery; it never
    leaves a host grid behind."""
    from repro_torch.core import delta_pipeline, recover

    root = str(tmp_path / "root")
    _saved_cuda_chain(cuda, root, True)

    def fail(grid, device):
        raise torch.cuda.OutOfMemoryError("upload failed")

    monkeypatch.setattr(delta_pipeline, "_upload_grid", fail)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        recover(root, device="cuda")


def _tiny_trainer(device, steps=1, ckpt_every=0):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig

    cfg = get_config("olmo-1b-tiny")
    return Trainer(
        Model(cfg, device=device),
        OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4),
        TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=1, microbatches=2),
    )


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """One float32 olmo-1b-tiny train step (2 microbatches, AdamW) on the
    card with TF32 off, against the same step on the CPU from the same
    params: the loss within 1e-5 relative, every param within 1e-5 of
    its leaf's largest magnitude (float32 sums in other orders; AdamW's
    first step is about lr × sign(g), so a gradient near 0 can move its
    param by up to lr = 1e-3 × its relative error)."""
    from repro_torch.train.optim import adamw_init, tree_map, tree_paths

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu_tr = _tiny_trainer("cpu")
        params, _, _ = cpu_tr.init_state(5)
        gpu_tr = _tiny_trainer(cuda)
        gparams = tree_map(lambda t: t.to(cuda), params)
        p_cpu, *_ = cpu_tr.run(params, adamw_init(params, cpu_tr.opt_cfg), torch.zeros(()))
        p_gpu, *_ = gpu_tr.run(gparams, adamw_init(gparams, gpu_tr.opt_cfg),
                               torch.zeros((), device=cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    want, got = cpu_tr.metrics_log[0]["loss"], gpu_tr.metrics_log[0]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want)
    for (path, a), (_, b) in zip(tree_paths(p_cpu), tree_paths(p_gpu)):
        assert b.device.type == "cuda"
        err = float((b.cpu() - a).abs().max())
        assert err <= 1e-5 * max(float(a.abs().max()), 1.0), (path, err)


@pytest.mark.gpu
def test_cuda_checkpoint_restore_is_bit_exact(cuda):
    """A coupled checkpoint of CUDA params and moments (device clone, side
    stream copy to the host DeltaFS) restores onto the card bit for bit."""
    from repro_torch.train.optim import tree_map, tree_paths

    tr = _tiny_trainer(cuda, steps=2, ckpt_every=2)
    snaps = {}
    checkpoint = tr.checkpoint

    def keep(step, p, o):
        snaps.update(params=tree_map(torch.clone, p), opt=tree_map(torch.clone, o))
        checkpoint(step, p, o)

    tr.checkpoint = keep
    p, o, e = tr.init_state(0)
    tr.run(p, o, e)
    p2, o2, _, step = tr.restore_latest()
    assert step == 2
    for got_tree, want_tree in ((p2, snaps["params"]), (o2, snaps["opt"])):
        got, want = dict(tree_paths(got_tree)), dict(tree_paths(want_tree))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), path
