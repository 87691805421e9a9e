"""The host side of the port's split-K ``paged_attention``.

``split_count`` picks the blocks per (sequence, kv head) cluster from
shapes alone.  A plain model of the kernel's partition and merge (each
block's pages ``[r·n/S, (r+1)·n/S)``, a per-block float32 softmax that is
``m = -1e30, l = 0`` without pages, the log-sum-exp combine) is held
against ``ref.paged_attention_ref`` on the CPU, with empty blocks, empty
sessions and tables whose width is not a multiple of the split.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (
    H100_SMS,
    MAX_SPLIT,
    MIN_PAGES_PER_BLOCK,
    split_count,
)

torch.set_num_threads(1)

NEG = -1e30


def test_split_covers_the_sms_at_the_served_shape():
    """B = 4 forks of a qwen3-14b session (8 kv heads, 256-page table):
    32 clusters of 8 blocks, 256 blocks over 132 SMs."""
    s = split_count(4, 8, 256)
    assert s == 8 and 4 * 8 * s >= H100_SMS


def test_split_is_largest_for_one_session():
    assert split_count(1, 8, 256) == MAX_SPLIT == 16


@pytest.mark.parametrize("max_pages", [1, 2, 3, 4, 7])
def test_split_is_one_for_a_narrow_table(max_pages):
    assert split_count(1, 1, max_pages) == 1
    assert split_count(4, 8, max_pages) == 1


def test_split_is_one_when_the_heads_fill_the_card():
    assert split_count(17, 8, 256) == 1
    assert split_count(64, 8, 4096) == 1


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 16, 33])
@pytest.mark.parametrize("KVH", [1, 2, 8])
@pytest.mark.parametrize("max_pages", [1, 5, 8, 9, 37, 64, 256, 1000])
def test_split_bounds(B, KVH, max_pages):
    s = split_count(B, KVH, max_pages)
    assert 1 <= s <= min(MAX_SPLIT, max_pages)
    assert s & (s - 1) == 0                                  # a power of two
    assert s == 1 or max_pages // s >= MIN_PAGES_PER_BLOCK
    if max_pages >= MAX_SPLIT * MIN_PAGES_PER_BLOCK and B * KVH * MAX_SPLIT >= H100_SMS:
        assert B * KVH * s >= H100_SMS                       # a wide table covers the SMs
    # the smallest split that does: half of it would leave SMs without a block
    if s > 1 and max_pages // (2 * s) >= MIN_PAGES_PER_BLOCK and s < MAX_SPLIT:
        assert B * KVH * (s // 2) < H100_SMS


def _split_model(q, k_pages, v_pages, table, lens, split, scale):
    """The kernel's arithmetic in float64, one block at a time."""
    B, KVH, G, D = q.shape
    psz = k_pages.shape[1]
    out = torch.zeros((B, KVH, G, D), dtype=torch.float64)
    for b in range(B):
        seq = max(0, min(int(lens[b]), table.shape[1] * psz))
        n_pages = -(-seq // psz)
        for h in range(KVH):
            qf = q[b, h].double() * scale
            parts = []
            for r in range(split):
                lo, hi = r * n_pages // split, (r + 1) * n_pages // split
                m = torch.full((G,), NEG, dtype=torch.float64)
                l = torch.zeros(G, dtype=torch.float64)
                acc = torch.zeros((G, D), dtype=torch.float64)
                for i in range(lo, hi):
                    page = int(table[b, i])
                    pos = i * psz + torch.arange(psz)
                    ok = pos < seq
                    s = qf @ k_pages[page, :, h].double().T                        # (G, psz)
                    masked = torch.where(ok, s, torch.full_like(s, NEG))
                    m_new = torch.maximum(m, masked.amax(1))
                    p = torch.where(ok, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ v_pages[page, :, h].double()
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).amax(0)
            coef = [torch.exp(p[0] - mx) for p in parts]
            total = sum(c * p[1] for c, p in zip(coef, parts))
            safe = torch.where(total > 0, total, torch.ones_like(total))
            inv = torch.where(total > 0, 1.0 / safe, torch.zeros_like(total))
            out[b, h] = sum((c * inv)[:, None] * p[2] for c, p in zip(coef, parts))
    return out


@pytest.mark.parametrize("B,KVH,G,D,psz,P,maxp,lens", [
    (3, 2, 5, 64, 16, 40, 37, [0, 1, 590]),          # lengths 0, 1 and long; 37 pages over 8
    (1, 2, 8, 64, 16, 20, 16, [20]),                 # 2 active pages over 4 blocks
    (2, 1, 2, 64, 4, 40, 33, [130, 3]),              # short pages, a tail page part-full
    (1, 8, 1, 64, 16, 80, 64, [1024]),               # every page of the table, 16 blocks
])
def test_split_merge_model_matches_the_plain_version(B, KVH, G, D, psz, P, maxp, lens):
    rng = np.random.default_rng(B * maxp + G)
    q = torch.from_numpy(rng.standard_normal((B, KVH, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((P, psz, KVH, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((P, psz, KVH, D)).astype(np.float32))
    table = torch.from_numpy(rng.integers(0, P, size=(B, maxp)).astype(np.int32))
    seq = torch.tensor(lens, dtype=torch.int32)
    split = split_count(B, KVH, maxp)
    assert split > 1
    got = _split_model(q, k, v, table, seq, split, D ** -0.5)
    want = ref.paged_attention_ref(q, k, v, table, seq).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    for b, n in enumerate(lens):
        assert n > 0 or not got[b].any()
