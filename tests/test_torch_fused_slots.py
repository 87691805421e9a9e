"""The one-launch ``delta_fused`` kernel's slot rule, modelled on the CPU.

The CUDA kernel (``csrc/delta_fused.cu``) cannot run here, so its
arithmetic is held to its contract through a numpy model of the same
rule: tiles of ``tile_rows(C)`` rows taken in ticket order, each tile's
dirty count published as an aggregate, a look-back over 32 predecessors'
status words at a time (a warp, a word a lane) until an inclusive prefix
is met (which predecessors already show their prefix is drawn from a
seeded generator, as the card's scheduling would decide it), a dirty row
emitted to slot ``incl - 1``, a clean row zeroing slot ``incl + N - 1 -
r``, and tiles past the last row zeroing ``[N, cap)``.  The model must
give exactly ``ref.fused_encode_ref``'s outputs and write every slot of
``[0, cap)`` exactly once.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.delta_fused import (
    MAX_TILE_ROWS,
    TILE_BYTES,
    scratch_bytes,
    tile_count,
    tile_rows,
)
from repro_torch.kernels.ops import chunk_checksums_host

torch.set_num_threads(1)

LOOK = 32                   # predecessors one look-back step reads


def one_pass_model(old, new, cap, rng, p_prefix):
    """(data, idx, count, sums, writes per slot, most windows one look-back
    read) of the kernel's rule on (N, C) uint8 grids."""
    N, C = old.shape
    R = tile_rows(C)
    row_tiles, zero_tiles = tile_count(N, C, cap)
    flags = (old != new).any(axis=1).astype(np.int64)
    data = np.full((cap, C), 0xAB, np.uint8)          # poison: every slot must be written
    idx = np.full((cap,), -7, np.int32)
    sums = np.full((cap, 4), 0xDEADBEEF, np.uint32)
    writes = np.zeros((cap,), np.int64)
    agg = np.zeros((row_tiles,), np.int64)
    incl_of = np.zeros((row_tiles,), np.int64)
    count = None
    windows_max = 0

    def word(p):
        """Predecessor p's status word as a lane of the look-back sees it."""
        if p < 0:
            return "P", 0                              # before tile 0: prefix 0
        if p == 0 or rng.random() < p_prefix:          # tile 0 publishes its prefix at once
            return "P", incl_of[p]
        return "A", agg[p]

    for tile in range(row_tiles):                      # ticket order
        r0 = tile * R
        f = flags[r0 : r0 + R]
        agg[tile] = f.sum()
        excl, windows = 0, 0
        if tile > 0:
            j = tile - 1
            while True:
                windows += 1
                # lane l reads the word l places behind j
                words = [word(j - d) for d in range(LOOK)]
                stop = next((d for d, (s, _) in enumerate(words) if s == "P"), None)
                excl += sum(v for _, v in words[: (LOOK if stop is None else stop + 1)])
                if stop is not None:
                    break
                j -= LOOK
        windows_max = max(windows_max, windows)
        incl_of[tile] = excl + agg[tile]
        for i, incl in enumerate(excl + np.cumsum(f)):
            r = r0 + i
            if f[i]:
                s = incl - 1
                if s < cap:
                    data[s], idx[s], sums[s] = new[r], r, chunk_checksums_host(new[r])[0]
                    writes[s] += 1
            else:
                z = incl + (N - 1 - r)
                if z < cap:
                    data[z], idx[z], sums[z] = 0, -1, 0
                    writes[z] += 1
        if r0 + len(f) == N:
            count = incl_of[tile]
    for t in range(zero_tiles):
        for z in range(N + t * R, min(N + (t + 1) * R, cap)):
            data[z], idx[z], sums[z] = 0, -1, 0
            writes[z] += 1
    if N == 0:
        count = 0
    return data, idx, count, sums, writes, windows_max


def _grids(rng, N, C, dirty):
    old = rng.integers(0, 256, size=(N, C), dtype=np.uint8)
    new = old.copy()
    for r in dirty:
        k = int(rng.integers(C))
        new[r, k] ^= np.uint8(1 + rng.integers(255))   # one byte anywhere in the row
    return old, new


CASES = [
    # (name, N, C, dirty rows (count, or "all"), cap)
    ("all-clean", 300, 96, 0, 16),
    ("all-dirty", 300, 96, "all", 300),
    ("all-dirty-cap-above-n", 300, 96, "all", 512),
    ("overflow", 300, 96, 200, 64),
    ("count-equals-cap", 300, 96, 64, 64),
    ("cap-above-n", 37, 256, 9, 64),
    ("cap-above-n-ragged-zero-tiles", 37, 256, 9, 37 + 129),
    ("n-1-dirty", 1, 128, 1, 4),
    ("n-1-clean", 1, 128, 0, 1),
    ("many-tiles", 5000, 96, 1500, 2048),             # 40 tiles: look-back past 32
    ("more-tiles", 20000, 96, 4000, 8192),            # 157 tiles
    ("2kib-rows", 2000, 2048, 300, 256),              # 32-row tiles, 63 tiles
    ("one-row-tiles", 70, 65536, 9, 16),              # the dump path's rows
    ("eight-row-tiles", 400, 8192, 40, 64),           # a block per row, 8 rows a tile
    ("odd-rows", 700, 100, 250, 128),                 # rows that are not 16-byte multiples
]


@pytest.mark.parametrize("p_prefix", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("name,N,C,n_dirty,cap", CASES, ids=[c[0] for c in CASES])
def test_one_pass_rule_matches_plain_version(name, N, C, n_dirty, cap, p_prefix):
    rng = np.random.default_rng(N * 7919 + C + cap)
    k = N if n_dirty == "all" else n_dirty
    old, new = _grids(rng, N, C, rng.choice(N, size=k, replace=False))
    data, idx, count, sums, writes, windows = one_pass_model(old, new, cap, rng, p_prefix)
    want = ref.fused_encode_ref(torch.from_numpy(old), torch.from_numpy(new), cap)
    np.testing.assert_array_equal(data, want[0].numpy())
    np.testing.assert_array_equal(idx, want[1].numpy())
    assert count == int(want[2]) == k
    np.testing.assert_array_equal(sums, want[3].numpy())
    np.testing.assert_array_equal(writes, np.ones((cap,), np.int64))   # each slot once
    row_tiles = tile_count(N, C, cap)[0]
    if p_prefix == 0.0 and row_tiles > LOOK + 1:
        assert windows >= 2                                             # past one step


def test_one_pass_rule_on_an_empty_grid():
    """N = 0: tiles past the last row zero every slot and count is 0."""
    old = np.zeros((0, 64), np.uint8)
    data, idx, count, sums, writes, _ = one_pass_model(old, old, 5, np.random.default_rng(0), 0.5)
    assert count == 0 and not data.any() and (idx == -1).all() and not sums.any()
    assert (writes == 1).all()


@pytest.mark.parametrize("C,rows", [(100, 128), (128, 128), (2048, 32), (65536, 1),
                                    (1310720, 1)])
def test_tile_rows(C, rows):
    assert tile_rows(C) == rows


@pytest.mark.parametrize("C", [1, 7, 96, 100, 512, 513, 4096, 8192, 8193, 65535, 65536, 70000])
def test_tile_rows_is_the_fewest_rows_that_reach_the_tile_bytes(C):
    """At most MAX_TILE_ROWS; below that, the fewest whole rows giving a
    block at least TILE_BYTES of each grid."""
    R = tile_rows(C)
    assert 1 <= R <= MAX_TILE_ROWS
    if R < MAX_TILE_ROWS:
        assert R * C >= TILE_BYTES and (R == 1 or (R - 1) * C < TILE_BYTES)


@pytest.mark.parametrize("N,C,cap,tiles,bytes_", [
    (256, 65536, 128, (256, 0), 16 + 8 * 256),       # the C/R checkpoint's KV tensors
    (37, 256, 64, (1, 1), 16 + 8),                   # cap > N: one tile past the rows
    (5000, 96, 2048, (40, 0), 16 + 8 * 40),
    (20000, 2048, 256, (625, 0), 16 + 8 * 625),
    (0, 64, 300, (0, 3), 16),
])
def test_tile_count_and_scratch(N, C, cap, tiles, bytes_):
    assert tile_count(N, C, cap) == tiles
    assert scratch_bytes(N, C) == bytes_
