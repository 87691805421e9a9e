"""The serving kernels of the port against the JAX package's.

The port's CPU route (the plain versions in ``repro_torch.kernels.ref``)
against ``repro.kernels.ops`` on the same numpy inputs, the JAX side
running its Pallas kernels in interpret mode as its own tests do.  The
sweeps are those of the JAX package's ``tests/test_kernels.py``;
``page_copy_stacked``, which the reference does not sweep, gets one here.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RNG = np.random.default_rng(42)

PA_CASES = [
    # B, KVH, G, D, page_size, P, max_pages, dtype
    (1, 1, 1, 128, 16, 8, 2, "float32"),
    (2, 2, 4, 128, 64, 16, 4, "float32"),
    (3, 4, 2, 128, 32, 12, 3, "float32"),
    (2, 1, 8, 256, 16, 8, 4, "float32"),         # MQA, gemma head_dim
    (2, 2, 5, 128, 16, 8, 3, "float32"),         # odd group (qwen3 G=5)
    (2, 2, 4, 64, 16, 8, 3, "float32"),          # musicgen head_dim
    (2, 2, 4, 128, 64, 16, 4, "bfloat16"),
]


def _pair(x, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``
    (both round the float32 values to bfloat16 to nearest-even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _attention_case(B, KVH, G, D, psz, P, maxp, dtype, lens):
    jq, q = _pair(RNG.standard_normal((B, KVH, G, D)), dtype)
    jk, k = _pair(RNG.standard_normal((P, psz, KVH, D)), dtype)
    jv, v = _pair(RNG.standard_normal((P, psz, KVH, D)), dtype)
    table = RNG.integers(0, P, size=(B, maxp)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    want = jops.paged_attention(jq, jk, jv, jnp.asarray(table), jnp.asarray(lens))
    got = ops.paged_attention(q, k, v, torch.from_numpy(table), torch.from_numpy(lens))
    assert got.dtype == q.dtype and got.shape == q.shape
    return _to_np(got), _to_np(want)


@pytest.mark.parametrize("B,KVH,G,D,psz,P,maxp,dtype", PA_CASES)
def test_paged_attention_matches_reference(B, KVH, G, D, psz, P, maxp, dtype):
    lens = RNG.integers(1, maxp * psz + 1, size=(B,))
    got, want = _attention_case(B, KVH, G, D, psz, P, maxp, dtype, lens)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("lens", [[16, 1], [48, 15]], ids=["page-boundary", "length-1"])
def test_paged_attention_length_edges(lens):
    """seq_len exactly on a page boundary, the whole table, and length 1."""
    got, want = _attention_case(2, 1, 2, 128, 16, 6, 3, "float32", lens)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_paged_attention_empty_session_gives_zero():
    """seq_len == 0 gives 0, as the Pallas kernel does (its jnp oracle
    would give NaN)."""
    got, want = _attention_case(2, 2, 5, 128, 16, 8, 3, "float32", [0, 17])
    assert not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("P,psz,KVH,D", [(8, 16, 2, 128), (12, 64, 1, 256), (6, 16, 4, 64)])
def test_page_copy_matches_reference(P, psz, KVH, D, dtype):
    x = RNG.standard_normal((P, psz, KVH, D)) * 100
    jpool, pool = _pair(x, dtype)
    n = P // 2 - 1
    perm = RNG.permutation(P)
    src, dst = perm[:n].astype(np.int32), perm[n : 2 * n].astype(np.int32)
    want = jops.page_copy(jpool, jnp.asarray(src), jnp.asarray(dst))
    got = ops.page_copy(pool, src, dst)
    assert got is pool
    np.testing.assert_array_equal(_to_np(got), _to_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("N,P,psz,KVH,D,n", [
    (1, 8, 16, 2, 128, 3), (3, 12, 8, 1, 256, 5), (2, 6, 16, 4, 64, 1), (4, 16, 4, 2, 16, 7),
])
def test_page_copy_stacked_matches_reference(N, P, psz, KVH, D, n, dtype):
    x = RNG.standard_normal((N, P, psz, KVH, D)) * 100
    jpool, pool = _pair(x, dtype)
    perm = RNG.permutation(P)
    src, dst = perm[:n].astype(np.int32), perm[n : 2 * n].astype(np.int32)
    want = jops.page_copy_stacked(jpool, jnp.asarray(src), jnp.asarray(dst))
    got = ops.page_copy_stacked(pool, list(src), list(dst))
    assert got is pool
    np.testing.assert_array_equal(_to_np(got), _to_np(want))
    np.testing.assert_array_equal(
        _to_np(ref.page_copy_stacked_ref(torch.from_numpy(x).to(pool.dtype), torch.from_numpy(src),
                                         torch.from_numpy(dst))),
        _to_np(want),
    )


@pytest.mark.parametrize("n_pools", [1, 2, 3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_copy_stacked_over_a_sequence_of_pools(n_pools, dtype):
    """Several pools of one shape in one call (a pool's K and V of every
    sublayer; 9 pools take two chunks on the card): each equals the JAX
    ``page_copy_stacked`` applied to that pool alone."""
    N, P, psz, KVH, D, n = 3, 12, 4, 2, 16, 5
    pairs = [_pair(RNG.standard_normal((N, P, psz, KVH, D)) * 100, dtype) for _ in range(n_pools)]
    perm = RNG.permutation(P)
    src, dst = perm[:n].astype(np.int32), perm[n : 2 * n].astype(np.int32)
    pools = [t for _, t in pairs]
    got = ops.page_copy_stacked(pools, src, dst)
    assert got is pools
    for (jpool, _), pool in zip(pairs, pools):
        want = jops.page_copy_stacked(jpool, jnp.asarray(src), jnp.asarray(dst))
        np.testing.assert_array_equal(_to_np(pool), _to_np(want))


@pytest.mark.parametrize("other", [
    torch.zeros((2, 9, 4, 2, 8)),                        # another page count
    torch.zeros((2, 8, 4, 2, 8), dtype=torch.bfloat16),  # another dtype
    torch.zeros((3, 8, 4, 2, 8)),                        # another period count
])
def test_page_copy_stacked_refuses_mixed_pools(other):
    pool = torch.arange(2 * 8 * 4 * 2 * 8, dtype=torch.float32).reshape(2, 8, 4, 2, 8)
    before = pool.clone()
    with pytest.raises(ValueError, match="pools differ"):
        ops.page_copy_stacked([pool, other], [1, 2], [3, 4])
    assert torch.equal(pool, before)
    with pytest.raises(ValueError):
        ops.page_copy_stacked([], [1], [3])


def test_cpu_tensors_never_launch_the_serving_kernels():
    ops.reset_launch_counts()
    pool = torch.zeros((2, 8, 4, 2, 64))
    ops.page_copy_stacked(pool, [1, 2], [3, 4])
    ops.page_copy(pool[0].clone(), [1], [5])
    q = torch.zeros((1, 2, 2, 64))
    ops.paged_attention(q, pool[0], pool[1], torch.zeros((1, 3), dtype=torch.int32),
                        torch.tensor([5], dtype=torch.int32))
    assert all(n == 0 for n in ops.launch_counts().values())
    assert set(ops.launch_counts()) == {
        "delta_diff", "delta_fused", "delta_apply", "page_copy", "page_copy_stacked",
        "paged_attention",
    }


@pytest.mark.parametrize("src,dst,what", [
    ([1, 2], [3, 3], "distinct"),
    ([1, 2], [2, 4], "overlap"),
    ([1, 2], [3], "destinations"),
    ([1, 9], [3, 4], "outside"),
])
def test_page_copy_checks_the_allocator_invariants(src, dst, what):
    pool = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    before = pool.clone()
    with pytest.raises(ValueError, match=what):
        ops.page_copy_stacked(pool, src, dst)
    assert torch.equal(pool, before)


def test_paged_attention_checks_its_inputs():
    q = torch.zeros((1, 2, 2, 64))
    pages = torch.zeros((4, 8, 2, 64))
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.paged_attention(q, pages, pages, torch.zeros((1, 2), dtype=torch.int64), lens)
    with pytest.raises(ValueError):
        ops.paged_attention(q, pages[:, :, :1], pages, torch.zeros((1, 2), dtype=torch.int32), lens)
    with pytest.raises(ValueError):
        ops.paged_attention(q, pages, pages, torch.zeros((2, 2), dtype=torch.int32), lens)
