"""The port's delta kernels against the JAX package's, bit for bit.

Both packages get the same numpy inputs.  On the JAX side the Pallas kernels
run in interpret mode (``REPRO_INTERPRET=1``, pinned by conftest); on the
port's side CPU tensors take the plain PyTorch versions.  The CUDA kernels
themselves are checked on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.delta_fused import delta_fused as jax_delta_fused
from repro_torch.core.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

RNG = np.random.default_rng(42)
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def _np(x):
    """Host bits of a JAX array or a torch tensor (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _pair(x):
    """The same bits as a JAX array and a CPU tensor."""
    j = jnp.asarray(x)
    return j, tensor_from_numpy(np.asarray(j))


def _assert_same(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_array_equal(_np(t), _np(j))
        assert _np(t).dtype == _np(j).dtype


# ------------------------------------------------------------- delta diff/apply
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("N,C", [(8, 128), (37, 256), (64, 512), (1, 128)])
def test_delta_roundtrip_sweep(N, C, dtype):
    """diff → compact → apply, each stage equal across packages."""
    old_np = np.asarray(jnp.asarray(RNG.standard_normal((N, C)), jnp.float32).astype(DTYPES[dtype]))
    n_dirty = max(1, N // 3)
    rows = RNG.choice(N, size=n_dirty, replace=False)
    new_np = np.asarray(jnp.asarray(old_np).at[rows].add(jnp.ones((n_dirty, C), DTYPES[dtype])))
    jold, told = _pair(old_np)
    jnew, tnew = _pair(new_np)
    jdirty, tdirty = jops.delta_diff(jold, jnew), tops.delta_diff(told, tnew)
    _assert_same([jdirty], [tdirty])
    cap = int(np.asarray(jdirty).sum()) + 2
    jc = jops.delta_compact(jnew, jdirty, cap)
    tc = tops.delta_compact(tnew, tdirty, cap)
    _assert_same(jc, tc)
    jrebuilt = jops.delta_apply(jold, jc[0], jc[1])
    trebuilt = tops.delta_apply(told.clone(), tc[0], tc[1])
    _assert_same([jrebuilt], [trebuilt])
    np.testing.assert_array_equal(_np(trebuilt), _np(jnew))


def test_delta_compact_overflow_drops():
    """More dirty chunks than capacity: the same 4 rows kept, true count."""
    jold, told = _pair(np.zeros((16, 64), np.float32))
    jnew, tnew = _pair(np.ones((16, 64), np.float32))
    jc = jops.delta_compact(jnew, jops.delta_diff(jold, jnew), 4)
    tc = tops.delta_compact(tnew, tops.delta_diff(told, tnew), 4)
    _assert_same(jc, tc)
    assert int(tc[2]) == 16 and int((tc[1] >= 0).sum()) == 4
    _assert_same(
        [jops.delta_apply(jold, jc[0], jc[1])], [tops.delta_apply(told.clone(), tc[0], tc[1])]
    )


def test_delta_apply_mutates_in_place_and_drops_padding():
    base = torch.zeros((6, 32), dtype=torch.uint8)
    data = torch.full((4, 32), 7, dtype=torch.uint8)
    idx = torch.tensor([4, -1, 1, -1], dtype=torch.int32)
    out = tops.delta_apply(base, data, idx)
    assert out is base
    assert base[[1, 4]].eq(7).all() and base[[0, 2, 3, 5]].eq(0).all()


# ------------------------------------------------------------- fused encode
@pytest.mark.parametrize("N,C,block", [(8, 128, 8), (37, 256, 8), (5, 64, 8), (64, 512, 16)])
def test_fused_encode_sweep(N, C, block):
    """Fused diff+compact+checksum over the byte grids the dump path feeds
    it (float32 rows viewed as bytes): data, idx, count and sums equal."""
    old_f = RNG.standard_normal((N, C)).astype(np.float32)
    n_dirty = max(1, N // 3)
    rows = RNG.choice(N, size=n_dirty, replace=False)
    new_f = old_f.copy()
    new_f[rows] += 1.0
    old_b, new_b = old_f.view(np.uint8), new_f.view(np.uint8)
    cap = n_dirty + 2
    jold, told = _pair(old_b)
    jnew, tnew = _pair(new_b)
    jout = jax_delta_fused(jold, jnew, max_changed=cap, chunk_block=block, interpret=True)
    tout = tops.fused_encode(told, tnew, cap)
    _assert_same(jout, tout)
    _assert_same(jref.fused_encode_ref(jold, jnew, cap), tref.fused_encode_ref(told, tnew, cap))
    assert int(tout[2]) == n_dirty
    rebuilt = tops.delta_apply(told.clone(), tout[0], tout[1])
    np.testing.assert_array_equal(rebuilt.numpy(), new_b)


def test_fused_encode_overflow_signals_count():
    jold, told = _pair(np.zeros((16, 64), np.uint8))
    jnew, tnew = _pair(np.ones((16, 64), np.uint8))
    jout = jops.fused_encode(jold, jnew, 4)
    tout = tops.fused_encode(told, tnew, 4)
    _assert_same(jout, tout)
    assert int(tout[2]) == 16 and int((tout[1] >= 0).sum()) == 4


def test_fused_checksums_match_host_mirror():
    """Checksum lanes: port == JAX, and the numpy mirrors of both packages
    agree with them over the fetched bytes."""
    rng = np.random.default_rng(7)
    old = rng.integers(0, 256, (12, 256), dtype=np.uint8)
    new = old.copy()
    new[[1, 4, 7]] ^= 0xA5
    jold, told = _pair(old)
    jnew, tnew = _pair(new)
    jout = jops.fused_encode(jold, jnew, 6)
    tdata, tidx, _, tsums = tops.fused_encode(told, tnew, 6)
    _assert_same(jout, (tdata, tidx, _, tsums))
    valid = tidx.numpy() >= 0
    fetched = tdata.numpy()[valid]
    want = tops.chunk_checksums_host(fetched)
    np.testing.assert_array_equal(want, jops.chunk_checksums_host(fetched))
    np.testing.assert_array_equal(want, tsums.numpy()[valid])
    np.testing.assert_array_equal(
        tref.chunk_checksums_ref(torch.from_numpy(fetched)).numpy(),
        np.asarray(jref.chunk_checksums_ref(jnp.asarray(fetched))),
    )
    tampered = fetched.copy()
    tampered[0, 0] ^= 0x01
    assert (tops.chunk_checksums_host(tampered) != want).any()


@settings(max_examples=8, deadline=None)
@given(st.integers(2, 40), st.integers(1, 6), st.floats(0.0, 1.0))
def test_encode_apply_property(n_chunks, c_scale, dirty_frac):
    """fused_encode, delta_encode and delta_apply equal across packages for
    random dirt patterns over uint8 byte grids."""
    C = 64 * c_scale
    rng = np.random.default_rng(n_chunks * 7919 + c_scale)
    old = rng.integers(0, 256, (n_chunks, C), dtype=np.uint8)
    mask = rng.random(n_chunks) < dirty_frac
    new = old.copy()
    new[mask] ^= 0x5A
    cap = max(1, n_chunks // 2)
    jold, told = _pair(old)
    jnew, tnew = _pair(new)
    _assert_same(jops.fused_encode(jold, jnew, cap), tops.fused_encode(told, tnew, cap))
    jenc, tenc = jops.delta_encode(jold, jnew, cap), tops.delta_encode(told, tnew, cap)
    _assert_same(jenc, tenc)
    # encode(old→new) ∘ apply(old) == new whenever the delta fits
    rebuilt = tops.delta_apply(told.clone(), tenc[0], tenc[1])
    _assert_same([jops.delta_apply(jold, jenc[0], jenc[1])], [rebuilt])
    if int(tenc[2]) <= cap:
        np.testing.assert_array_equal(rebuilt.numpy(), new)


# ------------------------------------------------------------- routing
def test_cpu_tensors_never_launch_kernels():
    tops.reset_launch_counts()
    old = torch.zeros((8, 64), dtype=torch.uint8)
    new = old.clone()
    new[3, 5] = 1
    tops.delta_diff(old, new)
    tops.delta_encode(old, new, 4)
    data, idx, _, _ = tops.fused_encode(old, new, 4)
    tops.delta_apply(old.clone(), data, idx)
    assert tops.launch_counts() == {
        "delta_diff": 0, "delta_fused": 0, "delta_apply": 0,
        "page_copy": 0, "page_copy_stacked": 0, "paged_attention": 0,
    }


def test_host_fetch_of_cpu_tensors():
    t = torch.arange(10, dtype=torch.int32)
    fetch = tops.start_host_fetch(t, torch.tensor(3, dtype=torch.int32))
    assert not fetch.from_device
    arr, scalar = fetch.wait()
    np.testing.assert_array_equal(arr, np.arange(10, dtype=np.int32))
    assert int(scalar) == 3
