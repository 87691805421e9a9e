"""The port on the card: CUDA kernels against their plain versions, and a
short checkpoint/rollback chain over CUDA tensors.

Every test here needs a CUDA card and skips without one; run them on the
GPU machine with ``python -m pytest -m gpu tests/test_torch_gpu.py``.  This
file imports no JAX, so it runs where the JAX package is not installed.
"""
import numpy as np
import pytest
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
    assert ops.launch_counts() == {"delta_diff": 1, "delta_fused": 1, "delta_apply": 1}


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
