"""``chip_smoke.py``'s phase 9 rehearsed on the CPU at a tiny size: its
gates run in tier-1.  9a serves the MoE model (forks, checkpoints, a slow
restore, its routing held against the host's capacity rule), 9b the xLSTM model
whose state is all recurrent, 9c the sliding-window model past its window;
9d holds each new sublayer against a float32 run of itself."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY = dict(num_pages=64, page_size=4, max_pages=24, steps=4, forks=3, fork_steps=3,
            slow_steps=2)


def test_phase9a_rehearsal_on_the_cpu():
    out = chip_smoke.run_family_path("cpu", config="qwen3-moe-30b-a3b-tiny", prompt_len=9,
                                     embed_std=chip_smoke.FAMILY_EMBED_STD, **TINY)
    assert out["c2_image_mode"] == "delta" and out["state_bytes_per_session"] == 0
    # B <= 4 decode rows hold C >= top_k slots per expert: nothing drops
    assert out["drop_share_decode"] == 0.0 and out["drop_share_prefill"] is not None


def test_phase9b_rehearsal_on_the_cpu():
    out = chip_smoke.run_family_path("cpu", config="xlstm-1.3b-tiny", prompt_len=9, **TINY)
    cfg = chip_smoke.family_config("xlstm-1.3b-tiny")
    H, Hd, D = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
    # 7 mLSTM layers of (C, n, m) and 1 sLSTM of (c, n, m, h), float32
    assert out["state_bytes_per_session"] == 4 * (7 * (H * Hd * Hd + H * Hd + H) + 4 * D)
    assert out["global_attn_layers"] == 0 and out["d2h_bytes_kernel_path_c2"] == 0


def test_phase9c_rehearsal_on_the_cpu():
    cfg = chip_smoke.family_config("gemma3-27b-tiny", 1)
    assert [layer[0] for layer in cfg.stages[0].period].count("attn_local") == 5
    out = chip_smoke.run_family_path("cpu", config="gemma3-27b-tiny", periods=1,
                                     prompt_len=cfg.window + 9, **TINY)
    assert out["layers"] == 6 and out["global_attn_layers"] == 1


@pytest.mark.parametrize("label,config,kind,prompt_len", chip_smoke.SUBLAYER_CASES,
                         ids=[c[0] for c in chip_smoke.SUBLAYER_CASES])
def test_phase9d_rehearsal_on_the_cpu(label, config, kind, prompt_len):
    """The tiny configs are float32, so the device side equals the CPU side
    up to float rounding; ``attn_local`` runs past the tiny window."""
    cfg = chip_smoke.family_config(config + "-tiny")
    tokens = cfg.window + 8 if kind == "attn_local" else 12
    row = chip_smoke.check_sublayer("cpu", config + "-tiny", kind, tokens)
    assert row["max_rel_err"] < 1e-5
    assert row["tensors_compared"] >= 1 + chip_smoke.SUBLAYER_DECODE_STEPS
