"""``chip_smoke.py``'s phase 8 rehearsed on the CPU at a tiny size: its
gates run in tier-1.  8a saves the C/R cell after each turn, tears it down
and recovers it in a fresh process, which checks the restored bytes, the
restore over the anchored parent and the next turn against the writer's;
8b restarts a scheduler's warm pool and decodes what a fast fork of the
suspended session decoded."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def test_phase8a_rehearsal_on_the_cpu():
    cell = chip_smoke.CRCell(layers=2, kv_heads=2, head_dim=16, session_tokens=256,
                             prefix_tokens=64, tokens_per_turn=32, heap_bytes=1 << 16,
                             n_files=5, chunk_bytes=1024)
    out = chip_smoke.run_persist_path("cpu", cell=cell, turns=3)
    assert [s["kind"] for s in out["saves"]] == ["full", "delta", "delta"]
    full, deltas = out["saves"][0], out["saves"][1:]
    # an incremental save writes about the turn's dirty chunks
    assert all(s["new_chunks"] <= cell.want_dirty + 2 for s in deltas)
    assert all(s["pack_bytes"] * 4 < full["pack_bytes"] for s in deltas)
    rec = out["recovered"]
    assert rec["seq"] == 3 and rec["trunk_restore_mode"] == "slow"
    assert rec["restore_parent_image"] in rec["anchors"]
    assert rec["tensors_checked"] == cell.n_tensors and rec["files_checked"] == 5
    assert rec["d2h_bytes"] == out["next_turn"]["d2h_bytes"]


def test_phase8b_rehearsal_on_the_cpu():
    out = chip_smoke.run_warm_pool_path("cpu", config="qwen3-14b-tiny", num_pages=64,
                                        page_size=4, max_pages=16, prompt_len=9)
    assert len(out["tokens"]) == chip_smoke.WARM_TOKENS
    assert out["save"]["kind"] == "full" and out["save"]["new_chunks"] > 0
    assert out["decode_steps"] == chip_smoke.WARM_STEPS + 2 * chip_smoke.WARM_TOKENS
