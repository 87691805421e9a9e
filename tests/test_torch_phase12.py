"""``chip_smoke.py``'s phase 12 rehearsed on the CPU at a tiny size: its
gates run in tier-1.  12a holds one MoE layer's expert-parallel path
against ``moe_apply`` per shard on ("data", "model") layouts with and
without sequence parallelism (the tiny config's 4 experts stand in for
the (1, 8) layout with a (2, 2) one), with each rank's collective bytes
against the formula; 12b serves phase 9a's run again under an
activation-sharding context and holds it against the unsharded run; 12c
calls the serving launcher in-process."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

CONFIG = "qwen3-moe-30b-a3b-tiny"
TINY = dict(num_pages=64, page_size=4, max_pages=24, prompt_len=9, steps=4, forks=3,
            fork_steps=3, slow_steps=2)
LAYOUTS = (((1, 4), False), ((2, 4), False), ((2, 4), True), ((4, 2), True), ((2, 2), True))


def _model():
    return chip_smoke.build_family_model("cpu", CONFIG, embed_std=chip_smoke.FAMILY_EMBED_STD)


def test_phase12a_rehearsal_on_the_cpu():
    rows = chip_smoke.run_ep_layer("cpu", _model(), layouts=LAYOUTS, shape=(4, 8))
    assert [r["mesh"] for r in rows] == [list(m) for m, _ in LAYOUTS]
    for row in rows:
        assert row["max_rel_err"] < 1e-5 and row["aux_err"] <= chip_smoke.EP_AUX_TOL
        assert row["a2a_bytes_per_rank"] > 0
        assert (row["gather_bytes_per_rank"] > 0) == (row["mesh"][0] > 1)


def test_phase12b_rehearsal_on_the_cpu():
    model = _model()
    unsharded = chip_smoke.run_family_path("cpu", config=CONFIG, model=model, **TINY)
    ep = chip_smoke.run_ep_serving_path("cpu", model, unsharded, **TINY)
    assert ep["mesh"] == list(chip_smoke.EP_SERVE_MESH)
    assert ep["prefill_logits_rel_err"] < 1e-5
    # drop-free at the tiny capacity factor: the same greedy tokens
    assert ep["trunk_tokens_equal"] + ep["fork_tokens_equal"] == ep["tokens_compared"] > 0
    assert ep["collective_calls"]["all_to_all"] == 2 * (2 + ep["decode_steps"])
    assert ep["c2_image_mode"] == "delta" and ep["drop_share_decode"] == 0.0


def test_phase12c_rehearsal_on_the_cpu():
    out = chip_smoke.run_serve_launcher(("--arch", "olmo-1b-tiny", "--tokens", "16",
                                         "--sessions", "2", "--device", "cpu"))
    assert out["rc"] == 0 and out["steps"] == 15
    assert [s[:4] for s in out["sessions"]] == [[1, 2, 3, 4]] * 2
