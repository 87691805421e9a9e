"""``chip_smoke.py``'s phase 14 rehearsed on the CPU at a tiny size: its
gates run in tier-1.  On the card it holds the Engine's CUDA graphs against
the eager step; the CPU has no graphs, so here both runs are eager and the
rehearsal checks the run itself (prefill, a checkpoint whose dump may be in
flight, B = 1 and batched steps over forks) and the gates' comparisons."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

torch.set_num_threads(1)


def test_phase14_rehearsal_on_the_cpu():
    model = Model(get_config("qwen3-14b-tiny"), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    out = chip_smoke.run_graph_path("cpu", model, num_pages=64, page_size=4, max_pages=16,
                                    prompt_len=9, forks=3, steps=3, runs=(False, False))
    assert out["tokens_equal"] and out["max_abs_logit_diff"] == 0.0
    assert out["runs"] == ["eager", "eager"] and out["capture_ms"] == []
    assert set(out["step_ms_b1"]) == set(out["step_ms_b3"]) == {"eager"}
    assert out["launches_per_step"]["paged_attention"] == 0     # the CPU launches no kernel
    assert [sorted(f) for f in out["first_step_ms"]] == [["1", "3"]] * 2


def test_phase14_gates_catch_a_different_run(monkeypatch):
    """A run whose tokens differ from the eager run's fails phase 14."""
    model = Model(get_config("qwen3-14b-tiny"), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    real = chip_smoke._graph_run
    calls = []

    def second_differs(*args, **kw):
        rec = real(*args, **kw)
        calls.append(rec)
        if len(calls) == 2:
            rec["tokens"][-1] = [t + 1 for t in rec["tokens"][-1]]
        return rec

    monkeypatch.setattr(chip_smoke, "_graph_run", second_differs)
    with pytest.raises(AssertionError, match="tokens"):
        chip_smoke.run_graph_path("cpu", model, num_pages=64, page_size=4, max_pages=16,
                                  prompt_len=9, forks=2, steps=2, runs=(False, False))
