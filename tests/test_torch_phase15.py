"""``chip_smoke.py``'s phase 15 rehearsed on the CPU at ``olmo-1b-tiny``:
its gates run in tier-1.  On the card it holds the Trainer's CUDA graph of
the step against the eager step; the CPU has no graphs, so here both runs
are eager and the rehearsal checks the run itself (one seeded state, the
same batches, four steps with two microbatches) and the gates'
comparisons."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY = dict(config="olmo-1b-tiny", seq_len=32, global_batch=8, runs=(False, False))


def test_phase15_rehearsal_on_the_cpu():
    out = chip_smoke.run_train_graph_path("cpu", **TINY)
    assert out["runs"] == ["eager", "eager"]
    assert out["max_metric_rel_diff"] == 0.0 and out["max_leaf_diff"] == 0.0
    assert len(out["losses"]) == 2 and out["losses"][0] == out["losses"][1]
    assert len(out["losses"][0]) == chip_smoke.TRAIN_GRAPH_STEPS
    assert set(out["step_ms_median"]) == {"eager"}
    assert out["capture_ms"] == [None, None] and out["graph_pool_bytes"] == [None, None]


def test_phase15_gates_catch_a_different_run(monkeypatch):
    """A run whose params leaf or grad_norm differs from the eager run's
    fails phase 15."""
    real = chip_smoke._train_graph_run

    def second_differs(what):
        calls = []

        def run(*args, **kw):
            p, o, rec = real(*args, **kw)
            calls.append(rec)
            if len(calls) == 2:
                if what == "leaf":
                    w = p["stage0"]["l0_s1_mlp"]["body"]["w_up"]
                    w.add_(1e-2 * float(w.abs().max()))
                else:
                    rec["metrics"][-1]["grad_norm"] *= 1 + 1e-4
            return p, o, rec

        return run

    for what, match in (("leaf", "w_up"), ("grad_norm", "grad_norm")):
        monkeypatch.setattr(chip_smoke, "_train_graph_run", second_differs(what))
        with pytest.raises(AssertionError, match=match):
            chip_smoke.run_train_graph_path("cpu", **TINY)
