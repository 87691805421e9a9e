"""``chip_smoke.py``'s phase 13 rehearsed on the CPU at a tiny size: 13a's
records for two cells of the full configs (a ``meta`` trace allocates
nothing), and 13b's flow with ``device="cpu"`` on ``-tiny`` configs: the
dry run's ``meta`` record at (1, 1), then the step built on a (1, 1) mesh
of the CPU and run on real arguments, its FLOPs and argument bytes equal
to the record's."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def test_phase13a_rehearsal_on_the_cpu():
    cells = [c for c in chip_smoke.DRYRUN_CELLS if c[1] == "decode_32k"]
    recs = chip_smoke.run_dryrun_cells(cells)
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("qwen3-14b", "16x16"), ("qwen3-14b", "2x16x16")]
    assert [r["n_devices"] for r in recs] == [256, 512]
    for rec in recs:
        assert rec["status"] == "ok" and rec["flops"] > 0 and rec["wall_s"] > 0
        assert rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch,shape_name", [(a, s) for a, s, _ in chip_smoke.DRYRUN_CHECKS])
def test_phase13b_rehearsal_on_the_cpu(arch, shape_name):
    row = chip_smoke.run_dryrun_check("cpu", arch=arch, shape_name=shape_name, global_batch=2,
                                      config=arch + "-tiny", seq_len=32, steps=2)
    assert row["device"] == "cpu" and row["config"] == arch + "-tiny"
    assert row["flops"] > 0 and row["argument_bytes"] > 0
    assert len(row["step_ms"]) == 2
    assert row["reduced"]["global_batch"][1] == 2 and row["reduced"]["seq_len"][1] == 32
    # device metrics come only from the card
    assert row["temp_bytes"] is None and row["flops_fraction_of_bf16_peak"] is None
