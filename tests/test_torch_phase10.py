"""``chip_smoke.py``'s phases 10 and 10b rehearsed on the CPU at
``olmo-1b-tiny``: training with a crash at the ``trainer.step`` seam,
``restore_latest`` and the resumed run, with every gate of the phase, and
10b's warm-up, step and write (tier-1 runs them)."""
import pytest

pytest.importorskip("torch")

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TINY = dict(config="olmo-1b-tiny", seq_len=32, global_batch=8)


def test_phase10_rehearsal_on_the_cpu():
    out = chip_smoke.run_train_path("cpu", **TINY)
    assert out["losses_before_crash"][-1] == out["losses_after_restore"][0]
    assert len(out["losses_before_crash"]) == chip_smoke.TRAIN_FAIL_AT
    assert len(out["losses_after_restore"]) == chip_smoke.TRAIN_STEPS - chip_smoke.TRAIN_CKPT_EVERY
    # every params leaf, both moment trees' and the step counter compared
    assert out["restored_leaves_bit_exact"] == 3 * out["params_leaves"] + 1
    # params (float32) + two float32 moments + the step, plus the stream state
    assert out["ckpt_write_bytes"] >= 3 * 4 * out["params"] + 4
    assert out["mfu"] is None and out["peak_memory_bytes"] is None


def test_phase10_gate_catches_a_changed_restore(monkeypatch):
    """A restore that differs from the snapshot in one bit fails the phase."""
    from repro_torch.train import Trainer

    restore = Trainer.restore_latest

    def flipped(self, **kw):
        params, opt, err, step = restore(self, **kw)
        w = params["stage0"]["l0_s1_mlp"]["body"]["w_up"]
        w.view(torch.int32).view(-1)[7] ^= 1
        return params, opt, err, step

    monkeypatch.setattr(Trainer, "restore_latest", flipped)
    with pytest.raises(AssertionError, match="differs from the snapshot"):
        chip_smoke.run_train_path("cpu", **TINY)


def test_phase10b_rehearsal_on_the_cpu():
    """Phase 10b on the CPU: the warm-up and the profiled window run the
    trainer (the profile itself is the card's only), and the write alone
    encodes the whole state."""
    out = chip_smoke.profile_train_step("cpu", config="olmo-1b-tiny", seq_len=32, global_batch=8)
    assert "device_busy_ms" not in out
    assert out["tokens"] == 256 and out["write_alone_bytes"] > 0
    assert out["write_stages"]["bytes"] > 0 and out["write_stages"]["digest_mb_s"] > 0
