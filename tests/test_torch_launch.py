"""``python -m repro_torch.launch.train``, the port's training entry point:
it trains on the CPU when asked, and without a card and without that
request it exits non-zero rather than falling back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_trains_on_the_cpu():
    out = _launch("--arch", "olmo-1b", "--tiny", "--device", "cpu", "--steps", "2")
    assert out.returncode == 0, out.stderr
    assert "done at step 2; last loss" in out.stdout


def test_launcher_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would train on it")
    out = _launch("--tiny", "--steps", "1")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
