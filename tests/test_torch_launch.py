"""``python -m repro_torch.launch.train``, the port's training entry point:
it trains on the CPU when asked, and without a card and without that
request it exits non-zero rather than falling back to the CPU."""
import pytest

pytest.importorskip("torch")

import os
import subprocess
import sys
from pathlib import Path

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


def test_serve_launcher_serves_on_the_cpu(capsys):
    """``repro_torch.launch.serve.main`` in-process: two sessions of the
    prompt and 16 tokens each, the reference launcher's printed lines."""
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--tokens", "16", "--sessions", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["session 0", "session 1"]
    streams = [eval(ln.split(": ", 1)[1]) for ln in lines]
    assert all(len(s) == 4 + 16 and s[:4] == [1, 2, 3, 4] for s in streams)
    assert streams[0] != streams[1]              # one seed per session


def test_serve_launcher_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would serve on it")
    from repro_torch.launch import serve

    assert serve.main(["--tokens", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--tokens", "2"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "no CUDA device" in out.stderr
