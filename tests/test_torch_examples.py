"""The port's examples (``python -m repro_torch.examples.<name>``): each
runs the JAX package's example's steps, asserts and prints on the CPU when
asked, and without a card and without ``--device cpu`` exits 2 rather
than falling back to the CPU.  ``train_lm`` runs its default model for 30
steps of its 120 (a crash at step 20 and a restart from step 20's
checkpoint), to stay well inside a test's time."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart": ([], ["restored c1 via fast path", "restored c2 via fast path",
                        "isolated eval -> 0.83, side effects undone", "OK"]),
    "mcts_search": ([], ["15 iterations in", "CoW page copies:", "free pages:",
                         "best trajectory tokens:"]),
    "rl_fanout": ([], ["step 0: fork_p50=", "step 2: fork_p50=", "OK"]),
    "train_lm": (["--steps", "30"], ["model: 5.2M params, 4 layers",
                                     "restoring from the last complete checkpoint",
                                     "resumed at step 20", "finished 30 steps", "OK"]),
}


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)


@pytest.mark.timeout(450)
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    args, wants = EXAMPLES[name]
    out = _run(name, "--device", "cpu", *args)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    for want in wants:
        assert want in out.stdout, (want, out.stdout[-2000:])


@pytest.mark.timeout(450)
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_exits_2(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    out = _run(name)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
