"""The benchmark's tests run from the root of a checkout:

    python -m pytest bench/tests -q              # on the CPU; the gpu tests skip
    python -m pytest bench/tests -q -m gpu       # on the card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_spec():
    """BENCHMARK.json with the tiny test cells added to every metric."""
    from bench.harness import registry

    spec = registry.benchmark_spec()
    for name in ("qwen3-tiny.search", "qwen3-moe-tiny.search"):
        spec["workloads"].append({"name": name, "config": name.split(".")[0],
                                  "traffic": "search", "chips": 1, "why": "CPU test"})
        for m in spec["per_layer"] + spec["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(name)
    return spec


def run_tiny(name: str, seed: int = 7, seconds: float = 2.0, trace: bool = False,
             control: bool = False):
    import torch

    from bench.harness.main import run_cell, set_caches

    set_caches()
    return run_cell(name, seed, seconds, trace, torch.device("cpu"), spec=tiny_spec(),
                    base=DATA, control=control)
