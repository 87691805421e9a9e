"""The harness on the CPU: it finds every file by name, the names and
units of BENCHMARK.json keep to the contract, nothing under bench/ imports
JAX or the JAX package (the reference nothing of the port either), and a
tiny search cell runs end to end."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import DATA, ROOT, run_tiny

BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_registry_finds_every_file_by_name():
    from bench.harness import registry

    for c in SPEC["configs"]:
        cfg = registry.load_json("configs", c["name"])
        assert (ROOT / c["file"]).is_file() and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        fam = registry.load_module("models", cfg["family"])
        ref = registry.load_module("reference", cfg["family"])
        assert callable(fam.draw_weights) and callable(fam.build) and callable(ref.check)
    for w in SPEC["workloads"]:
        cell = registry.load_json("workloads", w["name"])
        assert cell["config"] == w["config"]
        drv = registry.load_module("drivers", cell["driver"])
        assert callable(drv.Driver)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
    with pytest.raises(FileNotFoundError):
        registry.load_json("workloads", "no-such-cell")
    with pytest.raises(ValueError):
        registry.load_json("workloads", "../BENCHMARK")


def test_names_and_units_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    layers = {}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if "layer" in m:
            layers.setdefault(m["layer"], m["layer"])
            assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in {e["name"] for e in SPEC["end_to_end"]}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_plain_reference(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops and "bench" not in tops, tops


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "qwen3-14b.search",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["qwen3-tiny.search", "qwen3-moe-tiny.search"])
def test_search_cell_end_to_end(cell):
    r = run_tiny(cell, seed=3_000_000_019)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 8
    want = {m["name"] for m in SPEC["end_to_end"]}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert m["value"] > 0
    json.dumps(r)


def test_traced_metrics_without_a_trace():
    r = run_tiny("qwen3-tiny.search", seed=5, trace=True)
    got = set(r["metrics"])
    device_only = {"kernel.paged_attention_roofline", "device.idle"}
    assert got == {m["name"] for m in SPEC["per_layer"]} - device_only
    assert "breakdown" not in r


@pytest.mark.parametrize("control", [False, True])
def test_a_driver_without_the_search_keys(control):
    """The harness runs a cell whose driver, traffic and numbers share
    nothing with the search's; a control run reads the control's numbers
    in the program's place."""
    import torch

    from bench.harness.main import run_cell, set_caches

    set_caches()
    spec = {"workloads": [{"name": "qwen3-tiny.stub", "config": "qwen3-tiny", "traffic": "stub",
                           "chips": 1, "why": "CPU test"}],
            "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                            "source": "host_clock"}],
            "per_layer": []}
    r = run_cell("qwen3-tiny.stub", 5, 1.0, False, torch.device("cpu"), spec=spec, base=DATA,
                 control=control)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert r["correct"] is (not control)
    assert r["checks"] == {"tokens_missing": {"value": 1 if control else 0, "limit": 0}}
    assert set(r["metrics"]) == {"setup_s"} and r["attempted"] == 3
    assert r["info"]["tokens"] == 8
