"""``cr.patch_restore_share`` on runs made up through the program's tracer:
the window run's ``cr.restore.patch`` count over its slow ``cr.restore``
spans."""
import json
import sys

import pytest

from bench.harness import registry
from conftest import ROOT

MS = 1_000_000
NAME = "cr.patch_restore_share"


def _read():
    return registry.load_module("metrics", NAME).read({"nodes": 3})


@pytest.fixture
def tracer():
    from repro_torch import trace

    trace.reset()
    yield trace
    trace.configure(enabled=True, capacity=65536)
    trace.reset()


def _run(trace, paths, patches):
    """A search run whose restores took ``paths``, ``patches`` of the slow
    ones patched; an older run and the check's restores, outside any run,
    read otherwise."""
    old = trace.new_run()
    with trace.scope(old):
        trace.record("search.run", 0, 10 * MS)
        trace.record("cr.restore", 0, MS, path="slow")
    run = trace.new_run()
    with trace.scope(run, 0):
        for i, path in enumerate(paths):
            trace.record("cr.restore", i * MS, (i + 1) * MS, ckpt=i, path=path)
        if patches:
            trace.count("cr.restore.patch", patches)
            trace.count("cr.restore.patch_pages", 2 * patches)
    with trace.scope(run):
        trace.record("search.run", 0, 50 * MS)
    with trace.scope(None):
        trace.record("cr.restore", 0, MS, path="slow")
        trace.count("cr.restore.patch")
    return run


def test_reads_the_share_of_slow_restores_patched(tracer):
    _run(tracer, ["fast", "slow", "slow", "fast", "slow", "slow"], 3)
    assert _read() == pytest.approx(75.0, rel=1e-12)


def test_reads_zero_without_a_patch(tracer):
    _run(tracer, ["fast", "slow", "slow"], 0)
    assert _read() == 0.0
    tracer.reset()
    _run(tracer, ["fast", "fast"], 0)
    assert _read() == 0.0


def test_reads_none_without_a_whole_run(tracer, monkeypatch):
    """No search run; a run that lost spans to the ring; a program without
    a tracer."""
    assert _read() is None
    _run(tracer, ["slow", "slow"], 2)
    assert _read() == 100.0
    tracer.configure(capacity=2)
    assert _read() is None
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert _read() is None


def test_listed_for_both_search_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "C/R engine", "moves": "nodes_per_s",
                 "workloads": ["qwen3-14b.search", "jamba2-mini.search_32k"]}
    assert spec["per_layer"][-1] is m
