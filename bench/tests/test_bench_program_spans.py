"""The metrics read from the program's own tracer (``repro_torch.trace``),
on spans and counters made up here through the tracer's API."""
import sys
import threading

import pytest

from bench.harness import registry

MS = 1_000_000
PROGRAM_METRICS = {
    "search.leaf_idle_share": 8.0,
    "sched.coalesce_ms_per_step": 2.0,
    "engine.host_ms": 3.0,
    "kvpool.lock_wait_ms_per_node": 5.0,
    "kvpool.scatter_ms_per_node": 2.0,
    "cr.image_wait_ms_per_node": 10.0,
    "cr.image_decode_ms_per_node": 3.0,
    "dump.queue_wait_p75_ms": 40.0,
    "dump.base_miss_share": 75.0,
}


def _read(name, rec):
    return registry.load_module("metrics", name).read(rec)


def _on_thread(name, fn):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def _made_up_run(trace):
    """A run of three nodes whose every metric has a known reading, after an
    older run that reads otherwise."""
    old = trace.new_run()
    with trace.scope(old):
        trace.record("search.run", 0, 10 * MS)
        trace.record("kvpool.scatter", 0, 9 * MS)
        trace.count("dump.with_parent")
    run = trace.new_run()

    def leaf():
        with trace.scope(run, 0):
            for a, b in ((0, 5), (60, 70)):
                trace.record("kvpool.lock_wait", a * MS, b * MS)

    _on_thread("mcts-leaf_0", leaf)
    with trace.scope(run):
        for name, a, b, attr in (
                ("search.batch", 0, 100, {"leaves": 2}), ("search.batch", 100, 150, {"leaves": 1}),
                ("search.leaf", 0, 80, {}), ("search.leaf", 0, 100, {}),
                ("search.leaf", 100, 150, {}),
                ("engine.step", 10, 30, {}), ("engine.step", 40, 50, {}),
                ("engine.run", 12, 28, {}), ("engine.run", 41, 49, {}),
                ("sched.coalesce", 8, 10, {}), ("sched.coalesce", 38, 40, {}),
                ("kvpool.lock_wait", 0, 100, {}),           # not a leaf thread
                ("kvpool.scatter", 20, 26, {}),
                ("cr.restore.image_wait", 1, 31, {}), ("cr.restore.decode", 31, 40, {}),
                *[("dump.queue", 0, d, {}) for d in (10, 20, 30, 40, 50)]):
            trace.record(name, a * MS, b * MS, **attr)
        trace.count("dump.with_parent", 4)
        trace.count("dump.base_miss", 3)
        trace.record("search.run", 0, 150 * MS)
    with trace.scope(None):                    # the check's restores: outside any run
        trace.record("kvpool.scatter", 0, 50 * MS)
    return run


@pytest.fixture
def tracer():
    from repro_torch import trace

    trace.reset()
    yield trace
    trace.configure(enabled=True, capacity=65536)
    trace.reset()


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_each_metric_reads_the_newest_search_run(tracer, name):
    _made_up_run(tracer)
    assert _read(name, {"nodes": 3}) == pytest.approx(PROGRAM_METRICS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_each_metric_reads_zero_where_its_spans_never_occurred(tracer, name):
    with tracer.scope(tracer.new_run()):
        tracer.record("search.run", 0, MS)
    assert _read(name, {"nodes": 3}) == 0.0


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_each_metric_is_none_without_a_whole_run(tracer, name, monkeypatch):
    """No search run; a run that lost spans to the ring; a program without
    a tracer (the parent of the change that added it)."""
    assert _read(name, {"nodes": 3}) is None
    _made_up_run(tracer)
    tracer.configure(capacity=2)              # keeps the run's search.run span alone
    assert [s.name for s in tracer.snapshot()["spans"]] == ["search.run", "kvpool.scatter"]
    assert _read(name, {"nodes": 3}) is None
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert _read(name, {"nodes": 3}) is None
