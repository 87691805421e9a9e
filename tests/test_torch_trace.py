"""The port's tracer (``repro_torch.trace``): spans nest and carry their
thread's run and leaf, the ring is bounded and counts what it drops,
recording switches off, counters are keyed by run, the pool lock records
only contended acquisitions, a tiny search's spans (dumps that commit
after it returns among them) carry its run id, and a profiler sees the
spans by name."""
import pytest

pytest.importorskip("torch")

import threading
import time

import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DeltaFS, DumpPolicy, Sandbox, SandboxTree, StateManager
from repro_torch.models import Model
from repro_torch.search import MCTS, DecodeSearchTask, MCTSConfig
from repro_torch.serve import Engine, PagedSession, PagePool, Scheduler, SchedulerConfig

torch.set_num_threads(1)


def test_spans_nest_and_carry_the_threads_context():
    tr = trace.Tracer()
    run = tr.new_run()
    assert tr.new_run() == run + 1
    t_before = time.perf_counter_ns()
    with tr.scope(run, 7):
        assert tr.current() == (run, 7)
        with tr.span("outer", ckpt=3) as outer:
            with tr.span("inner", path="slow"):
                pass
            outer.set(ckpt=4, rows=2)
        tr.record("queued", t_before, ckpt=5)
    assert tr.current() == (None, None)
    inner, outer, queued = tr.snapshot(run)["spans"]
    assert inner.name == "inner" and inner.attr == {"path": "slow"} and inner.ckpt is None
    assert outer.name == "outer" and outer.ckpt == 4 and outer.attr == {"rows": 2}
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns <= time.perf_counter_ns()
    assert queued.t0_ns == t_before and queued.t1_ns >= outer.t1_ns
    for s in (inner, outer, queued):
        assert (s.run, s.leaf, s.thread) == (run, 7, threading.current_thread().name)
    with tr.span("bare"):
        pass
    (bare,) = [s for s in tr.snapshot()["spans"] if s.name == "bare"]
    assert bare.run is None and bare.attr is None


def test_the_ring_is_bounded_and_counts_what_it_drops():
    tr = trace.Tracer(capacity=4)
    for run in (1, 1, 1, 2, 2, 2):
        with tr.scope(run):
            with tr.span(f"s{run}"):
                pass
    spans = tr.snapshot()["spans"]
    assert len(spans) == 4 and [s.run for s in spans] == [1, 2, 2, 2]
    assert tr.snapshot(1)["counters"] == {"trace.dropped": 2}
    assert tr.snapshot(2)["counters"] == {}
    tr.configure(capacity=2)                     # shrinking drops the oldest
    assert [s.run for s in tr.snapshot()["spans"]] == [2, 2]
    assert tr.snapshot(1)["counters"] == {"trace.dropped": 3}
    with pytest.raises(ValueError):
        tr.configure(capacity=0)
    tr.reset()
    assert tr.snapshot() == {"spans": [], "counters": {}}


def test_recording_off_records_nothing():
    tr = trace.Tracer()
    tr.configure(enabled=False)
    with tr.scope(1):
        first, second = tr.span("a"), tr.span("b", ckpt=1)
        assert first is second                   # one shared no-op
        with first as sp:
            sp.set(ckpt=2, path="fast")
        tr.record("c", 0)
        tr.count("d")
    assert tr.snapshot() == {"spans": [], "counters": {}}
    tr.configure(enabled=True)
    with tr.span("a"):
        pass
    assert len(tr.snapshot()["spans"]) == 1


def test_the_process_tracer_switches_off():
    run = trace.new_run()
    trace.configure(enabled=False)
    try:
        with trace.scope(run), trace.span("off"):
            trace.count("off")
    finally:
        trace.configure(enabled=True)
    assert trace.snapshot(run) == {"spans": [], "counters": {}}


def test_counters_are_keyed_by_run():
    tr = trace.Tracer()
    a, b = tr.new_run(), tr.new_run()
    with tr.scope(a):
        tr.count("dump.with_parent")
        tr.count("dump.with_parent", 2)
    with tr.scope(b, leaf=0):
        tr.count("dump.with_parent")
        tr.count("dump.base_miss")
    tr.count("dump.with_parent")                 # outside any run
    assert tr.snapshot(a)["counters"] == {"dump.with_parent": 3}
    assert tr.snapshot(b)["counters"] == {"dump.with_parent": 1, "dump.base_miss": 1}
    assert tr.snapshot()["counters"][(None, "dump.with_parent")] == 1


def test_a_contended_pool_lock_is_one_span():
    pool = PagePool(get_config("qwen3-14b-tiny"), num_pages=8, page_size=4, device="cpu")
    run = trace.new_run()
    held, trying = threading.Event(), threading.Event()

    def holder():
        with pool.lock:
            held.set()
            trying.wait(timeout=10)
            time.sleep(0.05)

    def waiter():
        with trace.scope(run):
            trying.set()
            with pool.lock:
                pass

    with trace.scope(run):
        with pool.lock, pool.lock:               # uncontended, and reentrant
            pass
    assert trace.snapshot(run)["spans"] == []
    t = threading.Thread(target=holder, name="holder")
    t.start()
    assert held.wait(timeout=10)
    w = threading.Thread(target=waiter, name="waiter")
    w.start()
    t.join(timeout=10)
    w.join(timeout=10)
    assert not t.is_alive() and not w.is_alive()
    (wait,) = trace.snapshot(run)["spans"]
    assert wait.name == "kvpool.lock_wait" and wait.thread == "waiter"
    assert wait.t1_ns > wait.t0_ns


def test_a_tiny_search_traces_its_run_across_threads(monkeypatch):
    """Every span of the parallel search carries its run: the leaves' (one
    leaf id each), the restores' (slow ones split into their image wait
    and decode, and a page write for each that wrote pages), the steps',
    and the dumps' on the worker, including dumps that commit after
    ``MCTS.run`` returned."""
    empty = []                  # patched restores that wrote no page
    apply_patch = PagedSession.apply_patch

    def noting(self, image, own_image, positions, store):
        if not len(positions):
            empty.append(image.image_id)
        return apply_patch(self, image, own_image, positions, store)

    monkeypatch.setattr(PagedSession, "apply_patch", noting)
    cfg = get_config("qwen3-14b-tiny")
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    pool = PagePool(cfg, num_pages=512, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    trunk = eng.new_session(list(range(1, 10)))
    fs = DeltaFS()
    cr = DeltaCR(store=fs.store, policy=DumpPolicy(mode="delta"), template_pool_size=2,
                 async_warm=False,
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    dump_image = cr._dump_image

    def slow_dump(*args):                        # a backlog past the search's end
        time.sleep(0.03)
        return dump_image(*args)

    cr._dump_image = slow_dump
    sm = StateManager(Sandbox(fs, trunk.fork()), cr)
    sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, batch_window_ms=2.0))
    task = DecodeSearchTask(eng, scheduler=sched, k_tokens=2, width=3)
    mcts = MCTS(sm, task, MCTSConfig(iterations=12, parallel_leaves=4, max_depth=6, seed=3),
                tree=SandboxTree(sm), scheduler=sched)
    try:
        st = mcts.run()
        ended = time.perf_counter_ns()
        cr.wait_dumps()
    finally:
        cr.shutdown()
    runs = [s.run for s in trace.snapshot()["spans"] if s.name == "search.run"]
    run = max(runs)
    spans = trace.snapshot(run)["spans"]
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    leaves = by["search.leaf"]
    assert len(leaves) == st.iterations == 12
    assert sorted(s.leaf for s in leaves) == list(range(12))
    assert all(s.thread.startswith("mcts-leaf") for s in leaves)
    assert {s.ckpt for s in leaves} - {None} <= {s.ckpt for s in by["dump.run"]}
    assert sum(s.attr["leaves"] for s in by["search.batch"]) == 12
    assert len(by["tree.fork"]) == 12
    paths = [s.attr["path"] for s in by["cr.restore"]]
    assert "slow" in paths and len(by["cr.restore.image_wait"]) == paths.count("slow")
    assert len(by["cr.restore.decode"]) == paths.count("slow")
    assert len(by["kvpool.scatter"]) == paths.count("slow") - len(empty)
    assert len(by["engine.run"]) == len(by["engine.step"]) > 0
    assert len(by["dump.queue"]) == len(by["dump.run"]) == st.checkpoints
    assert max(s.t1_ns for s in by["dump.run"]) > ended
    dumped = {s.ckpt for s in by["dump.queue"]}
    assert dumped == {s.ckpt for s in by["dump.run"]}
    assert all(s.thread == "deltacr-dump" for s in by["dump.run"])
    counters = trace.snapshot(run)["counters"]
    assert counters["dump.with_parent"] == st.checkpoints - 1   # the root has no parent
    assert "trace.dropped" not in counters


def test_a_profiler_sees_the_spans_by_name():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.profiled"):
            torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert "test.profiled" in names
    with trace.span("test.unprofiled"):
        pass
    assert any(s.name == "test.unprofiled" for s in trace.snapshot()["spans"])


@pytest.mark.gpu
def test_spans_put_no_event_on_the_devices_timeline():
    """A span over a kernel appears among the profiler's host events and
    adds no event to the device's: a device trace's busy time counts the
    device's work alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("test.device"):
            x.mul_(2)
            x.add_(1)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e.name() for e in events if e.device_type() == DeviceType.CPU]
    device = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert "test.device" in host
    assert device and "test.device" not in device
