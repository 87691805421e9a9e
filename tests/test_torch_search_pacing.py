"""The parallel search paces itself to its dumps: a batch starts once at
most ``parallel_leaves`` of the run's dumps are still queued or running,
so leaves faster than DeltaCR's one dump worker wait between batches
(a ``search.dump_wait`` span), and a checkpoint itself never waits."""
import pytest

pytest.importorskip("torch")

import threading
import time

import torch

from repro_torch import trace
from repro_torch.core import CowTensorState, DeltaCR, DeltaFS, DumpPolicy, Sandbox, StateManager, faults
from repro_torch.search import ARCHETYPES, MCTS, MCTSConfig, SyntheticAgentTask, build_sandbox_state

torch.set_num_threads(1)

LEAVES = 2


def _rig(**policy):
    spec = ARCHETYPES["tools"]
    fs = DeltaFS(chunk_bytes=4096)
    proc = build_sandbox_state(spec, fs, seed=0, device="cpu")
    cr = DeltaCR(store=fs.store, restore_fn=lambda p: CowTensorState(p, device="cpu"),
                 policy=DumpPolicy(**policy), template_pool_size=16, async_warm=False)
    sm = StateManager(Sandbox(fs, proc), cr)
    task = SyntheticAgentTask(spec)
    sm.action_applier = lambda sb, act: task.replay_action(sb, act)
    return sm, task, cr


def _search(sm, task, iterations, **cfg):
    """The search on a thread; returns the thread, its MCTS and a box for
    its start on the tracer's clock and its stats."""
    mcts = MCTS(sm, task, MCTSConfig(iterations=iterations, parallel_leaves=LEAVES,
                                     use_lightweight=False, seed=3, **cfg))
    out = {"t0": time.perf_counter_ns()}

    def go():
        out["stats"] = mcts.run()

    t = threading.Thread(target=go)
    t.start()
    return t, mcts, out


def _pending(cr):
    with cr._lock:
        return sum(not f.done() for f in cr._images.values())


def _waits(out):
    """The ``search.dump_wait`` spans of the search's run."""
    spans = trace.snapshot()["spans"]
    (run,) = {s.run for s in spans if s.name == "search.run" and s.t0_ns >= out["t0"]}
    return [s for s in spans if s.run == run and s.name == "search.dump_wait"]


def test_a_batch_waits_while_the_runs_dumps_are_more_than_its_leaves():
    sm, task, cr = _rig()
    try:
        cr.wait_dumps()
        gate = threading.Event()
        cr._dump_executor.submit(gate.wait)
        t, mcts, out = _search(sm, task, 8)
        t.join(timeout=3.0)
        # the root's dump and two batches' are queued; the third batch waits
        assert t.is_alive()
        assert mcts.stats.iterations == 2 * LEAVES
        assert _pending(cr) == 1 + 2 * LEAVES
        gate.set()
        t.join(timeout=60)
        assert not t.is_alive() and out["stats"].iterations == 8
        waits = _waits(out)
        assert waits and all(s.attr["dumps"] >= 1 for s in waits)
        cr.wait_dumps()
    finally:
        cr.shutdown()


@pytest.mark.parametrize("dump", [True, False])
def test_a_search_whose_dumps_keep_up_or_that_dumps_nothing_runs_through(dump):
    sm, task, cr = _rig()
    try:
        t, mcts, out = _search(sm, task, 12, dump=dump)
        t.join(timeout=120)
        assert not t.is_alive() and out["stats"].iterations == 12
        if not dump:
            assert not _waits(out)
        cr.wait_dumps()
    finally:
        cr.shutdown()


def test_a_checkpoint_does_not_wait_for_the_dump_worker():
    """Only the search paces itself: checkpoints past any count of queued
    dumps return at once."""
    sm, task, cr = _rig()
    try:
        cr.wait_dumps()
        gate = threading.Event()
        cr._dump_executor.submit(gate.wait)
        done = threading.Event()

        def go():
            for _ in range(20):
                sm.checkpoint()
            done.set()

        threading.Thread(target=go).start()
        assert done.wait(30)
        assert _pending(cr) == 20
        gate.set()
        cr.wait_dumps()
    finally:
        cr.shutdown()


def test_failed_dumps_do_not_hold_the_search():
    sm, task, cr = _rig(retries=0, retry_backoff_s=0.0)
    try:
        cr.wait_dumps()
        with faults.inject(faults.FaultPlan().add("dump.worker", times=0)):
            t, mcts, out = _search(sm, task, 8)
            t.join(timeout=120)
        assert not t.is_alive() and out["stats"].iterations == 8
    finally:
        cr.shutdown()
