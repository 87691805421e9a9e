"""Best-of-N / RL rollout fan-out over warm templates (paper §6.2.2).

Ported unchanged from the JAX package's ``search/fanout.py``.

Each training step forks N independent sandboxes from the same warm
starting state, runs them as rollouts, scores them, and tears them down.
Fork latency directly bounds training throughput, so the primitives here
are:

* ``fork_n``         — N bare template forks (page-table copies + refcount
                       bumps) with latency percentiles and footprint
                       accounting — the Table 3 / Fig 7(a) analogue.
* ``fork_sandboxes`` — N **live sandboxes** from a checkpoint through a
                       :class:`~repro_torch.core.sandbox_tree.SandboxTree`:
                       process template fork *plus* a shared-layer
                       namespace view per child, i.e. the end-to-end cost a
                       real fan-out pays.
* ``rollout_fanout`` — the full RL-step substrate path over either source:
                       fan-out + (optionally threaded) rollouts + teardown.
                       Passing a ``SandboxTree`` + ``ckpt_id`` drives real
                       sandbox forks; passing a bare ``ForkableState`` keeps
                       the historical process-only behavior.

``sync_gpu_occupation`` reproduces the Fig 7(c) model:
    occ = (T_gen + T_train) / (T_sandbox + T_gen + T_train).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.deltacr import DeltaCR, ForkableState
from ..core.sandbox_tree import SandboxTree
from ..core.state_manager import Sandbox

__all__ = [
    "FanoutResult",
    "checkpoint_burst",
    "decode_fanout",
    "fork_n",
    "fork_sandboxes",
    "rollout_fanout",
    "sync_gpu_occupation",
    "staleness",
]


@dataclasses.dataclass
class FanoutResult:
    n: int
    fork_ms: List[float]                 # per-fork wall ms
    total_ms: float
    resident_bytes: int                  # summed attributable footprint
    forks_per_s: float

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.fork_ms, 50))

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.fork_ms, 99))


def _result(children: Sequence[Any], fork_ms: List[float], total_ms: float) -> FanoutResult:
    resident = 0
    for c in children:
        state = c.proc if isinstance(c, Sandbox) else c
        rb = getattr(state, "resident_bytes", None)
        if callable(rb):
            resident += rb()
    return FanoutResult(
        n=len(children),
        fork_ms=fork_ms,
        total_ms=total_ms,
        resident_bytes=resident,
        forks_per_s=len(children) / max(total_ms / 1e3, 1e-9),
    )


def fork_n(template: ForkableState, n: int) -> Tuple[List[ForkableState], FanoutResult]:
    """Fork ``n`` children from one frozen template, timing each fork."""
    children: List[ForkableState] = []
    fork_ms: List[float] = []
    t_start = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        children.append(template.fork())
        fork_ms.append((time.perf_counter() - t0) * 1e3)
    total_ms = (time.perf_counter() - t_start) * 1e3
    return children, _result(children, fork_ms, total_ms)


def fork_sandboxes(
    tree: SandboxTree, ckpt_id: int, n: int
) -> Tuple[List[Sandbox], FanoutResult]:
    """Fork ``n`` live sandboxes from a checkpoint, timing each fork.

    The end-to-end fan-out primitive: each fork is a DeltaCR template fork
    *plus* a fresh namespace view over the shared layer store — what a real
    rollout pays before its first action.  Callers release children via
    ``tree.release(sandbox.sandbox_id)`` (or ``tree.release_all()``)."""
    children: List[Sandbox] = []
    fork_ms: List[float] = []
    t_start = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        children.append(tree.fork(ckpt_id, 1)[0])
        fork_ms.append((time.perf_counter() - t0) * 1e3)
    total_ms = (time.perf_counter() - t_start) * 1e3
    return children, _result(children, fork_ms, total_ms)


def rollout_fanout(
    source: Union[ForkableState, SandboxTree],
    n: int,
    rollout_fn: Callable[[Any, int], float],
    *,
    ckpt_id: Optional[int] = None,
    teardown: bool = True,
    workers: int = 0,
) -> Tuple[List[float], FanoutResult]:
    """Fork N children, run ``rollout_fn(child, i) -> reward``, tear down.

    The full RL-step substrate path: fan-out + rollouts + release.  With a
    :class:`SandboxTree` source (``ckpt_id`` required) the children are live
    sandboxes sharing every frozen layer; ``workers > 1`` runs the rollouts
    on a thread pool — sound because sibling sandboxes are mutually
    isolated by construction (CoW process state, private fs uppers)."""
    if isinstance(source, SandboxTree):
        if ckpt_id is None:
            raise ValueError("SandboxTree fan-out requires ckpt_id")
        children, result = fork_sandboxes(source, ckpt_id, n)
    else:
        children, result = fork_n(source, n)

    def _release_children() -> None:
        for child in children:
            if isinstance(source, SandboxTree):
                source.release(child.sandbox_id)
            else:
                child.release()

    try:
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="rollout") as pool:
                rewards = list(pool.map(rollout_fn, children, range(len(children))))
        else:
            rewards = [rollout_fn(child, i) for i, child in enumerate(children)]
    except BaseException:
        # a failed rollout must not leak the fan-out: live children would
        # stay resident and keep their base checkpoint pinned forever
        _release_children()
        raise

    if teardown:
        _release_children()
    return rewards, result


def decode_fanout(
    tree: SandboxTree,
    ckpt_id: int,
    n: int,
    scheduler,
    k_tokens: int,
    *,
    actions: Optional[Sequence[int]] = None,
    release: bool = True,
) -> Tuple[List[List[int]], List[Sandbox], FanoutResult]:
    """Fork ``n`` live decoders from one checkpoint and decode ``k_tokens``
    each through the scheduler's continuous batching — the serving-loop
    fan-out primitive end to end.

    Each child is admitted via ``Scheduler.admit_forked`` (the fork itself
    copies zero KV-block bytes — CoW pages stay shared until the first
    divergent write); ``actions`` optionally force-feeds child ``i``'s
    pending token (the divergence point — a search step's chosen action)
    before decoding.  All ``n`` requests drain through batched ``step()``
    calls, so siblings decode together.  Returns the per-child sampled
    token streams, the sandboxes (empty list when ``release``), and the
    fork accounting."""
    children, result = fork_sandboxes(tree, ckpt_id, n)
    sids: List[int] = []
    try:
        for i, sandbox in enumerate(children):
            if actions is not None:
                # overwrite the pending token: K/V not yet written, so this
                # is the first divergent write's *cause*, not a write itself
                sandbox.proc.tokens[-1] = int(actions[i])
            sid = scheduler.admit_forked(sandbox.proc)
            sandbox.sched_sid = sid
            sids.append(sid)
        futs = [scheduler.request_tokens(sid, k_tokens) for sid in sids]
        while any(not f.done() for f in futs):
            scheduler.step()
        streams = [list(f.result()) for f in futs]
    finally:
        for sandbox, sid in zip(children, sids):
            try:
                sandbox.proc = scheduler.detach(sid)
            except Exception:
                pass
        if release:
            for sandbox in children:
                tree.release(sandbox.sandbox_id)
    return streams, ([] if release else children), result


def checkpoint_burst(
    cr: DeltaCR,
    states: Sequence[ForkableState],
    ckpt_ids: Sequence[int],
    parent_ckpt: Union[Optional[int], Sequence[Optional[int]]] = None,
    *,
    priority: str = "bg",
    wait: bool = False,
) -> Tuple[List[Any], float]:
    """Checkpoint a fan-out burst without head-of-line-blocking decode.

    The deep fan-outs of MCTS expansion and RL rollouts park many sibling
    states at once.  Submitting each dump and waiting would serialize the
    burst on durable-dump latency; this instead enqueues every dump on
    DeltaCR's FIFO worker in one pass — the streaming engine's QoS gate
    bounds in-flight windows and demotes ``priority="bg"`` dumps while the
    scheduler has runnable sessions, so the storm drains in the background
    masked by inference.  ``parent_ckpt`` may be a single id (all states
    dump against one parent — the classic same-template burst) or one id
    per state (a SandboxTree batch whose children descend from different
    nodes).  Returns the dump futures (resolve when durable) and the
    synchronous submit cost in ms (forks + queue pushes only).
    """
    if len(states) != len(ckpt_ids):
        raise ValueError("states and ckpt_ids must align")
    if isinstance(parent_ckpt, (list, tuple)):
        if len(parent_ckpt) != len(states):
            raise ValueError("per-state parents must align with states")
        parents: Sequence[Optional[int]] = parent_ckpt
    else:
        parents = [parent_ckpt] * len(states)
    t0 = time.perf_counter()
    for state, ckpt_id, parent in zip(states, ckpt_ids, parents):
        cr.checkpoint(state, ckpt_id, parent, priority=priority)
    submit_ms = (time.perf_counter() - t0) * 1e3
    futs = [cr.dump_future(c) for c in ckpt_ids]
    if wait:
        for fut in futs:
            if fut is not None:
                fut.result()
    return futs, submit_ms


def sync_gpu_occupation(t_sandbox_s: float, t_gen_s: float, t_train_s: float) -> float:
    """Expected synchronous-RL accelerator occupation (Fig 7c)."""
    return (t_gen_s + t_train_s) / max(t_sandbox_s + t_gen_s + t_train_s, 1e-12)


def staleness(t_sandbox_s: float, t_gen_s: float, t_train_s: float) -> float:
    """Async decoupled-trainer staleness model (§6.2.2): how many rollout
    generations the trainer outpaces the rollouter by."""
    return (t_sandbox_s + t_gen_s) / max(t_train_s, 1e-12) - 1.0
