"""UCT Monte-Carlo Tree Search over DeltaState checkpoints.

Ported unchanged from the JAX package's ``search/mcts.py``.

The paper's primary workload (SWE-Search-style MCTS, §2.1/§6.2.1): every
expansion checkpoints at the parent node and rolls back to arbitrary
ancestors, so C/R latency lands on the critical path once per iteration.

The search tree *is* the snapshot index tree: selection walks SnapshotNodes,
expansion = ``restore(parent) → act → checkpoint``, evaluation runs under
``isolated_eval`` (value-time test isolation, §4.3), and the reachability
GC's ``expandable``/``terminal`` flags are maintained here.

Two drivers share the statistics and selection policy:

* **Serial** (``parallel_leaves=1``, the paper's baseline): one live
  sandbox, rollback-in-place per iteration.
* **Parallel** (``parallel_leaves=k>1``): each batch selects ``k`` leaves
  under a virtual loss, *forks* a live sandbox per leaf from its checkpoint
  through :class:`~repro_torch.core.sandbox_tree.SandboxTree` (template fork +
  shared-layer namespace view — no restore of the trunk), and explores them
  concurrently on a thread pool.  Child checkpoints ride DeltaCR's FIFO
  dump worker and the scheduler's DumpGate exactly like a
  ``checkpoint_burst`` storm.  Value-time isolation comes for free: the
  evaluation runs on the disposable fork *after* its checkpoint froze the
  node, so test side effects die with the fork instead of needing a
  pre-test checkpoint + unconditional rollback.  Under a fixed wall-clock
  budget the parallel driver explores ≈``k×`` the nodes whenever action
  execution (tool calls, LLM round-trips) dominates — the paper's "explore
  substantially more nodes under fixed time budgets" claim, made concrete
  in the JAX package's ``benchmarks/table3_fork_fanout.py``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

from .. import trace
from ..core import StateManager, Sandbox, SandboxTree, reachability_gc

__all__ = ["MCTSConfig", "AgentTask", "MCTS", "MCTSStats"]


class AgentTask(Protocol):
    """The environment an agent explores inside the sandbox."""

    def propose_actions(self, sandbox: Sandbox, rng_seed: int) -> Sequence[Any]:
        """Candidate actions at the current state (the LLM proposal step)."""

    def apply_action(self, sandbox: Sandbox, action: Any) -> None:
        """Execute one action (mutates fs/proc; may call the engine)."""

    def evaluate(self, sandbox: Sandbox) -> float:
        """Value estimate in [0,1]; may have side effects (run under
        isolated_eval)."""

    def is_terminal(self, sandbox: Sandbox) -> bool: ...

    def is_readonly(self, action: Any) -> bool:
        """True if the action is read-only/idempotent (LW checkpoint, §6.3.3)."""


@dataclasses.dataclass
class MCTSConfig:
    iterations: int = 30
    c_uct: float = 1.2
    expand_width: int = 3           # max children per node
    max_depth: int = 12
    gc_every: int = 0               # 0 = no GC during search
    use_lightweight: bool = True    # route read-only actions to LW checkpoints
    value_isolation: bool = True    # pre-test ckpt + unconditional restore
    seed: int = 0
    dump: bool = True               # durable dumps per checkpoint (False =
                                    # template-only nodes: pure search speed)
    # -- parallel driver -------------------------------------------------
    parallel_leaves: int = 1        # >1: fork-based concurrent expansion
    time_budget_s: Optional[float] = None   # stop when the budget is spent


@dataclasses.dataclass
class MCTSStats:
    iterations: int = 0
    restores: int = 0
    checkpoints: int = 0
    lw_checkpoints: int = 0
    fast_restores: int = 0
    slow_restores: int = 0
    forks: int = 0                  # parallel driver: sandbox forks
    parallel_batches: int = 0
    best_value: float = 0.0
    nodes: int = 0
    wall_s: float = 0.0


class MCTS:
    def __init__(
        self,
        sm: StateManager,
        task: AgentTask,
        cfg: Optional[MCTSConfig] = None,
        *,
        tree: Optional[SandboxTree] = None,
        scheduler: Optional[Any] = None,
    ):
        self.sm = sm
        self.task = task
        # per-instance config: a shared default instance would alias mutable
        # search tuning across every MCTS in the process
        self.cfg = cfg if cfg is not None else MCTSConfig()
        self.tree = tree
        # serving-loop integration: each parallel worker's forked sandbox is
        # admitted into this scheduler's continuous batching for the leaf's
        # lifetime, so task actions can decode through ``scheduler.generate``
        # (engine.step is not thread-safe; the shared batch is)
        self.scheduler = scheduler
        self.stats = MCTSStats()
        # per-ckpt search metadata beyond SnapshotNode's visits/value
        self.depth: Dict[int, int] = {}
        self.untried: Dict[int, List[Any]] = {}
        self._stats_lock = threading.Lock()
        # sandbox ids this run's workers forked and have not yet released —
        # the crash-path cleanup set (a caller-supplied tree may hold other
        # live children that are not ours to tear down)
        self._run_forks: set = set()

    # -------------------------------------------------------------- helpers
    def _uct(self, parent_visits: int, node) -> float:
        if node.visits == 0:
            return float("inf")
        exploit = node.value / node.visits
        explore = self.cfg.c_uct * math.sqrt(math.log(max(parent_visits, 1)) / node.visits)
        return exploit + explore

    def _select(self, root_id: int) -> int:
        """UCT descent to a node with untried actions (or a leaf)."""
        cur = self.sm.node(root_id)
        while True:
            if self.untried.get(cur.ckpt_id) or cur.terminal:
                return cur.ckpt_id
            live_children = [
                self.sm.node(c)
                for c in cur.children
                if c in self.depth and not self.sm.node(c).reclaimed
            ]
            if not live_children:
                return cur.ckpt_id
            cur = max(live_children, key=lambda n: self._uct(cur.visits, n))

    def _backprop(self, ckpt_id: int, value: float) -> None:
        walk: Optional[int] = ckpt_id
        while walk is not None:
            node = self.sm.node(walk)
            node.visits += 1
            node.value += value
            walk = node.parent_id

    def _virtual_loss(self, ckpt_id: int, delta: int) -> None:
        """Discourage (or re-allow) concurrent selection of one path.

        A visit bump with zero value along the path to the root — the
        standard parallel-MCTS device so the k selections of one batch
        spread over the tree instead of piling onto a single leaf."""
        walk: Optional[int] = ckpt_id
        while walk is not None:
            node = self.sm.node(walk)
            node.visits += delta
            walk = node.parent_id

    def _register(
        self, ckpt_id: int, depth: int, seed: int, *, sandbox: Optional[Sandbox] = None
    ) -> None:
        sandbox = sandbox if sandbox is not None else self.sm.sandbox
        self.depth[ckpt_id] = depth
        node = self.sm.node(ckpt_id)
        node.terminal = self.task.is_terminal(sandbox) or depth >= self.cfg.max_depth
        if node.terminal:
            node.expandable = False
            self.untried[ckpt_id] = []
        else:
            actions = list(self.task.propose_actions(sandbox, seed))
            self.untried[ckpt_id] = actions[: self.cfg.expand_width]
            node.expandable = bool(self.untried[ckpt_id])
        self.stats.nodes += 1

    def _register_explored(
        self,
        ckpt_id: int,
        depth: int,
        actions: List[Any],
        terminal: bool,
    ) -> None:
        """Driver-thread registration from a worker's explored snapshot."""
        self.depth[ckpt_id] = depth
        node = self.sm.node(ckpt_id)
        node.terminal = terminal
        node.expandable = bool(actions) and not terminal
        self.untried[ckpt_id] = [] if terminal else list(actions)
        self.stats.nodes += 1

    # ------------------------------------------------------------------ run
    def run(self) -> MCTSStats:
        """One search; its spans and counts carry a run id of their own
        (``repro_torch.trace``), dumps that commit after it returns too."""
        t_run = time.perf_counter()
        with trace.scope(trace.new_run()), trace.span("search.run"):
            if self.cfg.parallel_leaves > 1:
                out = self._run_parallel()
            else:
                out = self._run_serial()
        out.wall_s = time.perf_counter() - t_run
        return out

    def _deadline(self) -> Optional[float]:
        if self.cfg.time_budget_s is None:
            return None
        return time.monotonic() + self.cfg.time_budget_s

    # ----------------------------------------------------------- serial run
    def _run_serial(self) -> MCTSStats:
        cfg, sm, task, st = self.cfg, self.sm, self.task, self.stats

        root = sm.checkpoint(dump=cfg.dump)
        st.checkpoints += 1
        self._register(root, 0, cfg.seed)
        deadline = self._deadline()

        for it in range(cfg.iterations):
            if deadline is not None and time.monotonic() >= deadline:
                break
            st.iterations += 1
            # 1. selection
            target = self._select(root)
            # 2. rollback to the selected node (the paper's critical path)
            if sm.current != target:
                mode = sm.restore(target)
                st.restores += 1
                if mode.startswith("fast"):
                    st.fast_restores += 1
                else:
                    st.slow_restores += 1
            node = sm.node(target)
            if node.terminal:
                value = task.evaluate(sm.sandbox)
                self._backprop(target, value)
                continue
            # 3. expansion: apply one untried action, checkpoint the child
            actions = self.untried[target]
            if not actions:
                node.expandable = False
                self._backprop(target, 0.0)
                continue
            action = actions.pop(0)
            if not actions:
                node.expandable = False
            task.apply_action(sm.sandbox, action)

            lw = cfg.use_lightweight and task.is_readonly(action)
            child = sm.checkpoint(
                lightweight=lw, actions=(action,) if lw else (), dump=cfg.dump
            )
            st.checkpoints += 1
            if lw:
                st.lw_checkpoints += 1
            self._register(child, self.depth[target] + 1, cfg.seed + it + 1)

            # 4. evaluation under value-time isolation
            if cfg.value_isolation:
                value = sm.isolated_eval(lambda sb: task.evaluate(sb))
            else:
                value = task.evaluate(sm.sandbox)
            st.best_value = max(st.best_value, value)

            # 5. backprop
            self._backprop(child, value)

            if cfg.gc_every and (it + 1) % cfg.gc_every == 0:
                reachability_gc(sm)

        return st

    # --------------------------------------------------------- parallel run
    def _run_parallel(self) -> MCTSStats:
        cfg, sm, st = self.cfg, self.sm, self.stats
        tree = self.tree if self.tree is not None else SandboxTree(sm)
        self.tree = tree

        root = sm.checkpoint(dump=cfg.dump)
        st.checkpoints += 1
        self._register(root, 0, cfg.seed)
        deadline = self._deadline()
        run = trace.current()[0]

        pool = ThreadPoolExecutor(
            max_workers=cfg.parallel_leaves, thread_name_prefix="mcts-leaf"
        )
        try:
            it = 0
            while it < cfg.iterations:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                batch = min(cfg.parallel_leaves, cfg.iterations - it)
                # 1. batched selection under virtual loss (driver thread)
                picks: List[Tuple[int, Optional[Any]]] = []
                for _ in range(batch):
                    target = self._select(root)
                    node = sm.node(target)
                    action = None
                    pending = self.untried.get(target)
                    if pending and not node.terminal:
                        action = pending.pop(0)
                        if not pending:
                            node.expandable = False
                    self._virtual_loss(target, +1)
                    picks.append((target, action))
                # 2. fork + explore concurrently; leaf ``it + i`` of the run
                with trace.span("search.batch", leaves=batch):
                    futs = [
                        pool.submit(self._explore_leaf, tree, t, a, cfg.seed + it + i + 1,
                                    (run, it + i))
                        for i, (t, a) in enumerate(picks)
                    ]
                    # Drain EVERY future before acting on any error: virtual
                    # losses must all revert and every successful worker's child
                    # must be registered, or the tree would keep inflated visit
                    # counts and unreachable-but-GC-protected orphan nodes.
                    errors: List[BaseException] = []
                    for (target, action), fut in zip(picks, futs):
                        try:
                            child, value, actions, terminal = fut.result()
                        except BaseException as exc:
                            self._virtual_loss(target, -1)
                            errors.append(exc)
                            continue
                        self._virtual_loss(target, -1)
                        st.iterations += 1
                        st.best_value = max(st.best_value, value)
                        if child is None:        # evaluation-only visit
                            self._backprop(target, value)
                            continue
                        self._register_explored(
                            child, self.depth[target] + 1, actions, terminal
                        )
                        self._backprop(child, value)
                if errors:
                    raise errors[0]
                it += batch
                st.parallel_batches += 1
                if cfg.gc_every and st.parallel_batches % max(1, cfg.gc_every // batch) == 0:
                    reachability_gc(sm)
        finally:
            pool.shutdown(wait=True)
            # release only the forks THIS run created (workers normally
            # already did; this is the crash path) — a caller-supplied tree
            # may hold live children that are not ours to tear down
            with self._stats_lock:
                leaked = list(self._run_forks)
                self._run_forks.clear()
            for sid in leaked:
                tree.release(sid)
        return st

    def _explore_leaf(
        self, tree: SandboxTree, target: int, action: Optional[Any], seed: int,
        ctx: Tuple[Optional[int], int],
    ) -> Tuple[Optional[int], float, List[Any], bool]:
        """One leaf on a worker thread, under the driver's ``(run, leaf)``:
        the ``search.leaf`` span names the child it checkpointed."""
        with trace.scope(*ctx), trace.span("search.leaf") as leaf:
            out = self._explore(tree, target, action, seed)
            leaf.set(ckpt=out[0])
            return out

    def _explore(
        self, tree: SandboxTree, target: int, action: Optional[Any], seed: int
    ) -> Tuple[Optional[int], float, List[Any], bool]:
        """Worker body: fork → act → checkpoint → evaluate → release.

        Returns ``(child_ckpt | None, value, proposed_actions, terminal)``.
        The evaluation runs *after* the child checkpoint froze the node, on
        the disposable fork — its side effects land in the fork's fresh
        upper and die with the release (value-time isolation for free)."""
        cfg, task, st = self.cfg, self.task, self.stats
        sandbox = tree.fork(target, 1)[0]
        with self._stats_lock:
            st.forks += 1
            self._run_forks.add(sandbox.sandbox_id)
        # Serving-loop admission: the fork joins the scheduler's continuous
        # batching for this leaf's lifetime, so apply_action/evaluate can
        # decode through ``scheduler.generate`` — sibling leaves' requests
        # batch into one engine step, CoW keeps their pages shared.
        sched_sid = None
        if self.scheduler is not None:
            sched_sid = self.scheduler.admit_forked(sandbox.proc)
            sandbox.sched_sid = sched_sid
        try:
            if action is None:
                return None, task.evaluate(sandbox), [], False

            task.apply_action(sandbox, action)

            # Read-only actions route to metadata-only LW markers exactly
            # like the serial driver (§6.3.3): no layer freeze, no dump — a
            # later fork/restore of the node replays the action.
            lw = cfg.use_lightweight and task.is_readonly(action)
            if lw:
                child = tree.checkpoint_lightweight(sandbox.sandbox_id, (action,))
            else:
                child = tree.checkpoint(sandbox.sandbox_id, dump=cfg.dump)

            # Registration data (terminal flag, untried actions) must be
            # derived from the frozen checkpoint state, BEFORE evaluate()'s
            # side effects land in the fork — mirroring the serial driver,
            # which registers the child and only then evaluates under
            # isolation.  The evaluation's pollution then dies with the fork.
            try:
                terminal = (
                    task.is_terminal(sandbox)
                    or self.depth[target] + 1 >= cfg.max_depth
                )
                actions: List[Any] = []
                if not terminal:
                    actions = list(task.propose_actions(sandbox, seed))[: cfg.expand_width]
                value = task.evaluate(sandbox)
            except BaseException:
                # the adopted child would otherwise be an orphan the driver
                # never registers but GC protects forever — reclaim it
                tree.release(sandbox.sandbox_id)
                try:
                    self.sm.reclaim(child)
                except Exception:
                    pass
                raise

            with self._stats_lock:
                st.checkpoints += 1
                if lw:
                    st.lw_checkpoints += 1
            return child, value, actions, terminal
        finally:
            if sched_sid is not None:
                try:
                    # rebind: the scheduler may have suspended+resumed the
                    # session (new identity); the tree releases what's live
                    sandbox.proc = self.scheduler.detach(sched_sid)
                except Exception:
                    pass
            tree.release(sandbox.sandbox_id)
            with self._stats_lock:
                self._run_forks.discard(sandbox.sandbox_id)

    # -------------------------------------------------------- result access
    def best_leaf(self) -> Optional[int]:
        best, best_v = None, -1.0
        for node in self.sm.live_nodes():
            if node.visits and node.terminal:
                v = node.value / node.visits
                if v > best_v:
                    best, best_v = node.ckpt_id, v
        if best is None:
            for node in self.sm.live_nodes():
                if node.visits:
                    v = node.value / node.visits
                    if v > best_v:
                        best, best_v = node.ckpt_id, v
        return best
