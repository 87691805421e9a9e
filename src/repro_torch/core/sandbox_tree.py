"""SandboxTree — N concurrent live sandboxes over one shared lineage.

Ported unchanged from the JAX package's ``core/sandbox_tree.py``.  The
process state may be device state (a ``CowTensorState`` or a
``PagedSession`` on the card): a fork is a template fork, which moves no
device bytes.

The paper's payoff is fan-out: millisecond C/R only buys search throughput
if the driver can hold *many* live branches at once.  The single-sandbox
:class:`~repro_torch.core.state_manager.StateManager` rolls one session back and
forth through the snapshot tree; this module turns that tree into a
**concurrent** one, the Fork-Explore-Commit primitive of the agentic-OS
line of work:

* ``fork(ckpt_id, n)`` — materialize ``n`` live :class:`Sandbox` children
  from any registered checkpoint, each with

  - **process state** via the DeltaCR template pool (``restore`` = template
    fork, O(state metadata) — page-table copies and refcount bumps, no data
    movement), and
  - **files** via a fresh :class:`~repro_torch.core.deltafs.NamespaceView` over
    the shared :class:`~repro_torch.core.deltafs.LayerStore`, based on the
    checkpoint's frozen layer configuration — sibling sandboxes share every
    frozen layer's chunk *bytes* and diverge only in their private writable
    uppers.

  Children read bit-identically to the checkpoint, write in mutual
  isolation, and pin their base node so GC/reclaim never pulls layers or
  dump images out from under a live session.

* ``checkpoint(sandbox_id)`` — freeze a child's upper and register the
  result as a :class:`SnapshotNode` hanging off the child's base, exactly
  like a node the trunk expanded; the durable dump rides DeltaCR's FIFO
  worker and the scheduler's :class:`~repro_torch.core.stream.DumpGate` QoS like
  any other checkpoint (``checkpoint_many`` submits a fan-out burst without
  blocking on durability).

* ``commit(sandbox_id)`` — the explore winner becomes the trunk: the
  winner's final state is checkpointed, its frozen layers are spliced onto
  the parent lineage (they already share everything below the fork point),
  the trunk session restores onto it, and the losers — their live sandboxes
  *and* the snapshot storage only they created — are torn down and
  reclaimed.

Thread-safety: ``fork``/``checkpoint``/``release`` may be called from
worker threads (the parallel MCTS driver does); the tree serializes its own
bookkeeping and always takes its lock *before* any StateManager/DeltaCR
lock, never the reverse.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import trace
from .delta_pipeline import mark_clean
from .deltafs import LayerStore, NamespaceView
from .image_store import ImageRef
from .state_manager import CheckpointError, Sandbox, StateManager

__all__ = ["SandboxTree", "SandboxTreeStats"]


@dataclass
class _Child:
    """Bookkeeping for one live forked sandbox."""

    sandbox: Sandbox
    view: NamespaceView
    base_ckpt: int                       # node the sandbox currently descends from
    full_pin: Optional[int] = None       # extra pin on the LW base's full ancestor
    # ImageStore reference on the full base's image: the child's next dump
    # delta-encodes against it, so the image's chunks stay alive even if the
    # base node is force-reclaimed out from under the pins
    image_ref: Optional[ImageRef] = None
    created: List[int] = field(default_factory=list)   # ckpts this child registered
    alive: bool = True
    busy: bool = False                   # checkpoint phase 2 in flight
    deferred_release: bool = False       # released while busy: teardown deferred


@dataclass
class SandboxTreeStats:
    forks: int = 0
    checkpoints: int = 0
    commits: int = 0
    releases: int = 0
    replayed_actions: int = 0


class SandboxTree:
    """Concurrent sandbox controller over one StateManager's snapshot tree.

    The StateManager keeps owning the trunk session and the snapshot index;
    the tree adds live children around it.  Requires the trunk filesystem to
    be a :class:`NamespaceView` (any ``DeltaFS`` is) so children can mount
    views over the same :class:`LayerStore`.
    """

    def __init__(self, sm: StateManager, *, dump_policy=None):
        fs = sm.sandbox.fs
        if not isinstance(fs, NamespaceView):
            raise TypeError("SandboxTree requires a NamespaceView-backed sandbox fs")
        self.sm = sm
        self.cr = sm.deltacr
        if dump_policy is not None:
            # The tree is the lineage's dump-heavy consumer (fan-out forks,
            # commit checkpoints): it may re-point the shared DeltaCR at a
            # DumpPolicy tuned for that shape (e.g. DumpPolicy.latency()).
            self.cr.apply_policy(dump_policy)
        self.layers: LayerStore = fs.layers
        self._lock = threading.RLock()
        self._children: Dict[int, _Child] = {}
        self._next_sandbox_id = max(sm.sandbox.sandbox_id, 0) + 1
        self.stats = SandboxTreeStats()

    # ------------------------------------------------------------------ fork
    def fork(self, ckpt_id: int, n: int = 1) -> List[Sandbox]:
        """Materialize ``n`` live sandboxes observing checkpoint ``ckpt_id``.

        Process state forks from the DeltaCR template (or rebuilds from the
        dump image once, after which the re-injected template serves the
        rest); the filesystem mounts a fresh view over the checkpoint's
        frozen layers — no chunk bytes are copied.  A lightweight ``ckpt_id``
        forks from its nearest full ancestor and replays the recorded
        actions through the StateManager's ``action_applier``.
        """
        if n < 1:
            raise ValueError("fork width must be >= 1")
        with trace.span("tree.fork", ckpt=ckpt_id):
            return self._fork(ckpt_id, n)

    def _fork(self, ckpt_id: int, n: int) -> List[Sandbox]:
        # Validate and pin under the lock; run the (possibly blocking)
        # template restores and LW replays *outside* it so concurrent
        # workers' forks never convoy behind one slow-path restore.  The
        # up-front pins make that safe: the base cannot be reclaimed while
        # any of this call's children are still materializing.
        with self._lock:
            node = self.sm.node(ckpt_id)
            if node.reclaimed:
                raise KeyError(f"checkpoint {ckpt_id} unavailable (reclaimed)")
            full = self.sm._nearest_full(ckpt_id)
            if full is None:
                raise KeyError(f"checkpoint {ckpt_id} has no full ancestor")
            full_node = self.sm.node(full)
            if full_node.reclaimed or full_node.layer_config is None:
                raise KeyError(f"checkpoint base {full} was reclaimed")
            config = full_node.layer_config
            full_pin = full if full != ckpt_id else None
            pinned: List[int] = []
            try:
                for _ in range(n):              # one pin set per child
                    self.sm.pin(ckpt_id)
                    pinned.append(ckpt_id)
                    if full_pin is not None:
                        self.sm.pin(full_pin)
                        pinned.append(full_pin)
            except BaseException:
                # lost a race against GC (pin refuses reclaimed nodes):
                # give back whatever was pinned and surface the KeyError
                for p in pinned:
                    self.sm.unpin(p)
                raise

        children: List[Sandbox] = []
        try:
            for _ in range(n):
                proc, _path = self.cr.restore(full)
                try:
                    view = NamespaceView(self.layers, base_config=config)
                except BaseException:
                    proc.release()
                    raise
                # Bit-identical to ``full``: write tracking restarts here so
                # the child's first dump deltas exactly (replay below goes
                # through tracked writes).
                mark_clean(proc, full)
                with self._lock:
                    sid = self._next_sandbox_id
                    self._next_sandbox_id += 1
                sandbox = Sandbox(view, proc, sandbox_id=sid)
                if full != ckpt_id:
                    try:
                        self._replay_chain(sandbox, full, ckpt_id)
                    except BaseException:
                        proc.release()
                        view.close()
                        raise
                with self._lock:
                    self._children[sid] = _Child(
                        sandbox=sandbox,
                        view=view,
                        base_ckpt=ckpt_id,
                        full_pin=full_pin,
                        # explicit lifecycle-plane ref: the base image this
                        # child will delta against (None for dump-less bases)
                        image_ref=self.cr.images.acquire(full),
                    )
                    self.stats.forks += 1
                children.append(sandbox)
        except BaseException:
            for sandbox in children:            # registered: release + unpin
                self.release(sandbox.sandbox_id)
            with self._lock:
                for _ in range(n - len(children)):   # never materialized
                    self.sm.unpin(ckpt_id)
                    if full_pin is not None:
                        self.sm.unpin(full_pin)
            raise
        return children

    def fork_admitted(self, ckpt_id: int, n: int, scheduler) -> List[Sandbox]:
        """Fork ``n`` live decoders and admit each into a serving scheduler.

        The serving-loop composition of the Fork-Explore-Commit primitive:
        every child's process state (a ``PagedSession``) joins the
        scheduler's continuous batching via ``admit_forked`` — sibling
        decoders share every KV page copy-on-write, so the fan-out costs
        zero block bytes until a child's first divergent write.  Each
        returned sandbox carries its scheduler id as ``sandbox.sched_sid``;
        the caller detaches (``scheduler.detach``) before ``release`` — the
        tree, not the scheduler, owns the proc's lifecycle."""
        children = self.fork(ckpt_id, n)
        admitted: List[int] = []
        try:
            for sandbox in children:
                sid = scheduler.admit_forked(sandbox.proc)
                sandbox.sched_sid = sid
                admitted.append(sid)
        except BaseException:
            for sandbox, sid in zip(children, admitted):
                try:
                    sandbox.proc = scheduler.detach(sid)
                except Exception:
                    pass
            for sandbox in children:
                self.release(sandbox.sandbox_id)
            raise
        return children

    def _replay_chain(self, sandbox: Sandbox, full: int, ckpt_id: int) -> None:
        """Re-apply the LW markers' recorded actions on the forked state
        (the StateManager owns the one replay loop both paths share)."""
        replayed = self.sm.replay_lw_chain(sandbox, full, ckpt_id)
        with self._lock:                 # fork() calls this outside the lock
            self.stats.replayed_actions += replayed

    # ------------------------------------------------------------ checkpoint
    def checkpoint(
        self, sandbox_id: int, *, dump: bool = True, priority: str = "bg"
    ) -> int:
        """Checkpoint a forked child into the shared snapshot tree.

        Synchronous cost is the layer freeze + template fork (O(metadata));
        the durable dump is submitted to DeltaCR's FIFO worker and flows
        through the scheduler's DumpGate QoS.  The child then descends from
        the new node (its pins move up with it).
        """
        # Phase 1 (tree lock): freeze the child's upper, reserve the id, and
        # mark the child *busy* — pure metadata.  Phase 2 (no tree lock):
        # the DeltaCR template fork + dump submission, so k workers'
        # checkpoints don't convoy on one lock.  Phase 3 (tree lock): adopt
        # the node and move the pins.  A child is driven by one worker at a
        # time; a concurrent ``release``/``commit`` of this child (losers of
        # a racing commit) sees ``busy`` and *defers* the actual teardown to
        # phase 3, so the fork in phase 2 never touches freed state.
        with self._lock:
            child = self._live(sandbox_id)
            if child.busy:
                raise RuntimeError(f"sandbox {sandbox_id}: concurrent checkpoint")
            child.busy = True
            config = child.view.checkpoint()
            parent = child.base_ckpt
            full_parent = self.sm._nearest_full(parent)
            ckpt_id = self.sm.allocate_ckpt_id()
        try:
            self.cr.checkpoint(
                child.sandbox.proc, ckpt_id, full_parent, dump=dump, priority=priority
            )
        except Exception as exc:
            # Mirror StateManager's abort contract: the child's live stack
            # already holds every write; drop only the retained config so no
            # half-state is registered.
            with self._lock:
                self.layers.release_config(config)
                deferred = self._clear_busy(sandbox_id, child)
            self._teardown(deferred)
            raise CheckpointError(f"checkpoint {ckpt_id} aborted: {exc}") from exc
        with self._lock:
            if not child.alive:
                # released during phase 2 (teardown was deferred): the node
                # was never adopted — undo the template/dump and the config
                self.cr.drop_checkpoint(ckpt_id)
                self.layers.release_config(config)
                deferred = self._clear_busy(sandbox_id, child)
            else:
                self.sm.adopt_node(ckpt_id, parent_id=parent, layer_config=config)
                self.sm.pin(ckpt_id)
                self._unpin_child(child)
                child.base_ckpt = ckpt_id
                child.full_pin = None
                # the ref moves with the base: the child now deltas against
                # its own new checkpoint's image
                child.image_ref = self.cr.images.acquire(ckpt_id)
                child.created.append(ckpt_id)
                self.stats.checkpoints += 1
                deferred = self._clear_busy(sandbox_id, child)
        self._teardown(deferred)
        if deferred is not None:
            raise KeyError(f"sandbox {sandbox_id} was released mid-checkpoint")
        return ckpt_id

    def _clear_busy(self, sandbox_id: int, child: _Child) -> Optional[_Child]:
        """End a checkpoint's busy window; returns the child if a release
        arrived meanwhile and its teardown is now this caller's to run.
        Caller holds the tree lock."""
        child.busy = False
        if child.deferred_release:
            self._children.pop(sandbox_id, None)
            return child
        return None

    @staticmethod
    def _teardown(child: Optional[_Child]) -> None:
        """Run the deferred heavy teardown outside the tree lock."""
        if child is not None:
            child.sandbox.proc.release()
            child.view.close()

    def checkpoint_lightweight(self, sandbox_id: int, actions) -> int:
        """Register a metadata-only (§6.3.3) marker for a forked child.

        The read-only/idempotent-action analogue of
        ``StateManager.checkpoint(lightweight=True)``: no layer freeze, no
        template fork, no dump — a restore or fork of the marker replays
        ``actions`` on the nearest full ancestor.  The child then descends
        from the marker."""
        with self._lock:
            child = self._live(sandbox_id)
            parent = child.base_ckpt
            ckpt_id = self.sm.allocate_ckpt_id()
            self.sm.adopt_node(
                ckpt_id,
                parent_id=parent,
                layer_config=None,
                lightweight=True,
                replay_actions=tuple(actions),
            )
            self.sm.pin(ckpt_id)
            full = self.sm._nearest_full(ckpt_id)
            if full is not None:
                self.sm.pin(full)
            self._unpin_child(child)
            child.base_ckpt = ckpt_id
            child.full_pin = full
            child.image_ref = (
                self.cr.images.acquire(full) if full is not None else None
            )
            child.created.append(ckpt_id)
            self.stats.checkpoints += 1
            return ckpt_id

    def checkpoint_many(
        self, sandbox_ids, *, dump: bool = True, priority: str = "bg"
    ) -> List[int]:
        """Checkpoint a burst of children without waiting on durability.

        Every dump is enqueued on DeltaCR's single FIFO worker in one pass
        (the ``checkpoint_burst`` submission pattern); the DumpGate bounds
        in-flight windows and demotes background dumps while sessions are
        runnable, so the storm drains masked by inference."""
        return [
            self.checkpoint(sid, dump=dump, priority=priority) for sid in sandbox_ids
        ]

    # --------------------------------------------------------------- release
    def release(self, sandbox_id: int) -> None:
        """Tear down a live child: session killed, private upper freed,
        base pins dropped.  Checkpoints the child registered survive (they
        are ordinary snapshot nodes; GC decides their fate)."""
        with self._lock:
            child = self._children.get(sandbox_id)
            if child is None or not child.alive:
                return
            child.alive = False
            self._unpin_child(child)
            self.stats.releases += 1
            if child.busy:
                # a checkpoint's phase 2 holds live references to the proc
                # and view; it runs the teardown when it finishes
                child.deferred_release = True
                return
            self._children.pop(sandbox_id, None)
        # The actual teardown — CoW page drops and the O(dirty-chunks)
        # decref walk of the private upper — runs outside the tree lock so
        # releases never convoy concurrent forks/checkpoints.  Safe: the
        # view's own stack references keep its layers alive until close().
        child.sandbox.proc.release()
        child.view.close()

    def release_all(self) -> None:
        with self._lock:
            sids = list(self._children)
        for sid in sids:                 # teardowns run outside the lock
            self.release(sid)

    # ---------------------------------------------------------------- commit
    def commit(self, sandbox_id: int, *, reclaim_losers: bool = True) -> int:
        """Promote one child to the trunk; drop every other live child.

        The Fork-Explore-Commit primitive: the winner's current state is
        checkpointed (freezing its last writes), the trunk session restores
        onto that node — splicing the winner's frozen layers onto the parent
        lineage, with which they already share every unmodified chunk — and
        the losers are released.  With ``reclaim_losers`` (default) the
        snapshot storage only losing children created is reclaimed as well;
        the winner's lineage is never touched.  Returns the committed
        checkpoint id.
        """
        with self._lock:
            self._live(sandbox_id)           # raise before any work
        # The winner checkpoint runs through the normal phased path (its
        # heavy phase 2 outside the tree lock); losers are then *collected*
        # under the lock but torn down outside it, so a commit never convoys
        # concurrent forks/checkpoints behind O(losers' dirty chunks) work.
        final = self.checkpoint(sandbox_id)
        with self._lock:
            lineage: Set[int] = set()
            walk: Optional[int] = final
            while walk is not None:
                lineage.add(walk)
                walk = self.sm.node(walk).parent_id
            loser_ids = [s for s in self._children if s != sandbox_id]
            loser_created: List[int] = []
            for sid in loser_ids:
                loser_created.extend(self._children[sid].created)
            self.stats.commits += 1
        for sid in loser_ids:
            self.release(sid)
        # The winner's live sandbox is consumed by the commit: its state
        # *is* ``final`` now, and the trunk takes over from there.
        self.release(sandbox_id)
        # The trunk restore (possibly a slow dump-image rebuild) and the
        # loser reclaim also run outside the tree lock; a loser node a
        # concurrent fork re-pins in the gap is simply skipped.
        self.sm.restore(final)
        if reclaim_losers:
            for ckpt in loser_created:
                if ckpt in lineage:
                    continue
                node = self.sm.node(ckpt)
                if node.reclaimed:
                    continue
                try:
                    self.sm.reclaim(ckpt)
                except CheckpointError:
                    continue             # re-pinned by a concurrent fork
        return final

    # ------------------------------------------------------------- accessors
    def sandbox(self, sandbox_id: int) -> Sandbox:
        with self._lock:
            return self._live(sandbox_id).sandbox

    def base_ckpt(self, sandbox_id: int) -> int:
        with self._lock:
            return self._live(sandbox_id).base_ckpt

    def live_sandboxes(self) -> List[Sandbox]:
        with self._lock:
            return [c.sandbox for c in self._children.values() if c.alive]

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for c in self._children.values() if c.alive)

    def debug_validate(self) -> None:
        self.layers.debug_validate()

    # -------------------------------------------------------------- internal
    def _live(self, sandbox_id: int) -> _Child:
        child = self._children.get(sandbox_id)
        if child is None or not child.alive:
            raise KeyError(f"sandbox {sandbox_id} is not a live forked child")
        return child

    def _unpin_child(self, child: _Child) -> None:
        self.sm.unpin(child.base_ckpt)
        if child.full_pin is not None:
            self.sm.unpin(child.full_pin)
            child.full_pin = None
        if child.image_ref is not None:
            self.cr.images.release(child.image_ref)
            child.image_ref = None
