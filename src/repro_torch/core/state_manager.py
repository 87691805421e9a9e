"""StateManager — coupled (durable, ephemeral) checkpoint/restore protocol.

Enforces the paper's invariant: *every saved state is a consistent
(filesystem, memory) pair*, here a consistent (DeltaFS namespace, session
state) pair observed at the same dispatch-quiesce point.

Responsibilities (paper §3.2, §3.3, §4.3):

* ``checkpoint()`` — atomically: freeze+insert the DeltaFS upper layer
  (synchronous, O(1)) and fork a DeltaCR template + submit the async dump.
  Both observe the sandbox between committed steps.  On dump-submission
  failure the DeltaFS switch is rolled back (no half-states).
* ``restore()`` — kill the current session, switch the DeltaFS stack to the
  target's layer config *before* the new session state is produced, then
  template-fork (fast) or image-rebuild (slow).
* **Snapshot index tree** isomorphic to the search tree: each node records
  {ckpt id, parent, layer config, dump future, template liveness, UCT stats}.
* **Lightweight checkpoints** for read-only actions: a metadata marker whose
  restore replays the recorded actions on the parent's state (§6.3.3).
* **Value-time test isolation**: pre-test checkpoint + unconditional restore
  around side-effecting evaluations (§4.3).
* **Multi-sandbox support**: :class:`~repro.core.sandbox_tree.SandboxTree`
  children *pin* the checkpoints they descend from (``pin``/``unpin``) —
  pinned nodes are exempt from ``reclaim`` and protected by GC — and
  register their checkpoints through ``allocate_ckpt_id``/``adopt_node``
  without moving the trunk's ``current``.
* **Lifecycle plane**: image ownership lives in DeltaCR's refcounted
  :class:`~repro_torch.core.image_store.ImageStore` — ``reclaim`` is non-blocking
  and never needs a ``wait_dumps()`` convention (a dependent in-flight dump
  holds its own reference on the parent image) — and the whole tree is
  persistable: ``snapshot_tree``/``load_tree`` round-trip the node graph
  through the crash-consistent manifest in :mod:`~repro.core.persist`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .delta_pipeline import mark_clean, mark_unknown
from .deltacr import DeltaCR, ForkableState
from .deltafs import DeltaFS, LayerConfig
from .npd import InferenceProxy

__all__ = ["Sandbox", "SnapshotNode", "StateManager", "CheckpointError"]


class CheckpointError(RuntimeError):
    pass


@dataclass
class SnapshotNode:
    """One node of the snapshot index tree (isomorphic to the search tree)."""

    ckpt_id: int
    parent_id: Optional[int]
    layer_config: Optional[LayerConfig]          # None for lightweight nodes
    lightweight: bool = False
    replay_actions: Tuple[Any, ...] = ()         # LW: actions to replay on parent
    children: List[int] = field(default_factory=list)
    # Search bookkeeping consumed by reachability-aware GC:
    terminal: bool = False
    expandable: bool = True
    visits: int = 0
    value: float = 0.0
    reclaimed: bool = False
    created_at: float = field(default_factory=time.monotonic)


class Sandbox:
    """A rollbackable sandbox: DeltaFS namespace + forkable session state.

    The agent "worker" lives inside: callers act on the sandbox through
    ``fs`` (durable tensors) and ``proc`` (live session state), and the
    StateManager C/R-protects every step.
    """

    def __init__(
        self,
        fs: DeltaFS,
        proc: ForkableState,
        *,
        proxy: Optional[InferenceProxy] = None,
        sandbox_id: int = 0,
    ):
        self.fs = fs
        self.proc = proc
        self.proxy = proxy
        self.sandbox_id = sandbox_id

    def quiesced(self) -> bool:
        return self.proxy is None or self.proxy.quiesced()


class StateManager:
    """Host-side Sandbox Controller + guest-side execution, in one process.

    The split in the paper (Controller over vsock → GSD) is preserved as an
    API boundary: everything under ``_guest_*`` is what a GSD would execute
    locally inside the VM/device island.
    """

    def __init__(
        self,
        sandbox: Sandbox,
        deltacr: DeltaCR,
        *,
        require_quiesce: bool = True,
        fail_dump_for_test: Optional[Callable[[int], bool]] = None,
    ):
        self.sandbox = sandbox
        self.deltacr = deltacr
        self.require_quiesce = require_quiesce
        self._fail_dump_for_test = fail_dump_for_test
        self.nodes: Dict[int, SnapshotNode] = {}
        self._next_ckpt = 1
        self._current: Optional[int] = None      # checkpoint the session descends from
        self._root_id: Optional[int] = None      # cached tree root (root() is O(1))
        # ckpt_id -> count of live forked sandboxes descending from it; a
        # pinned checkpoint must not be reclaimed (SandboxTree children
        # resolve reads through its layers and dump deltas against it)
        self._pins: Dict[int, int] = {}
        self._lock = threading.RLock()
        # replay-from for LW restore: ckpt_id -> action applier
        self.action_applier: Optional[Callable[[Sandbox, Any], None]] = None
        self.restore_count = 0
        self.checkpoint_count = 0

    # ------------------------------------------------------------ tree api
    @property
    def current(self) -> Optional[int]:
        return self._current

    def node(self, ckpt_id: int) -> SnapshotNode:
        return self.nodes[ckpt_id]

    def root(self) -> Optional[SnapshotNode]:
        """The tree root, O(1): cached at registration instead of scanned."""
        with self._lock:
            if self._root_id is None:
                return None
            return self.nodes.get(self._root_id)

    # ---------------------------------------------------------- fork pins
    def pin(self, ckpt_id: int) -> None:
        """Record a live forked sandbox descending from ``ckpt_id``.

        Pinned checkpoints are exempt from ``reclaim`` and are added to the
        GC keep set: a layer or template is reclaimable only when no live
        sandbox *or* surviving snapshot references it."""
        with self._lock:
            node = self.nodes.get(ckpt_id)
            if node is None:
                raise KeyError(f"cannot pin unknown checkpoint {ckpt_id}")
            if node.reclaimed:
                # atomic with reclaim (same lock): a fork that lost the race
                # against GC must fail here, never restore freed state
                raise KeyError(f"cannot pin reclaimed checkpoint {ckpt_id}")
            self._pins[ckpt_id] = self._pins.get(ckpt_id, 0) + 1

    def unpin(self, ckpt_id: int) -> None:
        with self._lock:
            n = self._pins.get(ckpt_id, 0)
            if n <= 1:
                self._pins.pop(ckpt_id, None)
            else:
                self._pins[ckpt_id] = n - 1

    def pinned_ckpts(self) -> frozenset:
        with self._lock:
            return frozenset(self._pins)

    def release_recovered_pins(self) -> Dict[int, int]:
        """Clear every pin and return the previous {ckpt: count} mapping.

        Pins represent *live* forked sandboxes — process-local state.  After
        a restart recovery the pinning children no longer exist, so a caller
        that is not going to re-attach forked work (rebuild a SandboxTree
        over the persisted bases) releases the recovered pins here;
        otherwise the pinned nodes would be unreclaimable forever."""
        with self._lock:
            pins, self._pins = self._pins, {}
            return pins

    # ------------------------------------------------- forked-child support
    def allocate_ckpt_id(self) -> int:
        """Reserve a checkpoint id (SandboxTree children checkpoint
        concurrently; id allocation must be atomic across them)."""
        with self._lock:
            ckpt_id = self._next_ckpt
            self._next_ckpt += 1
            return ckpt_id

    def adopt_node(
        self,
        ckpt_id: int,
        parent_id: Optional[int],
        layer_config: Optional[LayerConfig],
        *,
        lightweight: bool = False,
        replay_actions: Tuple[Any, ...] = (),
    ) -> SnapshotNode:
        """Register a checkpoint produced by a forked sandbox.

        Unlike :meth:`checkpoint` this does not move ``current`` — the trunk
        session keeps descending from its own node; the new node hangs off
        ``parent_id`` exactly like a child the trunk itself expanded."""
        with self._lock:
            if ckpt_id in self.nodes:
                raise ValueError(f"checkpoint {ckpt_id} already registered")
            node = SnapshotNode(
                ckpt_id=ckpt_id,
                parent_id=parent_id,
                layer_config=layer_config,
                lightweight=lightweight,
                replay_actions=tuple(replay_actions),
            )
            self.nodes[ckpt_id] = node
            if parent_id is not None:
                self.nodes[parent_id].children.append(ckpt_id)
            elif self._root_id is None:
                self._root_id = ckpt_id
            self.checkpoint_count += 1
            return node

    # ---------------------------------------------------------- checkpoint
    def checkpoint(
        self,
        *,
        lightweight: bool = False,
        actions: Tuple[Any, ...] = (),
        dump: bool = True,
    ) -> int:
        """Take a coupled checkpoint of the sandbox; returns the ckpt id.

        Blocking work: DeltaFS layer freeze+insert + template fork (both
        O(metadata)).  The durable dump runs asynchronously, masked by the
        inference window.
        """
        with self._lock:
            if self.require_quiesce and not self.sandbox.quiesced():
                raise CheckpointError("sandbox not quiesced: in-flight dispatch")
            ckpt_id = self._next_ckpt
            self._next_ckpt += 1
            parent = self._current

            if lightweight:
                # §6.3.3: read-only/idempotent step — metadata marker only.
                node = SnapshotNode(
                    ckpt_id=ckpt_id,
                    parent_id=parent,
                    layer_config=None,
                    lightweight=True,
                    replay_actions=tuple(actions),
                )
                self.nodes[ckpt_id] = node
                if parent is not None:
                    self.nodes[parent].children.append(ckpt_id)
                elif self._root_id is None:
                    self._root_id = ckpt_id
                self._current = ckpt_id
                self.checkpoint_count += 1
                return ckpt_id

            # 1. DeltaFS: synchronous freeze + fresh upper (the ioctl).
            config = self.sandbox.fs.checkpoint()
            try:
                if self._fail_dump_for_test and self._fail_dump_for_test(ckpt_id):
                    raise CheckpointError("injected dump failure")
                # 2. DeltaCR: template fork + async dump submission.
                self.deltacr.checkpoint(
                    self.sandbox.proc, ckpt_id, self._nearest_full(parent), dump=dump
                )
            except Exception as exc:
                # §4.3 failure handling: no inconsistent half-state is ever
                # registered.  The live stack already equals the full
                # pre-checkpoint state (every just-frozen layer plus a fresh
                # upper), so the session keeps *all* of its writes — only the
                # caller-retained config reference is dropped.  Switching to a
                # truncated config here would silently discard the frozen
                # upper's writes and desynchronize session and filesystem.
                self.sandbox.fs.release_config(config)
                raise CheckpointError(f"checkpoint {ckpt_id} aborted: {exc}") from exc

            node = SnapshotNode(ckpt_id=ckpt_id, parent_id=parent, layer_config=config)
            self.nodes[ckpt_id] = node
            if parent is not None:
                self.nodes[parent].children.append(ckpt_id)
            elif self._root_id is None:
                self._root_id = ckpt_id
            self._current = ckpt_id
            self.checkpoint_count += 1
            return ckpt_id

    def _nearest_full(self, ckpt_id: Optional[int]) -> Optional[int]:
        """Walk LW markers up to the nearest full checkpoint."""
        while ckpt_id is not None and self.nodes[ckpt_id].lightweight:
            ckpt_id = self.nodes[ckpt_id].parent_id
        return ckpt_id

    # -------------------------------------------------------------- restore
    def restore(self, ckpt_id: int) -> str:
        """Roll the sandbox back to ``ckpt_id``; returns 'fast'|'slow'|'replay'.

        Order (§3.3): kill current session → switch DeltaFS stack → rebuild
        session state → resume.  The new session never observes mismatched
        files.
        """
        with self._lock:
            node = self.nodes.get(ckpt_id)
            if node is None or node.reclaimed:
                raise KeyError(f"checkpoint {ckpt_id} unavailable (reclaimed or unknown)")

            full = self._nearest_full(ckpt_id)
            if full is None:
                raise KeyError(f"checkpoint {ckpt_id} has no full ancestor")
            full_node = self.nodes[full]
            if full_node.reclaimed:
                raise KeyError(f"checkpoint base {full} was reclaimed")

            # 1. Kill the current agent session (SIGKILL analogue).
            self.sandbox.proc.release()

            # 2. DeltaFS switch to the target configuration.
            assert full_node.layer_config is not None
            self.sandbox.fs.switch(full_node.layer_config)

            # 3. DeltaCR fast/slow path.
            new_state, path = self.deltacr.restore(full)
            self.sandbox.proc = new_state
            # The new session is bit-identical to checkpoint ``full``, which
            # is exactly what its next dump will delta against — write
            # tracking restarts here, keyed to ``full``, so the dirty-key
            # hint is exact (LW replay below goes through tracked writes).
            mark_clean(new_state, full)

            # 4. LW replay: re-apply recorded read-only actions on top.
            mode = path
            if full != ckpt_id:
                self.replay_lw_chain(self.sandbox, full, ckpt_id)
                mode = f"{path}+replay"

            self._current = ckpt_id
            self.restore_count += 1
            return mode

    def replay_lw_chain(self, sandbox: Sandbox, full: int, ckpt_id: int) -> int:
        """Re-apply the LW markers' recorded actions between ``full``
        (exclusive) and ``ckpt_id`` (inclusive) on ``sandbox``.

        The one replay loop shared by trunk restore and SandboxTree forks
        from lightweight nodes; returns the number of actions replayed."""
        chain: List[SnapshotNode] = []
        walk: Optional[int] = ckpt_id
        while walk is not None and walk != full:
            chain.append(self.nodes[walk])
            walk = self.nodes[walk].parent_id
        replayed = 0
        for lw in reversed(chain):
            for action in lw.replay_actions:
                if self.action_applier is None:
                    raise CheckpointError("LW replay requires action_applier")
                self.action_applier(sandbox, action)
                replayed += 1
        return replayed

    # ------------------------------------------------- value-time isolation
    def isolated_eval(self, fn: Callable[[Sandbox], Any]) -> Any:
        """Run a side-effecting evaluation, then unconditionally roll back.

        The paper's value-time test isolation: pre-test checkpoint, run the
        tests, read the observation, restore — mimicking a side-effect-free
        execution for the search's value function.  The pre-test checkpoint
        is *transient*: no durable dump, and it is removed from the snapshot
        index after the restore so searches never select it.
        """
        pre = self.checkpoint(dump=False)
        try:
            return fn(self.sandbox)
        finally:
            self.restore(pre)
            self._drop_transient(pre)

    def _drop_transient(self, ckpt_id: int) -> None:
        with self._lock:
            # The session now descends from the *dropped* node, so its write
            # tracking no longer describes the delta against the parent the
            # next checkpoint will dump against — treat everything as dirty.
            mark_unknown(self.sandbox.proc)
            node = self.nodes[ckpt_id]
            assert not node.children, "transient checkpoint grew children"
            self.reclaim(ckpt_id)
            if node.parent_id is not None:
                self.nodes[node.parent_id].children.remove(ckpt_id)
            del self.nodes[ckpt_id]
            if self._root_id == ckpt_id:
                self._root_id = None
            if self._current == ckpt_id:
                self._current = node.parent_id

    # ------------------------------------------------- persistence support
    def snapshot_tree(self) -> Dict[str, Any]:
        """JSON-able snapshot of the snapshot-index tree.

        Consumed by the persistence plane (:mod:`~repro.core.persist`).
        Layer configs are emitted with *live* layer ids — the plane remaps
        them to canonical snapshot ids.  Reclaimed nodes persist as
        config-less tombstones so child links stay resolvable."""
        with self._lock:
            nodes = []
            for cid in sorted(self.nodes):
                n = self.nodes[cid]
                cfg = None if (n.reclaimed or n.layer_config is None) else list(n.layer_config)
                nodes.append(
                    {
                        "ckpt_id": n.ckpt_id,
                        "parent_id": n.parent_id,
                        "layer_config": cfg,
                        "lightweight": n.lightweight,
                        "replay_actions": list(n.replay_actions),
                        "children": list(n.children),
                        "terminal": n.terminal,
                        "expandable": n.expandable,
                        "visits": n.visits,
                        "value": n.value,
                        "reclaimed": n.reclaimed,
                        "created_at": n.created_at,
                    }
                )
            return {
                "nodes": nodes,
                "current": self._current,
                "root": self._root_id,
                "next_ckpt": self._next_ckpt,
                "pins": {str(k): v for k, v in sorted(self._pins.items())},
            }

    def load_tree(
        self, snap: Dict[str, Any], *, layer_map: Optional[Dict[int, int]] = None
    ) -> None:
        """Rebuild the node graph from :meth:`snapshot_tree` output.

        Restart recovery: must run on a freshly constructed StateManager.
        ``layer_map`` translates persisted layer ids to the recovered
        LayerStore's ids.  The caller (the persistence plane) is responsible
        for retaining each restored config's layer references."""
        with self._lock:
            if self.nodes:
                raise RuntimeError("load_tree requires an empty StateManager")
            for nd in snap["nodes"]:
                cfg = nd["layer_config"]
                if cfg is not None and layer_map is not None:
                    cfg = [layer_map[int(l)] for l in cfg]
                node = SnapshotNode(
                    ckpt_id=int(nd["ckpt_id"]),
                    parent_id=None if nd["parent_id"] is None else int(nd["parent_id"]),
                    layer_config=None if cfg is None else tuple(int(l) for l in cfg),
                    lightweight=bool(nd["lightweight"]),
                    replay_actions=tuple(nd["replay_actions"]),
                )
                node.children = [int(c) for c in nd["children"]]
                node.terminal = bool(nd["terminal"])
                node.expandable = bool(nd["expandable"])
                node.visits = int(nd["visits"])
                node.value = float(nd["value"])
                node.reclaimed = bool(nd["reclaimed"])
                node.created_at = float(nd["created_at"])
                self.nodes[node.ckpt_id] = node
                self.checkpoint_count += 1
            self._current = None if snap["current"] is None else int(snap["current"])
            self._root_id = None if snap["root"] is None else int(snap["root"])
            self._next_ckpt = int(snap["next_ckpt"])
            self._pins = {int(k): int(v) for k, v in snap["pins"].items()}

    # ------------------------------------------------------------------ gc
    def reclaim(self, ckpt_id: int) -> None:
        """Release a node's storage (template + dump + layer refs).

        Non-blocking even while a dependent child dump is still in flight:
        the dump holds its own ImageStore reference on this node's image, so
        the chunks are returned exactly when it commits or aborts — no
        ``wait_dumps()`` convention anywhere in the reclaim path.

        Refuses while live forked sandboxes still descend from the node:
        their reads resolve through its layers and their next dump deltas
        against its image, so reclaiming it would corrupt live sessions."""
        with self._lock:
            node = self.nodes[ckpt_id]
            if node.reclaimed:
                return
            if self._pins.get(ckpt_id, 0) > 0:
                raise CheckpointError(
                    f"checkpoint {ckpt_id} is pinned by "
                    f"{self._pins[ckpt_id]} live forked sandbox(es)"
                )
            node.reclaimed = True
            if not node.lightweight:
                self.deltacr.drop_checkpoint(ckpt_id)
                if node.layer_config is not None:
                    self.sandbox.fs.release_config(node.layer_config)

    def live_nodes(self) -> List[SnapshotNode]:
        return [n for n in self.nodes.values() if not n.reclaimed]
