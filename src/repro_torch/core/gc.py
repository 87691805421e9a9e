"""Reachability-aware snapshot garbage collection (paper §4.2.1, §6.3.4).

Ported unchanged from the JAX package's ``core/gc.py``: it reaches only
this package's StateManager and DeltaCR.

Template eviction is latency-only (the LRU pool inside DeltaCR handles it);
reclaiming *snapshot storage* must respect the search: evicting a dormant
node's image while UCT still holds its Q/visit statistics induces a
restore-fail re-selection loop.  The reachability rule keeps

  * every node UCT may still select: non-terminal AND with remaining
    expansion budget (``expandable``),
  * terminal candidates retained for the final discriminator,
  * every ancestor of a kept node (LW markers replay through their parents;
    the index tree must stay connected),
  * the node the sandbox currently descends from,
  * every node a **live forked sandbox** descends from (the multi-sandbox
    DAG: SandboxTree children pin their base checkpoints, so a layer or
    template is reclaimable only when no live sandbox *or* surviving
    snapshot references it),

and reclaims the rest — safe by construction: only nodes the search itself
has declared unreachable are dropped.  Non-tree search (Best-of-N), where
nodes are never re-selected, uses plain recency.

GC is **non-blocking** end to end: reclaiming a node whose child delta dump
is still in flight hands the image to the refcounted
:class:`~repro_torch.core.image_store.ImageStore`, which returns the chunks when
the dependent dump commits or aborts — a GC pass never waits on the dump
worker (the old ``wait_dumps()`` convention is gone).  ``stats_out``
surfaces the deferral so callers/benchmarks can observe it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from .state_manager import CheckpointError, StateManager

__all__ = ["reachability_gc", "recency_gc"]


def _fill_stats(sm: StateManager, reclaimed: List[int], stats_out: Optional[Dict]) -> None:
    if stats_out is None:
        return
    images = sm.deltacr.images
    stats_out["reclaimed"] = list(reclaimed)
    # images whose checkpoint is gone but whose chunks are pinned by an
    # in-flight dependent dump — the refcounting plane's deferred frees
    stats_out["deferred_images"] = images.deferred_count()
    stats_out["live_images"] = images.live_count()
    # resident bytes by storage tier (hot always; warm/cold when the chunk
    # store has a TierManager attached) — GC pressure feeds demotion policy
    stats_out["tier_bytes"] = sm.deltacr.store.tier_bytes()


def reachability_gc(
    sm: StateManager,
    *,
    keep_terminal_candidates: bool = True,
    stats_out: Optional[Dict] = None,
) -> List[int]:
    """Run one GC pass; returns the list of reclaimed ckpt ids."""
    keep: Set[int] = set()
    for node in sm.live_nodes():
        selectable = (not node.terminal) and node.expandable
        terminal_candidate = keep_terminal_candidates and node.terminal
        if selectable or terminal_candidate:
            keep.add(node.ckpt_id)
    if sm.current is not None:
        keep.add(sm.current)
    keep |= sm.pinned_ckpts()            # live forked sandboxes' bases
    closed = _close_over_replay_chains(sm, keep)
    reclaimed = []
    for node in sm.live_nodes():
        if node.ckpt_id not in closed:
            try:
                sm.reclaim(node.ckpt_id)
            except CheckpointError:
                continue            # pinned by a fork racing this pass
            reclaimed.append(node.ckpt_id)
    _fill_stats(sm, reclaimed, stats_out)
    return reclaimed


def _close_over_replay_chains(sm: StateManager, keep: Set[int]) -> Set[int]:
    """Full checkpoints are self-contained (delta images carry a complete
    chunk map); only *lightweight* markers need their replay chain up to the
    nearest full ancestor."""
    closed: Set[int] = set()
    for ckpt_id in keep:
        walk = ckpt_id
        while walk is not None and walk not in closed:
            closed.add(walk)
            node = sm.nodes[walk]
            walk = node.parent_id if node.lightweight else None
    return closed


def recency_gc(
    sm: StateManager, *, keep_last: int = 8, stats_out: Optional[Dict] = None
) -> List[int]:
    """Plain recency policy for non-tree (Best-of-N style) search."""
    live = sorted(sm.live_nodes(), key=lambda n: n.created_at, reverse=True)
    protected = {n.ckpt_id for n in live[:keep_last]}
    if sm.current is not None:
        protected.add(sm.current)
    protected |= sm.pinned_ckpts()       # live forked sandboxes' bases
    closed = _close_over_replay_chains(sm, protected)
    reclaimed = []
    for node in live[keep_last:]:
        if node.ckpt_id not in closed:
            try:
                sm.reclaim(node.ckpt_id)
            except CheckpointError:
                continue            # pinned by a fork racing this pass
            reclaimed.append(node.ckpt_id)
    _fill_stats(sm, reclaimed, stats_out)
    return reclaimed
