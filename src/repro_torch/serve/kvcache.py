"""Paged, copy-on-write KV cache — the device-side "process memory".

Ported from the JAX package's ``serve/kvcache.py``.  The pool is the
analogue of a kernel page table + physical pages:

* **Pool**: per attention sublayer, ``(N_periods, P, page_size, KVH, Hd)``
  K and V tensors on the device (stacked per period to match the model's
  stacked params).  Page 0 is reserved as the filler entry for inactive
  page-table slots.
* **Page tables**: per session, ``(max_pages,)`` int32 on the host.  Fork =
  copy the table + bump refcounts — O(pages) integers, zero device
  traffic.
* **CoW**: the decode step writes in place, so before each step the
  manager *privatizes* every session's write-target page whose refcount
  > 1: allocate a free page, copy its contents with the
  ``page_copy_stacked`` kernel (one launch covers the K and V pools of
  every sublayer and every period), swap the table entry.  ``warm`` runs
  the same privatization off the critical path (async-warm).
* **Refcount GC**: releasing a session/template decrefs its pages; pages
  at refcount 0 return to the free list.

Host bookkeeping is numpy.  The pool tensors are updated in place (the
JAX package rebinds donated arrays).  That is safe for a dump's lazily
built page grid because a checkpoint's template keeps its pages
referenced, and every write lands on a page whose refcount is 1.

``device=None`` means the card; pass ``device="cpu"`` to run on the CPU.

A pool may carry a ``sharding`` (a ``dist.placement.NamedSharding`` over the
pool axes ``(periods, P, psz, KVH, Hd)``, e.g. the KV heads over "model").
The pool tensors stay whole on the pool's device, so the engine and
``paged_attention`` read them unchanged; what the sharding changes is the
dump: a session's gathered page grids are placed on :meth:`PagePool.
grid_sharding` and exposed as ``ShardedView``s under the canonical tile
plan, so each rank's block is diffed and drained on its own and the image
is tiled — its chunk ids and digests equal any other layout's.  That dump is
O(delta) only against a parent at the same page count: the plan follows the
grid's shape, and a new page changes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..configs.base import ModelConfig
from ..core import faults
from ..core.convert import tensor_from_numpy
from ..core.delta_pipeline import ChunkedView, DeltaGeneration
from ..core.deltacr import resolve_device
from ..core.deltafs import dtype_str, read_meta_array
from ..dist import shard_dump as _sd
from ..dist.placement import NamedSharding, PartitionSpec, ShardedTensor, device_put
from ..kernels import ops as kops
from ..models.model import RECURRENT_KINDS

__all__ = [
    "CowCorruptionError",
    "CowFaultError",
    "PagePool",
    "PagedSession",
    "PoolStats",
    "WritePlan",
]


class CowFaultError(RuntimeError):
    """A CoW materialization failed and was rolled back (no table mutated)."""


class CowCorruptionError(CowFaultError):
    """Verified CoW copy mismatched its source; the batch was rolled back."""


@dataclass
class PoolStats:
    """Block accounting for the pool: forks are free until the first write,
    and these counters prove it (tests and the smoke run gate on them)."""

    cow_copies: int = 0        # pages privatized on the step path
    warm_copies: int = 0       # pages privatized by async-warm
    copied_pages: int = 0      # total pages materialized (cow + warm)
    copied_bytes: int = 0      # bytes moved by CoW materialization
    fresh_allocs: int = 0      # fresh page-boundary allocations (no copy)
    materialize_calls: int = 0 # batched materialization rounds (≤1/step)
    cow_rollbacks: int = 0     # failed materializations fully rolled back
    stale_discards: int = 0    # plans that lost a same-session race (warm
                               # vs step) and were discarded at commit time


@dataclass
class WritePlan:
    """One session's planned page motion for an upcoming write window.

    Built by :meth:`PagedSession.plan_writable` (pages are *allocated* but
    no table entry, refcount-decref, or dirty set has been touched), then
    either committed or rolled back atomically — across a whole batch — by
    :meth:`PagePool.materialize`."""

    session: "PagedSession"
    fresh: List[Tuple[int, int]]        # (table pos, newly allocated page)
    cow: List[Tuple[int, int, int]]     # (table pos, shared src, private dst)
    window: Tuple[int, int]             # (first_page, last_page) dirty span


def _as_pool_tensor(value: Any, pool: torch.Tensor) -> torch.Tensor:
    """A payload array as a tensor of the pool's dtype on its device.

    bfloat16 that arrives as 16-bit words (numpy holds no bfloat16) is
    reinterpreted bit for bit, never converted; any other dtype is cast as
    the JAX package's ``astype`` would.  A sharded value (a tiled image
    decoded per part) is assembled from its blocks on the pool's device."""
    if isinstance(value, ShardedTensor):
        value = value.full(pool.device)
    t = value if isinstance(value, torch.Tensor) else tensor_from_numpy(np.asarray(value))
    if t.dtype != pool.dtype:
        if pool.dtype == torch.bfloat16 and t.dtype in (torch.int16, torch.uint16):
            t = t.view(torch.bfloat16)
        else:
            t = t.to(pool.dtype)
    return t.to(pool.device)


class PagePool:
    """Global page pool + refcounts + free list for one served model."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        num_pages: int,
        page_size: int = 16,
        max_pages_per_session: int = 32,
        dtype: Optional[str] = None,
        verify_cow: bool = False,
        device: Any = None,
        sharding: Optional[NamedSharding] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        # placement of the pool axes (periods, P, psz, KVH, Hd) over a mesh,
        # read by the dump; the page axis (1) must stay unsharded, since
        # page gathers index it with host-chosen page lists
        if sharding is not None and len(sharding.spec) > 1 and sharding.spec[1] is not None:
            raise ValueError(f"the page axis must stay unsharded, got {sharding.spec}")
        self.sharding = sharding
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages = max_pages_per_session
        dt = getattr(torch, dtype or cfg.dtype)
        # stage -> tag -> stacked (N_periods, P, psz, KVH, Hd)
        self.pools_k: Dict[str, Dict[str, torch.Tensor]] = {}
        self.pools_v: Dict[str, Dict[str, torch.Tensor]] = {}
        self.attn_tags: List[Tuple[str, str]] = []
        for i, stage in enumerate(cfg.stages):
            sk, sv = {}, {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    if kind in ("attn", "attn_local"):
                        tag = f"l{li}_s{si}_{kind}"
                        shape = (stage.n_periods, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
                        sk[tag] = torch.zeros(shape, dtype=dt, device=self.device)
                        sv[tag] = torch.zeros(shape, dtype=dt, device=self.device)
                        self.attn_tags.append((f"stage{i}", tag))
            self.pools_k[f"stage{i}"] = sk
            self.pools_v[f"stage{i}"] = sv
        # session extras keys ("stage{i}/{tag}") that hold a recurrent
        # sublayer's states, which live on the pool's device
        self.state_keys = frozenset(
            f"stage{i}/l{li}_s{si}_{kind}"
            for i, stage in enumerate(cfg.stages)
            for li, layer in enumerate(stage.period)
            for si, kind in enumerate(layer)
            if kind in RECURRENT_KINDS
        )
        self.refs = np.zeros((num_pages,), np.int64)
        self.refs[0] = 1                       # page 0 reserved (filler)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # contended acquisitions are ``kvpool.lock_wait`` spans
        self._lock = trace.TracedLock("kvpool.lock_wait")
        self.stats = PoolStats()
        # re-read every materialized dst page against its src and roll the
        # batch back on mismatch (bitrot on the copy path); costs a device
        # round-trip per batch, so off outside chaos/validation runs
        self.verify_cow = bool(verify_cow)
        self._bytes_per_page = sum(
            self.pools_k[s][t][0, 0].numel() * self.pools_k[s][t].element_size() * 2
            * self.pools_k[s][t].shape[0]
            for s, t in self.attn_tags
        )

    @property
    def lock(self) -> trace.TracedLock:
        """Pool mutation lock (reentrant).  Holders get exclusive access to
        the device pool tensors *and* the host bookkeeping: the engine holds
        it over each step's read→decode→write window, so an async-warm
        materialize never interleaves with a step's writes."""
        return self._lock

    @property
    def cow_copies(self) -> int:
        return self.stats.cow_copies

    @property
    def warm_copies(self) -> int:
        return self.stats.warm_copies

    def bytes_per_page(self) -> int:
        """Physical bytes one page occupies across every layer's K+V pools."""
        return self._bytes_per_page

    def multi_device(self) -> bool:
        """True when the pools are laid over more than one rank (ranks of a
        logical mesh may share one card)."""
        return self.sharding is not None and self.sharding.mesh.size > 1

    def grid_sharding(self) -> Optional[NamedSharding]:
        """Placement of gathered page grids ``(n_pages, periods, psz, KVH,
        Hd)``, derived from the pool sharding ``(periods, P, psz, KVH, Hd)``:
        the page axis becomes the (unsharded) leading axis and the other
        axes keep their pool placement.  None for an unsharded pool."""
        if self.sharding is None:
            return None
        s = list(self.sharding.spec) + [None] * max(0, 5 - len(self.sharding.spec))
        return NamedSharding(self.sharding.mesh, PartitionSpec(None, s[0], s[2], s[3], s[4]))

    # --------------------------------------------------------- page algebra
    def alloc(self) -> int:
        with self._lock:
            if not self._free:
                raise MemoryError("page pool exhausted")
            p = self._free.pop()
            assert self.refs[p] == 0
            self.refs[p] = 1
            return p

    def incref(self, pages: np.ndarray) -> None:
        with self._lock:
            for p in pages:
                if p:
                    self.refs[p] += 1

    def decref(self, pages: np.ndarray) -> None:
        with self._lock:
            for p in pages:
                if p:
                    self.refs[p] -= 1
                    assert self.refs[p] >= 0, f"page {p} refcount underflow"
                    if self.refs[p] == 0:
                        self._free.append(int(p))

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def used_bytes(self) -> int:
        """Physical bytes attributable to live (referenced) pages."""
        live = int(np.sum(self.refs[1:] > 0))
        return live * self._bytes_per_page

    def debug_validate(self) -> None:
        """Allocator invariants: refs never negative, the free list and the
        refcount table partition the page space exactly."""
        with self._lock:
            assert np.all(self.refs >= 0), "negative page refcount"
            free = set(self._free)
            assert len(free) == len(self._free), "duplicate page on free list"
            for p in range(1, self.num_pages):
                if self.refs[p] == 0:
                    assert p in free, f"page {p} dead but not on the free list"
                else:
                    assert p not in free, f"page {p} live but on the free list"
            assert self.refs[0] == 1 and 0 not in free, "filler page 0 corrupted"

    # ------------------------------------------------------------ CoW copy
    def copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Materialize CoW copies pool-wide (all layers) for (src, dst) pairs.

        One ``page_copy_stacked`` call per pool shape takes the K and V
        pools of every (stage, tag) of that shape: the whole batch of pairs,
        every period, in place, in one launch for up to 8 pools and 256
        pairs (a dense model's pools share one shape)."""
        if not src:
            return
        groups: Dict[Tuple[Tuple[int, ...], torch.dtype], List[torch.Tensor]] = {}
        for skey, tag in self.attn_tags:
            for pools in (self.pools_k, self.pools_v):
                t = pools[skey][tag]
                groups.setdefault((tuple(t.shape), t.dtype), []).append(t)
        for group in groups.values():
            kops.page_copy_stacked(group, src, dst)

    # ------------------------------------------- transactional CoW batching
    def materialize(self, plans: Sequence["WritePlan"], *, warm: bool = False) -> int:
        """Commit a batch of write plans atomically; returns pages copied.

        The serving loop's CoW fault handler: every plan's shared pages are
        privatized in one batched ``copy_pages`` call, then — only after the
        copies landed (and verified, when ``verify_cow``) — the page tables
        swap, the shared sources decref, and dirty tracking records the
        write windows.  Any failure (allocator, kernel, injected fault,
        verification mismatch) frees every page the batch allocated and
        leaves every session's table, refcounts, and dirty sets exactly as
        they were.  Fault seam: ``kvcache.cow_copy``.

        The whole call holds the pool lock, and plans are *revalidated*
        here: two plans for the same session (warm racing the step) both
        privatize the same table slot, and the loser discards its page
        instead of double-decreffing the source."""
        plans = [p for p in plans if p.fresh or p.cow]
        if not plans:
            return 0
        with self._lock:
            stale: List[int] = []
            live: List[Tuple[WritePlan, List[Tuple[int, int]], List[Tuple[int, int, int]]]] = []
            for p in plans:
                sess = p.session
                fresh_ok: List[Tuple[int, int]] = []
                cow_ok: List[Tuple[int, int, int]] = []
                for pos, page in p.fresh:
                    cur = int(sess.table[pos])
                    if cur != 0 and self.refs[cur] > 0:
                        stale.append(page)       # slot already privately owned
                    else:
                        fresh_ok.append((pos, page))
                for pos, s, d in p.cow:
                    if int(sess.table[pos]) != s:
                        stale.append(d)          # another plan privatized first
                    else:
                        cow_ok.append((pos, s, d))
                live.append((p, fresh_ok, cow_ok))
            src = [s for _, _, cow_ok in live for (_, s, _) in cow_ok]
            dst = [d for _, _, cow_ok in live for (_, _, d) in cow_ok]
            try:
                if src:
                    # raise-action faults fire before any device work; a
                    # corrupt-action fault models bitrot by scribbling on
                    # one destination after the copy
                    blob = faults.fire("kvcache.cow_copy", b"\x00")
                    self.copy_pages(src, dst)
                    if blob is not None and blob != b"\x00":
                        self._corrupt_page_for_test(dst[0])
                    if self.verify_cow:
                        self._verify_copies(src, dst)
            except BaseException:
                self.stats.cow_rollbacks += 1
                self.discard_plans(plans)
                raise
            # -------------------------------------------------------- commit
            for p, fresh_ok, cow_ok in live:
                sess = p.session
                for pos, page in fresh_ok:
                    sess.table[pos] = page
                for pos, _s, d in cow_ok:
                    sess.table[pos] = d
                if cow_ok:
                    self.decref(np.asarray([s for _, s, _ in cow_ok], np.int64))
                if sess._dirty_pages is not None:
                    first, last = p.window
                    sess._dirty_pages.update(range(first, last + 1))
            if stale:
                self.decref(np.asarray(stale, np.int64))
                self.stats.stale_discards += len(stale)
            n = len(src)
            self.stats.copied_pages += n
            self.stats.copied_bytes += n * self._bytes_per_page
            self.stats.fresh_allocs += sum(len(f) for _, f, _ in live)
            self.stats.materialize_calls += 1
            if warm:
                self.stats.warm_copies += n
            else:
                self.stats.cow_copies += n
        return n

    def discard_plans(self, plans: Sequence["WritePlan"]) -> None:
        """Return every page a set of uncommitted plans allocated."""
        for p in plans:
            taken = [pg for _, pg in p.fresh] + [d for _, _, d in p.cow]
            if taken:
                self.decref(np.asarray(taken, np.int64))

    def _corrupt_page_for_test(self, page: int) -> None:
        """Injected-bitrot analogue for the copy path (chaos tests only); a
        pool with no attention layer holds no page bytes to corrupt."""
        if not self.attn_tags:
            return
        skey, tag = self.attn_tags[0]
        self.pools_k[skey][tag][:, page] += 1

    def _verify_copies(self, src: List[int], dst: List[int]) -> None:
        si = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        di = torch.as_tensor(dst, dtype=torch.int64, device=self.device)
        for skey, tag in self.attn_tags:
            for pools in (self.pools_k, self.pools_v):
                pool = pools[skey][tag]
                if not torch.equal(pool[:, si], pool[:, di]):
                    raise CowCorruptionError(
                        f"CoW copy mismatch in {skey}/{tag} (pairs {src}->{dst})"
                    )

    # --------------------------------------------------- device page access
    def gather_page(self, page: int) -> Dict[str, torch.Tensor]:
        """Copy of one page across all layers (debug/test path)."""
        out = {}
        for skey, tag in self.attn_tags:
            out[f"{skey}/{tag}/k"] = self.pools_k[skey][tag][:, page].clone()
            out[f"{skey}/{tag}/v"] = self.pools_v[skey][tag][:, page].clone()
        return out

    def scatter_page(self, page: int, payload: Dict[str, Any]) -> None:
        """Write one page across all layers (debug/test path)."""
        for skey, tag in self.attn_tags:
            for pools, kv in ((self.pools_k, "k"), (self.pools_v, "v")):
                pool = pools[skey][tag]
                pool[:, page] = _as_pool_tensor(payload[f"{skey}/{tag}/{kv}"], pool)

    def gather_pages_device(self, pages: np.ndarray) -> Dict[str, torch.Tensor]:
        """One device gather per tensor: ``kv/<stage>/<tag>/{k,v}`` →
        ``(n_pages, n_periods, page_size, KVH, Hd)`` device tensors."""
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
        out: Dict[str, torch.Tensor] = {}
        for skey, tag in self.attn_tags:
            for pools, kv in ((self.pools_k, "k"), (self.pools_v, "v")):
                out[f"kv/{skey}/{tag}/{kv}"] = _gather_rows(pools[skey][tag], idx)
        return out

    def scatter_pages(self, pages: np.ndarray, payload: Dict[str, Any]) -> None:
        """Inverse of ``gather_pages_device`` (slow-path restore): the
        upload and the ``index_copy_`` are the ``kvpool.scatter`` span."""
        with self._lock, trace.span("kvpool.scatter"):
            idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
            for skey, tag in self.attn_tags:
                for pools, kv in ((self.pools_k, "k"), (self.pools_v, "v")):
                    pool = pools[skey][tag]
                    rows = _as_pool_tensor(payload[f"kv/{skey}/{tag}/{kv}"], pool)
                    pool.index_copy_(1, idx, rows.movedim(0, 1).contiguous())

    def kv_keys(self) -> List[str]:
        """The image keys of the K/V pools, ``kv/<stage>/<tag>/{k,v}``."""
        return [f"kv/{s}/{t}/{kv}" for s, t in self.attn_tags for kv in ("k", "v")]

    def page_chunk_ids(self, entries: Dict[str, Any]) -> Optional[np.ndarray]:
        """``(len(kv_keys()), n_pages)`` chunk ids of an image's K/V
        entries, where each entry holds one chunk a page in this pool's
        layout (the flat grids a session's dump writes); an image with no
        K/V (an empty session) gives ``n_pages`` 0.  None for any other
        layout: tiled, chunked otherwise, another page shape or dtype."""
        keys = self.kv_keys()
        if not any(k in entries for k in keys):
            return np.zeros((len(keys), 0), np.int64)
        ids = []
        for skey, tag in self.attn_tags:
            proto = self.pools_k[skey][tag]
            page = (proto.shape[0],) + tuple(proto.shape[2:])
            for kv in ("k", "v"):
                m = entries.get(f"kv/{skey}/{tag}/{kv}")
                if (m is None or m.tile_grid or m.trailing_pad or m.dtype != dtype_str(proto.dtype)
                        or tuple(m.shape[1:]) != page or len(m.chunk_ids) != m.shape[0]):
                    return None
                ids.append(m.chunk_ids)
        if len({len(c) for c in ids}) != 1:
            return None
        return np.asarray(ids, np.int64)

    def write_pages(self, chunks: Dict[str, np.ndarray]) -> List[int]:
        """Fresh pages holding dump chunks (a patched slow restore):
        ``chunks[key]`` holds, for each K/V key, one chunk a page, ``(n,
        page_bytes)`` uint8 on the host, and goes to the device first
        (through pinned memory on the card, not waiting for the queue).
        Under the lock, which the allocation and the writes hold as the
        ``kvpool.scatter`` span, ``n`` pages are allocated and each pool
        tensor, seen as uint8 rows ``(periods × num_pages, page_bytes ÷
        periods)`` (one a period's page), takes its chunks with one
        ``kops.delta_apply``: a chunk is ``periods`` consecutive rows at row
        ``l × num_pages + page``.  Returns the pages; a failure gives them
        back."""
        n = len(next(iter(chunks.values()))) if chunks else 0
        if not n:
            return []
        rows = {key: _upload(c, self.device) for key, c in chunks.items()}
        with self._lock, trace.span("kvpool.scatter"):
            pages: List[int] = []
            try:
                for _ in range(n):
                    pages.append(self.alloc())
                for skey, tag in self.attn_tags:
                    for pools, kv in ((self.pools_k, "k"), (self.pools_v, "v")):
                        pool = pools[skey][tag]
                        periods = pool.shape[0]
                        idx = (np.arange(periods, dtype=np.int32)[None, :] * self.num_pages
                               + np.asarray(pages, np.int32)[:, None]).reshape(-1)
                        grid = pool.view(torch.uint8).view(periods * self.num_pages, -1)
                        data = rows[f"kv/{skey}/{tag}/{kv}"].view(len(idx), -1)
                        kops.delta_apply(grid, data, _upload(idx, self.device))
            except BaseException:
                if pages:
                    self.decref(np.asarray(pages, np.int64))
                raise
        return pages


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on the card through pinned memory, so
    that the host does not wait for the work queued before the copy."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[:, idx]`` with the page axis first, as a fresh contiguous
    ``(n, periods, psz, KVH, Hd)`` tensor."""
    return pool.index_select(1, idx).movedim(1, 0).contiguous()


class _TrackedExtras(dict):
    """Session extras dict that notes which top-level keys were written.

    Every rebind path (``[]=``, ``del``, ``update``, ``pop``, ``popitem``,
    ``setdefault``, ``clear``) records the touched key into the owning
    session's ``_dirty_extras`` set, giving ``delta_generation``
    key-granular dirty hints without reading a byte.  Values are rebound,
    never mutated in place; ``setdefault`` conservatively marks its key
    dirty because the returned default may be written through."""

    def __init__(self, owner: "PagedSession", data: Optional[Dict[str, Any]] = None):
        super().__init__(data or {})
        self._owner = owner

    def _note(self, key: Any) -> None:
        dirty = self._owner._dirty_extras
        if dirty is not None:
            dirty.add(key)

    def __setitem__(self, key, value):
        self._note(key)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._note(key)
        super().__delitem__(key)

    def setdefault(self, key, default=None):
        self._note(key)
        return super().setdefault(key, default)

    def pop(self, key, *args):
        if key in self:
            self._note(key)
        return super().pop(key, *args)

    def popitem(self):
        key, val = super().popitem()
        self._note(key)
        return key, val

    def update(self, *args, **kwargs):
        incoming = dict(*args, **kwargs)
        for key in incoming:
            self._note(key)
        super().update(incoming)

    def clear(self):
        for key in list(self):
            self._note(key)
        super().clear()


def _host_extra(val: Any) -> Any:
    """An extras leaf as the dump sees it: tensors as they are, anything
    else as a numpy array."""
    return val if isinstance(val, torch.Tensor) else np.asarray(val)


def _same_entry(a: Any, b: Any) -> bool:
    """Two image entries of the same bytes: shape, dtype and chunk ids."""
    return (tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype and a.chunk_ids == b.chunk_ids
            and a.trailing_pad == b.trailing_pad and tuple(a.tile_grid) == tuple(b.tile_grid))


def _device_extra(val: Any, device: torch.device) -> torch.Tensor:
    """A restored recurrent-state leaf (a numpy array, or a CPU tensor for
    bfloat16) uploaded to ``device`` with its bits and dtype; a failed
    upload raises."""
    t = val if isinstance(val, torch.Tensor) else tensor_from_numpy(val)
    return t.to(device)


class PagedSession:
    """A forkable agent session: page table + host extras.

    Implements the DeltaCR ``ForkableState`` protocol; the "process memory"
    of one search-tree node."""

    def __init__(
        self,
        pool: PagePool,
        *,
        table: Optional[np.ndarray] = None,
        seq_len: int = 0,
        extras: Optional[Dict[str, Any]] = None,
        tokens: Optional[List[int]] = None,
    ):
        self.pool = pool
        self.table = table if table is not None else np.zeros((pool.max_pages,), np.int32)
        self.seq_len = int(seq_len)
        # top-level extras keys rebound since the lineage was last marked
        # clean; None = unknown (delta dumps treat every extra as dirty).
        # Must exist before the tracked dict below is constructed.
        self._dirty_extras: Optional[set] = None
        # extras: sampling rng, last token's logits, conversation metadata
        self.extras: Dict[str, Any] = _TrackedExtras(self, dict(extras or {}))
        self.tokens: List[int] = list(tokens or [])
        self._released = False
        # page positions written since the lineage was last marked clean;
        # None = unknown (delta dumps treat every page as dirty)
        self._dirty_pages: Optional[set] = None
        self._dirty_base: Optional[int] = None   # ckpt the set is relative to

    # ------------------------------------------------------------ utility
    @property
    def n_pages(self) -> int:
        return -(-self.seq_len // self.pool.page_size) if self.seq_len else 0

    def active_pages(self) -> np.ndarray:
        return self.table[: self.n_pages]

    # ---------------------------------------------------- dirty tracking
    def reset_dirty_tracking(self, base_ckpt=None) -> None:
        self._dirty_pages = set()
        self._dirty_extras = set()
        self._dirty_base = base_ckpt

    def invalidate_dirty_tracking(self) -> None:
        self._dirty_pages = None
        self._dirty_extras = None
        self._dirty_base = None

    def dirty_tracking_base(self):
        return self._dirty_base if self._dirty_pages is not None else None

    # ------------------------------------------------------- ForkableState
    def fork(self) -> "PagedSession":
        # under the pool lock: an async warm of this session swaps table
        # entries under it, and the refs must be taken on the pages copied
        with self.pool.lock:
            self.pool.incref(self.active_pages())
            clone = PagedSession(
                self.pool,
                table=self.table.copy(),
                seq_len=self.seq_len,
                extras=dict(self.extras),     # leaves alias (rebound, never mutated)
                tokens=list(self.tokens),
            )
        clone._dirty_pages = None if self._dirty_pages is None else set(self._dirty_pages)
        clone._dirty_extras = None if self._dirty_extras is None else set(self._dirty_extras)
        clone._dirty_base = self._dirty_base
        return clone

    def release(self) -> None:
        with self.pool.lock:
            if self._released:
                return
            self._released = True
            self.pool.decref(self.active_pages())

    def warm(self) -> None:
        """Pre-privatize the tail page off the critical path (async-warm);
        ``ensure_writable(warm=True)`` accounts ``pool.warm_copies``.  A
        session released before its warm runs is left alone: its table
        still names pages whose refs it gave back."""
        with self.pool.lock:
            if not self._released:
                self.ensure_writable(warm=True)

    def _flat_extras(self) -> Dict[str, Any]:
        """Extras as flat arrays; nested dict keys are joined with ``::``
        (extras *names* already contain ``/``)."""
        out: Dict[str, Any] = {}

        def walk(prefix: str, val: Any) -> None:
            if isinstance(val, dict):
                for k, v in val.items():
                    walk(f"{prefix}::{k}", v)
            else:
                out[prefix] = _host_extra(val)

        for name, val in self.extras.items():
            walk(name, val)
        return out

    def dump_payload(self) -> Dict[str, Any]:
        """Session state as a flat dict: metadata and extras as numpy
        arrays, KV pages as ``(n_pages, periods, psz, KVH, Hd)`` tensors on
        the pool's device, in the pool's dtype."""
        payload: Dict[str, Any] = {
            "meta/seq_len": np.asarray([self.seq_len], np.int64),
            "meta/tokens": np.asarray(self.tokens, np.int64),
        }
        if self.n_pages:
            payload.update(self.pool.gather_pages_device(self.active_pages()))
        for name, val in self._flat_extras().items():
            payload[f"extra/{name}"] = val
        return payload

    @staticmethod
    def restore_from_payload(pool: PagePool, payload: Dict[str, Any]) -> "PagedSession":
        """A new session holding ``payload``'s pages (freshly allocated),
        tokens and extras; extras come back as numpy arrays (bfloat16 as
        CPU tensors), except recurrent states (``pool.state_keys``), which
        are uploaded to the pool's device."""
        seq_len = int(payload["meta/seq_len"][0])
        tokens = [int(t) for t in payload["meta/tokens"]]
        sess = PagedSession(pool, seq_len=seq_len, tokens=tokens)
        n_pages = sess.n_pages
        if n_pages:
            for pos in range(n_pages):
                sess.table[pos] = pool.alloc()
            pool.scatter_pages(
                sess.active_pages(),
                {k: v for k, v in payload.items() if k.startswith("kv/")},
            )
        for name, arr in payload.items():
            if name.startswith("extra/"):
                path = name[len("extra/"):]
                sess._put_extra(path, sess._restored_extra(path, arr))
        return sess

    def _restored_extra(self, path: str, arr: Any) -> Any:
        """An extras leaf read from an image as the session holds it: a
        recurrent state's uploaded to the pool's device (the
        ``cr.restore.state`` span), any other as ``_host_extra`` gives it."""
        val = _host_extra(arr)
        if path.split("::", 1)[0] in self.pool.state_keys:
            with trace.span("cr.restore.state"):
                val = _device_extra(val, self.pool.device)
        return val

    def _put_extra(self, path: str, val: Any) -> None:
        """Set the extras leaf at a flat ``path`` (nested dict keys joined
        with ``::``)."""
        if "::" in path:                     # nested dict
            head, *rest = path.split("::")
            node = self.extras.setdefault(head, {})
            for part in rest[:-1]:
                node = node.setdefault(part, {})
            node[rest[-1]] = val
        else:
            self.extras[path] = val

    # ---------------------------------------------------- patched restore
    def patch_positions(self, image: Any, own_image: Any) -> Optional[np.ndarray]:
        """The page positions at which ``image`` differs from
        ``own_image``, the committed image of this session (a template):
        those where a K/V key's chunk id differs, and those where this
        session has no page.  Chunk ids are content keys, so equal ids are
        equal bytes.  None where this session cannot be patched into
        ``image``: a pool without attention or laid over several ranks, or
        K/V entries of either image laid out otherwise than one chunk a
        page (``PagePool.page_chunk_ids``)."""
        pool = self.pool
        if not pool.attn_tags or pool.multi_device():
            return None
        want = pool.page_chunk_ids(image.entries)
        have = pool.page_chunk_ids(own_image.entries)
        if want is None or have is None:
            return None
        n, m = want.shape[1], min(want.shape[1], have.shape[1])
        dirty = np.ones(n, bool)
        dirty[:m] = (want[:, :m] != have[:, :m]).any(axis=0)
        return np.flatnonzero(dirty)

    def apply_patch(self, image: Any, own_image: Any, positions: np.ndarray, store: Any) -> None:
        """Turn this session, a fresh fork of the template whose committed
        image is ``own_image``, into ``image``, at the ``positions`` that
        ``patch_positions`` gave.  Each takes a fresh page that
        ``PagePool.write_pages`` fills with the image's chunks there and
        gives its old page back, in one hold of the pool lock; positions
        past the image's length give theirs back too; every other page
        stays shared with the template.  Length and tokens come from the
        image.  An extras leaf whose entry equals ``own_image``'s stays the
        template's (leaves are rebound, never mutated); any other is read
        from ``store``.  Every read comes before a page moves, so a failed
        read or write leaves the fork as it was."""
        pool = self.pool
        entries, own = image.entries, own_image.entries
        seq_len = int(read_meta_array(store, entries["meta/seq_len"])[0])
        tokens = [int(t) for t in read_meta_array(store, entries["meta/tokens"])]
        positions = [int(p) for p in positions]
        chunks: Dict[str, np.ndarray] = {}
        if positions:
            for key in pool.kv_keys():
                ids = entries[key].chunk_ids
                raw = bytearray(store.get_bytes(tuple(ids[p] for p in positions)))
                chunks[key] = np.frombuffer(raw, np.uint8).reshape(len(positions), -1)
        mine = self._flat_extras()
        leaves: List[Tuple[str, Any, bool]] = []       # (path, leaf, read from the store)
        for name, meta in entries.items():
            if not name.startswith("extra/"):
                continue
            path, base = name[len("extra/"):], own.get(name)
            if path in mine and base is not None and _same_entry(base, meta):
                leaves.append((path, mine[path], False))
            else:
                leaves.append((path, read_meta_array(store, meta), True))
        n_new = -(-seq_len // pool.page_size)
        with pool.lock:
            fresh = pool.write_pages(chunks)
            n_old = self.n_pages
            old = [int(self.table[p]) for p in positions if p < n_old]
            old += [int(p) for p in self.table[n_new:n_old]]
            self.table[positions] = fresh
            self.table[n_new:] = 0
            self.seq_len, self.tokens = seq_len, tokens
            pool.decref(np.asarray(old, np.int64))
        self.extras = _TrackedExtras(self)
        for path, leaf, was_read in leaves:
            self._put_extra(path, self._restored_extra(path, leaf) if was_read else leaf)

    # ------------------------------------------------------ DeltaEncodable
    def delta_generation(self, chunk_bytes: int) -> DeltaGeneration:
        """Chunked views with one chunk per KV page, entirely on device.

        The dump pipeline diffs these grids against the parent generation
        with the delta kernels; pages the dirty hint clears are never
        gathered, and only compacted dirty pages cross device→host.  A grid
        is built lazily on the dump worker: ``pool[:, pages]`` with the page
        axis first, flattened to ``(n_pages, row_bytes)`` and viewed as
        uint8.  The pages it reads stay unchanged until then because the
        dump's fork holds them, and every write lands on a page whose
        refcount is 1.

        On a pool laid over several ranks the gathered page grids are
        instead placed on :meth:`PagePool.grid_sharding` and exposed as
        ``ShardedView``s under the canonical tile plan (``chunk_bytes`` sets
        the tile target), so the pipeline diffs and drains each rank's block
        on its own.  Only per-rank dirty tiles cross device→host between
        checkpoints at the same page count: the plan follows the grid's
        shape, so a checkpoint taken after the session gained a page has a
        plan other than its parent's, and every part drains whole (O(state)
        for that checkpoint)."""
        extras: Dict[str, Any] = {
            "meta/seq_len": np.asarray([self.seq_len], np.int64),
            "meta/tokens": np.asarray(self.tokens, np.int64),
        }
        for name, val in self._flat_extras().items():
            extras[f"extra/{name}"] = val
        views: Dict[str, Any] = {}
        n_pages = self.n_pages
        if n_pages:
            pages = np.asarray(self.active_pages(), np.int64).copy()
            pool = self.pool
            grid_shard = pool.grid_sharding() if pool.multi_device() else None
            for skey, tag in pool.attn_tags:
                proto = pool.pools_k[skey][tag]
                periods, _, psz, kvh, hd = proto.shape
                row_bytes = periods * psz * kvh * hd * proto.element_size()
                for kv in ("k", "v"):
                    if grid_shard is not None:
                        pools = pool.pools_k if kv == "k" else pool.pools_v
                        idx = torch.as_tensor(pages, device=pool.device)
                        grid = device_put(_gather_rows(pools[skey][tag], idx), grid_shard)
                        plan = _sd.TilePlan.for_array(
                            grid.shape, proto.dtype, max(int(chunk_bytes), 1)
                        )
                        views[f"kv/{skey}/{tag}/{kv}"] = _sd.sharded_view(grid, plan)
                        continue

                    def build(p=pool, s=skey, t=tag, which=kv, idx=pages, n=n_pages):
                        pools = p.pools_k if which == "k" else p.pools_v
                        rows = torch.as_tensor(idx, device=p.device)
                        return _gather_rows(pools[s][t], rows).reshape(n, -1).view(torch.uint8)

                    views[f"kv/{skey}/{tag}/{kv}"] = ChunkedView(
                        shape=(n_pages, periods, psz, kvh, hd),
                        dtype=dtype_str(proto.dtype),
                        nbytes=n_pages * row_bytes,
                        chunk_bytes=row_bytes,
                        n_chunks=n_pages,
                        trailing_pad=0,
                        grid_fn=build,
                    )
        states = frozenset(key for key in extras if key.startswith("extra/")
                           and key[len("extra/"):].split("::", 1)[0] in self.pool.state_keys)
        if self._dirty_pages is None or self._dirty_extras is None:
            dirty_keys = None
        else:
            # session metadata churns every step and is tiny: always dirty;
            # extras at top-level-key granularity; KV grids only if some
            # page position was written
            dirty = {"meta/seq_len", "meta/tokens"}
            for key in extras:
                if key.startswith("extra/"):
                    head = key[len("extra/"):].split("::", 1)[0]
                    if head in self._dirty_extras:
                        dirty.add(key)
            if self._dirty_pages:
                dirty.update(views)
            dirty_keys = frozenset(dirty)
        return DeltaGeneration(views=views, extras=extras, dirty_keys=dirty_keys,
                               state_keys=states)

    # --------------------------------------------------------------- write
    def plan_writable(self, *, extra_tokens: int = 1) -> WritePlan:
        """Plan (but do not apply) the page motion the next ``extra_tokens``
        appends need: fresh boundary allocations and CoW privatizations.

        Pages are allocated here (so concurrent planners never collide) but
        nothing else moves until :meth:`PagePool.materialize` commits the
        plan.  On an allocation failure mid-plan, every page this plan
        already took is returned before the error surfaces."""
        psz = self.pool.page_size
        fresh: List[Tuple[int, int]] = []
        cow: List[Tuple[int, int, int]] = []
        new_len = self.seq_len + extra_tokens
        first_page = self.seq_len // psz
        last_page = (new_len - 1) // psz
        try:
            for pos in range(first_page, last_page + 1):
                if pos >= len(self.table):
                    raise MemoryError("session exceeded max_pages")
                page = int(self.table[pos])
                needed = pos * psz < new_len
                if not needed:
                    continue
                if pos * psz >= self.seq_len and (page == 0 or self.pool.refs[page] == 0):
                    # fresh page boundary: plain allocation, no copy
                    fresh.append((pos, self.pool.alloc()))
                elif self.pool.refs[page] > 1:
                    # shared page: CoW privatize on commit
                    cow.append((pos, page, self.pool.alloc()))
        except BaseException:
            taken = [pg for _, pg in fresh] + [d for _, _, d in cow]
            if taken:
                self.pool.decref(np.asarray(taken, np.int64))
            raise
        return WritePlan(session=self, fresh=fresh, cow=cow, window=(first_page, last_page))

    def ensure_writable(self, *, warm: bool = False, extra_tokens: int = 1) -> int:
        """Guarantee the next ``extra_tokens`` appends hit exclusively-owned
        pages.  Returns the number of CoW copies performed."""
        plan = self.plan_writable(extra_tokens=extra_tokens)
        self.pool.materialize([plan], warm=warm)
        return len(plan.cow)

    def resident_bytes(self) -> int:
        """Footprint attributable to this session (shared pages amortized)."""
        psz_bytes = self.pool.bytes_per_page()
        total = 0.0
        for pos in range(self.n_pages):
            page = int(self.table[pos])
            if page:
                total += psz_bytes / max(int(self.pool.refs[page]), 1)
        return int(total)
