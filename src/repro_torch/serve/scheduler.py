"""Continuous-batching scheduler over forkable sessions, with dump QoS.

Ported from the JAX package's ``serve/scheduler.py``.  ``Scheduler.recover``
rebuilds the warm pool on the engine's device: the recovered image store's
generation anchors land there (``core.persist.recover``).

Production serving runs many concurrent agent sessions with different
lifecycles (prefill, decode, suspended-awaiting-tool, finished).  The
scheduler admits sessions up to a page-budget watermark, batches all
decode-ready sessions per step, and — the DeltaBox twist — *suspends*
sessions by checkpointing them through DeltaCR and releasing their pages,
resuming them later via template fork or dump restore.  Suspension turns
idle agents (seconds-long tool calls, human turns) into near-zero HBM
footprint, which is exactly the paper's economics applied to a fleet.

Forked children are first-class sessions: ``fork`` splits an active
scheduled session in place, and ``admit_forked`` adopts a session forked
*outside* the scheduler — e.g. a SandboxTree child's process state — into
the same lifecycle (continuous batching, LRU suspension through DeltaCR,
dump QoS), so a search fan-out and the serving fleet share one admission
and eviction policy.

Dump QoS (this layer owns the policy, ``core.stream`` owns the mechanism):

* The scheduler installs a :class:`~repro_torch.core.stream.DumpGate` on DeltaCR's
  streaming engine and flips ``set_runnable`` every step, so background dump
  windows are *demoted* (bounded wait) whenever decode work is ready —
  checkpoint traffic never head-of-line-blocks token generation.
* The gate also bounds in-flight dump windows, so a suspend storm (a search
  fan-out parking dozens of sessions at once) holds at most
  ``max_inflight_dump_windows`` windows of staging memory.
* **Suspend coalescing**: ``suspend`` no longer blocks on the durable dump
  before evicting the template.  Evictions are queued and drained
  opportunistically as dumps land (``step``/``submit``), or forcibly only
  when admission actually needs the pages back — a storm of suspends costs
  one FIFO dump queue, not a chain of synchronous waits.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Dict, List, Optional, Tuple

from ..core.deltacr import DeltaCR
from ..core.persist import PersistencePlane
from ..core.persist import recover as recover_state
from ..core.policy import DumpPolicy
from ..core.stream import DumpGate

from .engine import Engine, SamplingParams
from .kvcache import PagedSession

__all__ = ["Scheduler", "SchedulerConfig", "SessionHandle"]


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8                   # decode batch per step
    min_free_pages: int = 8              # admission watermark
    auto_suspend_free_pages: int = 4     # suspend LRU sessions below this
    # Batching window: >0 makes ``generate`` wait up to this long before
    # each step for sibling requests to coalesce (early-exit once
    # ``max_batch`` sessions want tokens).  Worth ~a batch-width of decode
    # throughput when concurrent callers arrive staggered (forked MCTS
    # leaves); 0 keeps the latency-first default.
    batch_window_ms: float = 0.0
    # -- dump QoS --------------------------------------------------------
    dump_qos: bool = True                # install a DumpGate on DeltaCR
    max_inflight_dump_windows: int = 3   # staging bound for dump streams
    dump_demote_poll_ms: float = 2.0     # demoted-window re-check cadence
    dump_demote_max_ms: float = 50.0     # demotion is bounded: dumps progress
    coalesce_suspends: bool = True       # defer template eviction off suspend()
    # -- dump timeout policy ---------------------------------------------
    # How long a synchronous (urgent/uncoalesced) suspend waits for the
    # durable dump, and what a timeout does:
    #   "defer" — count it and queue a deferred eviction; the template stays
    #             live and the pages return when the dump finally lands
    #             (never silently evict a template whose dump didn't land)
    #   "raise" — count it and re-raise to the caller (strict deployments)
    dump_timeout_s: float = 120.0
    dump_timeout_policy: str = "defer"   # "defer" | "raise"
    # -- dump policy -----------------------------------------------------
    # When set, the scheduler re-points its DeltaCR at this DumpPolicy on
    # construction (Scheduler owns the dump QoS surface; the selection /
    # retry / deadline / fused knobs ride along the same way).  None keeps
    # whatever policy the DeltaCR was built with.
    dump_policy: Optional[DumpPolicy] = None
    # -- persistence plane -----------------------------------------------
    # When set, the scheduler commits a crash-consistent manifest snapshot
    # (suspended-session map + DeltaCR image store) every time a coalesced
    # suspend drain lands dumps — a warm pool of parked agents survives
    # process death and is re-admitted via Scheduler.recover().
    persist_path: Optional[str] = None
    keep_snapshots: int = 4
    # Full-snapshot anchor cadence: saves in between are O(delta) docs
    # folded onto the last anchor at recovery (1 = every save is full).
    persist_full_every: int = 8
    # When > 0, compact the manifest (fresh full snapshot + history
    # truncation + pack sweep) every this many saves.
    persist_compact_every: int = 0


@dataclasses.dataclass
class SessionHandle:
    sid: int
    state: str                           # "active" | "suspended" | "finished"
    session: Optional[PagedSession]
    ckpt_id: Optional[int] = None        # set while suspended
    last_step: int = 0
    # -- decode-service request state (continuous batching) ---------------
    want: int = 0                        # outstanding requested decode tokens
    got: List[int] = dataclasses.field(default_factory=list)
    waiter: Optional[Future] = None      # resolves with ``got`` when want==0


class Scheduler:
    def __init__(self, engine: Engine, deltacr: DeltaCR, cfg: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.cr = deltacr
        # per-instance config: a shared default instance would alias mutable
        # scheduler tuning across every Scheduler in the process
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.handles: Dict[int, SessionHandle] = {}
        self._sid = itertools.count(1)
        self._ckpt = itertools.count(1_000_000)
        # Handle-table + pool-mutation lock: forked MCTS workers call
        # admit_forked/generate/detach from their own threads while a step
        # decodes, and slow restores scatter into the same pool arrays the
        # step functionally updates — every public mutator serializes here.
        self._lock = threading.RLock()
        # Decode service: at most one thread runs engine.step at a time;
        # whichever generate() caller grabs this lock services every
        # waiting request (continuous batching by thread-stealing)
        self._step_lock = threading.Lock()
        if self.cfg.dump_timeout_policy not in ("defer", "raise"):
            raise ValueError(
                f"unknown dump_timeout_policy {self.cfg.dump_timeout_policy!r}"
            )
        if self.cfg.dump_policy is not None:
            self.cr.apply_policy(self.cfg.dump_policy)
        self.step_count = 0
        self.suspensions = 0
        self.resumes = 0
        # fault-domain accounting (every timeout/failure is counted, never
        # swallowed silently)
        self.dump_timeouts = 0           # dumps that missed dump_timeout_s
        self.dump_failures = 0           # dumps that failed (template kept)
        # (ckpt_id, dump future) pairs awaiting deferred template eviction
        self._pending_evict: List[Tuple[int, Optional[Future]]] = []
        self.gate: Optional[DumpGate] = None
        if self.cfg.dump_qos:
            self.gate = DumpGate(
                self.cfg.max_inflight_dump_windows,
                demote_poll_ms=self.cfg.dump_demote_poll_ms,
                demote_max_ms=self.cfg.dump_demote_max_ms,
            )
            self.cr.attach_dump_gate(self.gate)
        self.plane: Optional[PersistencePlane] = None
        if self.cfg.persist_path is not None:
            self.plane = PersistencePlane(
                self.cfg.persist_path,
                keep_snapshots=self.cfg.keep_snapshots,
                full_every=self.cfg.persist_full_every,
                compact_every=self.cfg.persist_compact_every,
            )

    # --------------------------------------------------------------- admit
    def submit(self, prompt, sampling: Optional[SamplingParams] = None) -> int:
        """Admit a new session (prefill) if the pool allows; else raise."""
        with self._lock:
            self._drain_suspends()
            self._ensure_headroom()
            if self.engine.pool.free_pages() < self.cfg.min_free_pages:
                raise MemoryError("no page headroom for admission")
            sess = self.engine.new_session(
                list(prompt), sampling if sampling is not None else SamplingParams()
            )
            sid = next(self._sid)
            self.handles[sid] = SessionHandle(sid=sid, state="active", session=sess)
            return sid

    def fork(self, sid: int) -> int:
        """Fork an active session into a new scheduled session (BoN/search)."""
        with self._lock:
            h = self.handles[sid]
            assert h.state == "active" and h.session is not None
            child = h.session.fork()
            nsid = next(self._sid)
            self.handles[nsid] = SessionHandle(sid=nsid, state="active", session=child)
            self._refresh_runnable_hint()
            return nsid

    def admit_forked(self, session) -> int:
        """Admit an externally forked live session as a scheduled session.

        The SandboxTree integration point: a child forked from a checkpoint
        (its process state is a ``PagedSession``/``ForkableState`` the
        caller owns) joins continuous batching, LRU suspension, and dump
        QoS exactly like a session this scheduler prefilled itself.  The
        scheduler takes ownership: ``finish``/``suspend`` release it.
        Raises ``MemoryError`` when the pool lacks admission headroom (the
        fork itself allocated nothing, but decoding it will)."""
        with self._lock:
            self._drain_suspends()
            self._ensure_headroom()
            if self.engine.pool.free_pages() < self.cfg.min_free_pages:
                raise MemoryError("no page headroom to admit forked session")
            sid = next(self._sid)
            self.handles[sid] = SessionHandle(sid=sid, state="active", session=session)
            self._refresh_runnable_hint()
            return sid

    def session(self, sid: int) -> PagedSession:
        """The live session behind a handle (resuming it if parked).

        Suspension/resume changes the session's object identity (checkpoint
        + release, then template fork); callers holding a direct reference
        — a SandboxTree child's ``proc`` — rebind through here."""
        with self._lock:
            h = self.handles[sid]
            if h.state == "suspended":
                self.resume(sid)
            if h.state != "active" or h.session is None:
                raise KeyError(f"session {sid} is not live ({h.state})")
            return h.session

    def detach(self, sid: int) -> PagedSession:
        """Remove a handle and hand its live session back to the caller.

        The inverse of ``admit_forked``: ownership returns to the caller
        (a SandboxTree child's teardown releases the proc itself), so the
        scheduler must NOT release it here.  A handle the scheduler
        auto-suspended in the meantime is resumed first — the caller always
        gets a live session back (its identity may differ from the one
        admitted: suspension is checkpoint + release, resume is a fork)."""
        with self._lock:
            h = self.handles[sid]
            if h.state == "suspended":
                self.resume(sid)
            if h.state != "active" or h.session is None:
                raise KeyError(f"session {sid} is not detachable ({h.state})")
            if h.waiter is not None:
                raise RuntimeError(f"session {sid} detached with a request in flight")
            sess = h.session
            h.session = None
            h.state = "finished"
            del self.handles[sid]
            self._refresh_runnable_hint()
            return sess

    # --------------------------------------------------------------- states
    def suspend(self, sid: int, *, keep_template: bool = False, urgent: bool = False) -> None:
        """Checkpoint through DeltaCR and release the session's pages.

        With ``keep_template=False`` (default) the template is evicted once
        the durable dump lands, so the pages really return to the pool —
        resume then takes the slow path: suspension trades restore latency
        for HBM, exactly the paper's eviction economics.

        Coalescing (default): the eviction is *deferred* — queued behind the
        dump future and drained when the dump completes, so a burst of
        suspends (search fan-out, tool-call storm) submits every dump to the
        FIFO worker immediately instead of serializing suspend→wait→suspend.
        ``urgent=True`` restores the old synchronous behavior (pages are
        free when this returns) and marks the dump foreground-priority so
        the QoS gate does not demote its windows.
        """
        with self._lock:
            self._suspend_locked(sid, keep_template=keep_template, urgent=urgent)

    def _suspend_locked(self, sid: int, *, keep_template: bool, urgent: bool) -> None:
        h = self.handles[sid]
        if h.state != "active":
            return
        if h.waiter is not None:
            # a decode request is in flight on another thread: fail it
            # loudly rather than silently parking a session mid-request
            w, h.waiter = h.waiter, None
            h.want = 0
            w.set_exception(RuntimeError(f"session {sid} suspended mid-request"))
        ckpt_id = next(self._ckpt)
        self.cr.checkpoint(h.session, ckpt_id, None, priority="fg" if urgent else "bg")
        # the handle flips to suspended BEFORE any durability wait: the
        # template is live from here on, so even a failed/slow dump leaves a
        # restorable handle — never an "active" one holding a released session
        h.session.release()
        h.session = None
        h.ckpt_id = ckpt_id
        h.state = "suspended"
        self.suspensions += 1
        self._refresh_runnable_hint()
        if not keep_template:
            fut = self.cr.dump_future(ckpt_id)
            if urgent or not self.cfg.coalesce_suspends:
                if fut is not None:
                    try:
                        # durable image before eviction
                        fut.result(timeout=self.cfg.dump_timeout_s)
                    except FuturesTimeoutError:
                        # slow, not failed — routed through the timeout
                        # policy, counted, and the template is NEVER evicted
                        # before its dump lands
                        self.dump_timeouts += 1
                        self._pending_evict.append((ckpt_id, fut))
                        if self.cfg.dump_timeout_policy == "raise":
                            raise
                        return
                    except Exception:
                        # dump failed loudly (ticket aborted): the template
                        # is the only remaining copy of the state — keep it
                        self.dump_failures += 1
                        return
                self.cr.evict_template(ckpt_id)
                self.cr.release_dump_anchor(ckpt_id)  # really return the pages
            else:
                self._pending_evict.append((ckpt_id, fut))

    def suspend_many(self, sids, **kw) -> None:
        """Suspend a burst of sessions; with coalescing on, all dumps queue
        on the FIFO worker before any eviction wait happens."""
        for sid in sids:
            self.suspend(sid, **kw)

    def resume(self, sid: int) -> None:
        with self._lock:
            h = self.handles[sid]
            if h.state != "suspended":
                return
            self._drain_suspends()
            self._ensure_headroom()
            state, path = self.cr.restore(h.ckpt_id)
            h.session = state
            h.state = "active"
            h.ckpt_id = None
            self.resumes += 1
            self._refresh_runnable_hint()

    def finish(self, sid: int) -> List[int]:
        with self._lock:
            h = self.handles[sid]
            tokens = list(h.session.tokens) if h.session else []
            if h.session is not None:
                h.session.release()
                h.session = None
            if h.ckpt_id is not None:
                self._pending_evict = [
                    (c, f) for c, f in self._pending_evict if c != h.ckpt_id
                ]
                self.cr.drop_checkpoint(h.ckpt_id)
                h.ckpt_id = None
            h.state = "finished"
            self._refresh_runnable_hint()
            return tokens

    # ----------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One continuous-batching step over decode-ready sessions.

        When decode *requests* are outstanding (``request_tokens``/
        ``generate``), the batch is exactly the requesting sessions — an
        admitted session nobody asked to decode is never stepped out from
        under its owner.  With no requests pending, every active session is
        batched (the fleet-serving default).  Returns {sid: sampled token}.
        """
        with self._lock:
            self._drain_suspends()
            actives = [h for h in self.handles.values() if h.state == "active"]
            wanting = [h for h in actives if h.want > 0]
            ready = (wanting if wanting else actives)[: self.cfg.max_batch]
            if self.gate is not None:
                # QoS hint: while these sessions decode, background dump
                # windows are demoted; cleared when the scheduler runs dry
                self.gate.set_runnable(len(ready))
            if not ready:
                return {}
            try:
                toks = self.engine.step([h.session for h in ready])
            except BaseException as exc:
                # a failed batched step (CoW fault, allocator) aborts every
                # waiting request loudly — refs were already rolled back
                for h in ready:
                    if h.waiter is not None:
                        w, h.waiter = h.waiter, None
                        h.want = 0
                        w.set_exception(
                            exc if isinstance(exc, Exception) else RuntimeError(repr(exc))
                        )
                raise
            out = {}
            for h, t in zip(ready, toks):
                h.last_step = self.step_count
                out[h.sid] = t
                if h.want > 0:
                    h.want -= 1
                    h.got.append(int(t))
                    if h.want == 0 and h.waiter is not None:
                        w, h.waiter = h.waiter, None
                        w.set_result(list(h.got))
            self.step_count += 1
            return out

    # -------------------------------------------------------- decode service
    def request_tokens(self, sid: int, n: int) -> Future:
        """Ask the decode service for ``n`` more tokens from session ``sid``.

        Returns a future resolving to the list of sampled tokens once ``n``
        continuous-batching steps have included the session.  A suspended
        handle is resumed first.  The request is *served* by whoever drives
        ``step()`` — the background fleet loop, or any thread inside
        ``generate`` (work-stealing: one blocked caller steps the shared
        batch for everyone)."""
        with self._lock:
            h = self.handles[sid]
            if h.state == "suspended":
                self.resume(sid)
            if h.state != "active":
                raise KeyError(f"session {sid} is not decodable ({h.state})")
            if h.waiter is not None:
                raise RuntimeError(f"session {sid} already has a request in flight")
            fut: Future = Future()
            h.got = []
            if n <= 0:
                fut.set_result([])
                return fut
            h.want = int(n)
            h.waiter = fut
            return fut

    def generate(self, sid: int, n: int, *, timeout_s: float = 300.0) -> List[int]:
        """Decode ``n`` tokens through the shared continuous-batching loop.

        Safe to call from many threads at once (the parallel-MCTS workers
        do): each caller's request joins the same batch, and exactly one
        caller at a time drives ``step()`` while the rest wait on their
        futures — forked siblings admitted through ``admit_forked`` decode
        together, one stacked kernel launch per step for the whole set."""
        fut = self.request_tokens(sid, n)
        deadline = time.monotonic() + timeout_s
        while not fut.done():
            if self._step_lock.acquire(timeout=0.002):
                try:
                    # Serve until the shared batch runs dry, not merely until
                    # our own request resolves: releasing the lock the moment
                    # our future lands would strand every sibling request in
                    # its wait-timeout (tens of ms each).  The holder drains
                    # all pending wants so siblings' futures resolve the
                    # instant their last token is sampled.
                    while self._pending_wants():
                        self._coalesce_window()
                        self.step()
                finally:
                    self._step_lock.release()
            else:
                # another caller is stepping the shared batch
                try:
                    return list(fut.result(timeout=0.02))
                except FuturesTimeoutError:
                    pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"generate({sid}, {n}) missed {timeout_s}s deadline")
        return list(fut.result())

    def _coalesce_window(self) -> None:
        """Give concurrently-arriving requests ``batch_window_ms`` to join
        the next step's batch (no-op when the window is 0).  Exits early the
        moment ``max_batch`` sessions want tokens — a full batch gains
        nothing by waiting."""
        w_s = self.cfg.batch_window_ms / 1e3
        if w_s <= 0:
            return
        deadline = time.monotonic() + w_s
        while time.monotonic() < deadline:
            with self._lock:
                wanting = sum(
                    1
                    for h in self.handles.values()
                    if h.state == "active" and h.want > 0
                )
            if wanting >= self.cfg.max_batch:
                return
            time.sleep(w_s / 8)

    def _pending_wants(self) -> bool:
        with self._lock:
            return any(
                h.want > 0 for h in self.handles.values() if h.state == "active"
            )

    # ---------------------------------------------------------------- health
    def health(self) -> Dict[str, object]:
        """One fault-domain snapshot across the stack this scheduler drives:
        DeltaCR's retry/fallback/degraded counters and verified-read repair
        stats, dump-worker supervision, drain-pool restarts, the QoS gate,
        and this scheduler's own timeout/failure counts.  Cheap to poll —
        no locks beyond the stats locks."""
        h: Dict[str, object] = dict(self.cr.health())
        h["scheduler_dump_timeouts"] = self.dump_timeouts
        h["scheduler_dump_failures"] = self.dump_failures
        h["pending_evictions"] = len(self._pending_evict)
        h["suspensions"] = self.suspensions
        h["resumes"] = self.resumes
        h["sessions_active"] = sum(
            1 for x in self.handles.values() if x.state == "active"
        )
        h["sessions_suspended"] = sum(
            1 for x in self.handles.values() if x.state == "suspended"
        )
        if self.gate is not None:
            h["gate_acquires"] = self.gate.stats.acquires
            h["gate_demotions"] = self.gate.stats.demotions
        if self.plane is not None:
            h["persist_saves"] = self.plane.saves
            h["persist_compactions"] = self.plane.compactions
            if self.plane.last_save_stats:
                h["persist_last_kind"] = self.plane.last_save_stats.get("kind")
                h["persist_last_bytes"] = self.plane.last_save_stats.get("bytes_written")
        # a single boolean for monitors: anything degraded/broken right now?
        h["ok"] = (
            not h.get("degraded", False)
            and int(h.get("quarantined_chunks", 0)) == 0
            and self.dump_failures == 0
            and int(h.get("dump_failures", 0)) == 0
        )
        return h

    # ------------------------------------------------------------- internal
    def _refresh_runnable_hint(self) -> None:
        """Keep the QoS gate's runnable count honest on state transitions.

        step() sets the authoritative per-batch count; this catches the
        in-between case — a suspend storm parking every active session must
        *promote* the queued dumps immediately, not leave them demoted
        against decode work that no longer exists."""
        if self.gate is not None:
            n = sum(1 for h in self.handles.values() if h.state == "active")
            self.gate.set_runnable(min(n, self.cfg.max_batch))

    def _drain_suspends(self, *, block: bool = False) -> int:
        """Evict templates whose dumps have landed (deferred suspensions).

        ``block=True`` additionally waits on the *oldest* pending dump — the
        bounded backpressure admission applies when it really needs pages.
        Returns the number of templates evicted."""
        if not self._pending_evict:
            return 0
        evicted = 0
        remaining: List[Tuple[int, Optional[Future]]] = []
        for i, (ckpt_id, fut) in enumerate(self._pending_evict):
            wait = block and i == 0
            if fut is None or fut.done() or wait:
                if fut is not None:
                    try:
                        fut.result(timeout=self.cfg.dump_timeout_s)
                    except FuturesTimeoutError:
                        # slow, not failed: counted, and the entry is kept so
                        # the eviction (and its pages) still happens when the
                        # dump lands — the template outlives its dump, always
                        self.dump_timeouts += 1
                        remaining.append((ckpt_id, fut))
                        if self.cfg.dump_timeout_policy == "raise":
                            self._pending_evict = remaining + self._pending_evict[i + 1 :]
                            raise
                        continue
                    except Exception:
                        # dump failed loudly: counted; keep the template (the
                        # only remaining copy of the state) — pages stay
                        # held, state stays safe
                        self.dump_failures += 1
                        continue
                self.cr.evict_template(ckpt_id)
                self.cr.release_dump_anchor(ckpt_id)   # really return the pages
                evicted += 1
            else:
                remaining.append((ckpt_id, fut))
        self._pending_evict = remaining
        if evicted and self.plane is not None:
            # the just-landed dumps are durable in the image store; commit
            # the manifest so this warm pool survives process death
            self.persist_now()
        return evicted

    # ---------------------------------------------------------- persistence
    def persist_now(self) -> Optional[int]:
        """Commit a manifest snapshot of the suspended warm pool (sessions
        whose dumps have landed + the DeltaCR image store); returns the
        snapshot seq, or None when no plane is configured."""
        if self.plane is None:
            return None
        with self._lock:
            sessions = sorted(
                (h.sid, h.ckpt_id)
                for h in self.handles.values()
                if h.state == "suspended"
                and h.ckpt_id is not None
                and self.cr.images.image_for(h.ckpt_id) is not None
            )
        return self.plane.save(
            deltacr=self.cr,
            extra={"sessions": [list(s) for s in sessions]},
        )

    @classmethod
    def recover(
        cls,
        engine: Engine,
        path: str,
        cfg: Optional[SchedulerConfig] = None,
        *,
        restore_fn,
    ) -> "Scheduler":
        """Rebuild a scheduler warm pool after process death.

        Recovers the persisted DeltaCR image store onto the engine's device
        and re-admits every persisted suspended session as a ``suspended``
        handle; ``resume`` then slow-restores it from its durable image
        exactly as if this process had suspended it.  ``restore_fn``
        rebuilds a session from an image payload (e.g.
        ``PagedSession.restore_from_payload``)."""
        rec = recover_state(path, restore_fn=restore_fn, device=engine.device)
        cfg = cfg if cfg is not None else SchedulerConfig()
        if cfg.persist_path is None:
            cfg = dataclasses.replace(cfg, persist_path=path)
        sched = cls(engine, rec.deltacr, cfg)
        max_sid, max_ckpt = 0, 1_000_000 - 1
        for sid, ckpt_id in rec.extra.get("sessions", []):
            sid, ckpt_id = int(sid), int(ckpt_id)
            sched.handles[sid] = SessionHandle(
                sid=sid, state="suspended", session=None, ckpt_id=ckpt_id
            )
            max_sid = max(max_sid, sid)
            max_ckpt = max(max_ckpt, ckpt_id)
        sched._sid = itertools.count(max_sid + 1)
        sched._ckpt = itertools.count(max_ckpt + 1)
        return sched

    def _ensure_headroom(self) -> None:
        """Below the watermark: first reap deferred evictions, then suspend
        LRU active sessions, and only block on a pending dump when nothing
        else can yield pages."""
        while self.engine.pool.free_pages() < self.cfg.auto_suspend_free_pages:
            if self._drain_suspends():
                continue
            if self._pending_evict and self._drain_suspends(block=True):
                continue                 # a queued dump landed: pages are back
            actives = [h for h in self.handles.values() if h.state == "active"]
            if len(actives) <= 1:
                break
            # prefer parking sessions nobody is mid-request on
            idle = [h for h in actives if h.want == 0 and h.waiter is None] or actives
            lru = min(idle, key=lambda h: h.last_step)
            self.suspend(lru.sid)
