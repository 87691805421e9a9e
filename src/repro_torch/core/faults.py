"""Deterministic fault-injection registry — chaos testing for the real seams.

DeltaBox's transactional C/R contract ("a checkpoint always lands or fails
loudly, never half-commits") is only as strong as the failure modes it has
been exercised against.  This module gives the repo ONE seedable fault model
threaded through the *production* code paths — chunk-store puts/gets, the
streaming drain pool, the FIFO dump worker, persistence blob/manifest I/O,
template forks, trainer steps — so chaos tests inject faults into the code
that actually runs, not into mocks.

Model:

* A **fault point** is a named call site in production code that invokes
  :func:`fire` (near-zero cost while no plan is installed: one global read).
* A :class:`FaultSpec` arms one point: fire on the *Nth hit* (deterministic
  across runs — hit counting is the clock, not wall time), either once,
  ``times`` consecutive hits, or intermittently every ``period`` hits.
* A :class:`FaultSpec` has an *action*: ``"raise"`` (a :class:`FaultError`,
  or a custom exception factory), ``"corrupt"`` (flip a byte of the payload
  flowing through the seam — models bitrot on the read path), or ``"kill"``
  (a :class:`WorkerKilled` *BaseException*, which escapes per-task handlers
  and kills the supervised worker thread it fires on).
* A :class:`FaultPlan` is a set of specs plus per-point hit counters and a
  fired log.  :meth:`FaultPlan.randomized` derives a plan deterministically
  from a seed, so CI chaos runs are replayable (`seed` in the failure
  message reproduces the exact schedule).

Plans install process-globally (:func:`install` / :func:`clear` or the
:func:`inject` context manager) — the seams are spread across threads (dump
worker, drain pool, scheduler) and a thread-local plan would miss most of
them.  Chaos tests therefore must not run fault-injected cases concurrently
with each other; the suite keeps them sequential.
"""
from __future__ import annotations

import contextlib
import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "FAULT_POINTS",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "WorkerKilled",
    "active_plan",
    "clear",
    "fire",
    "inject",
    "install",
]


class FaultError(RuntimeError):
    """An injected fault (the default ``"raise"`` action)."""


class WorkerKilled(BaseException):
    """Simulated death of a supervised worker thread.

    Deliberately *not* an ``Exception``: per-task ``except Exception``
    handlers (retry loops, future resolution) must not swallow it — it has
    to escape the task and kill the worker loop so supervision (respawn +
    transactional ticket resolution) is what gets exercised."""


# The canonical seam names.  Production code may fire points outside this
# tuple; the tuple documents the supported surface and feeds randomized
# plans a default population.
FAULT_POINTS: Tuple[str, ...] = (
    "chunk_store.put",        # ChunkStore._put_locked, before any mutation
    "chunk_store.get",        # ChunkStore.get read path (supports "corrupt")
    "stream.drain",           # drain-pool window body (device fetch/hash)
    "kernels.fused",          # fused-kernel drain, post-fetch / pre-verify
    "dump.worker",            # each dump encode attempt on the FIFO worker
    "template.fork",          # DeltaCR.checkpoint/restore template fork
    "persist.blob_write",     # persist._write_atomic, before the temp write
    "persist.manifest_append",  # persist._append_manifest, before the append
    "persist.pack_write",     # persist chunk-pack writer, before the temp write
    "persist.index_write",    # persist digest-index append/rewrite
    "persist.compact",        # persist.compact_state, before any mutation
    "tier.io",                # chunk_backend tier spill/load (supports "corrupt")
    "kvcache.cow_copy",       # PagePool.materialize CoW batch (supports "corrupt")
    "trainer.step",           # Trainer.run per-step seam (fail_at shim)
)


@dataclass
class FaultSpec:
    """One armed fault: fires on the ``after``-th hit of ``point``.

    ``times`` bounds total firings (0 = unlimited); ``period`` spaces them
    (0 = consecutive hits).  One-shot is the default (``times=1``,
    ``period=0``: fires exactly on hit ``after``)."""

    point: str
    after: int = 1               # 1-based hit index of the first firing
    times: int = 1               # total firings (0 = unlimited)
    period: int = 0              # hits between firings (0 = consecutive)
    action: str = "raise"        # "raise" | "corrupt" | "kill"
    exc: Optional[Callable[[str], BaseException]] = None  # for "raise"

    def __post_init__(self) -> None:
        if self.after < 1:
            raise ValueError("FaultSpec.after is 1-based")
        if self.action not in ("raise", "corrupt", "kill"):
            raise ValueError(f"unknown fault action {self.action!r}")

    def fires_on(self, hit: int) -> bool:
        if hit < self.after:
            return False
        k = hit - self.after
        if self.period > 0:
            if k % self.period != 0:
                return False
            n = k // self.period
        else:
            n = k
        return self.times == 0 or n < self.times


def _default_mangle(payload: bytes) -> bytes:
    """Flip the low bit of the first byte (bitrot's minimal unit)."""
    if not payload:
        return payload
    return bytes([payload[0] ^ 0x01]) + bytes(payload[1:])


class FaultPlan:
    """A set of armed :class:`FaultSpec`\\ s with shared hit counters.

    Thread-safe: seams fire from the dump worker, the drain pool, and
    foreground threads concurrently.  ``log`` records every firing as
    ``(point, hit, action)`` for post-mortem assertions."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self._lock = threading.Lock()
        self.specs: List[FaultSpec] = list(specs)
        self._hits: Dict[str, int] = {}
        self.log: List[Tuple[str, int, str]] = []

    # ------------------------------------------------------------- authoring
    def add(
        self,
        point: str,
        *,
        after: int = 1,
        times: int = 1,
        period: int = 0,
        action: str = "raise",
        exc: Optional[Callable[[str], BaseException]] = None,
    ) -> "FaultPlan":
        with self._lock:
            self.specs.append(
                FaultSpec(point=point, after=after, times=times, period=period,
                          action=action, exc=exc)
            )
        return self

    @classmethod
    def randomized(
        cls,
        seed: int,
        *,
        points: Sequence[str] = (
            "chunk_store.put", "stream.drain", "dump.worker", "template.fork",
        ),
        n_faults: int = 4,
        max_hit: int = 24,
        kill_ok: bool = False,
    ) -> "FaultPlan":
        """Derive a deterministic plan from ``seed``.

        Each fault is a one-shot raise (or, with ``kill_ok``, occasionally a
        worker kill) at a uniformly random hit in ``[1, max_hit]`` of a
        uniformly random point.  Same seed → same schedule, every run."""
        rng = random.Random(seed)
        specs = []
        for _ in range(n_faults):
            point = rng.choice(list(points))
            action = "kill" if kill_ok and point == "dump.worker" and rng.random() < 0.3 else "raise"
            specs.append(
                FaultSpec(point=point, after=rng.randint(1, max_hit), action=action)
            )
        return cls(specs)

    # --------------------------------------------------------------- runtime
    def hit(self, point: str) -> Optional[FaultSpec]:
        """Advance ``point``'s hit counter; return the spec firing now."""
        with self._lock:
            n = self._hits.get(point, 0) + 1
            self._hits[point] = n
            for spec in self.specs:
                if spec.point == point and spec.fires_on(n):
                    self.log.append((point, n, spec.action))
                    return spec
        return None

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired(self, point: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for p, _, _ in self.log if point is None or p == point)


# --------------------------------------------------------------------------
# process-global installation
# --------------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None
_INSTALL_LOCK = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _ACTIVE = plan


def clear() -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


@contextlib.contextmanager
def inject(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Install ``plan`` for the duration of the block (chaos-test entry)."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def fire(
    point: str,
    payload: Optional[bytes] = None,
    *,
    mangle: Optional[Callable[[bytes], bytes]] = None,
) -> Optional[bytes]:
    """Production-seam hook: raise/corrupt/kill if an armed spec fires.

    Returns ``payload`` (possibly corrupted) so read seams can write
    ``data = faults.fire("chunk_store.get", data)``.  While no plan is
    installed this is one global read and a ``None`` check — cheap enough
    for per-chunk hot paths."""
    plan = _ACTIVE
    if plan is None:
        return payload
    spec = plan.hit(point)
    if spec is None:
        return payload
    if spec.action == "corrupt":
        if payload is None:
            return None                     # nothing flows here; no-op
        return (mangle or _default_mangle)(payload)
    if spec.action == "kill":
        raise WorkerKilled(f"injected worker death at {point}")
    if spec.exc is not None:
        raise spec.exc(point)
    raise FaultError(f"injected fault at {point} (hit {plan.hits(point)})")
