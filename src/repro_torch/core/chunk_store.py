"""Refcounted, content-dedupable chunk store — the XFS-reflink analogue.

DeltaFS layers and DeltaCR dump images never hold tensor bytes directly;
they hold *references* to immutable chunks in this store.  A chunk that is
unmodified across N checkpoints is stored exactly once and shared by all N
generations ("reflink composes transitively", paper §4.1).  Releasing the
last reference frees the physical bytes.

Two sharing mechanisms:

* **Structural sharing** (always on): when DeltaFS copies a tensor up into a
  new layer it re-references the parent's chunk ids for every chunk the write
  did not touch — the analogue of ``vfs_clone_file_range`` preserving the
  extent map.
* **Content dedupe** (optional, beyond-paper): chunks are keyed by a
  blake2b digest so *identical* payloads written independently collapse to
  one physical chunk (e.g. ``__pycache__`` regenerated after a rollback).

Chunking convention: every stored tensor chunk is exactly ``chunk_bytes``
long — partial tails are zero-padded and the real trailing pad is recorded
per chunk, so digests are layout-stable across the host dump path and the
device (CUDA) delta pipeline, and the two dedupe against each other.  The
dedupe key is ``(digest, pad)``: identical padded bytes with different
logical lengths never collapse.

Producers that already hold a chunk's digest (the delta pipeline hashes each
dirty chunk exactly once) store through :meth:`put_digested`, which skips
re-hashing.

**Verified reads** (``verify_reads=True``, off by default): :meth:`get`
re-hashes the chunk against its stored digest.  On a mismatch the store
walks its *repair sources* (the persistence plane's durable blobs, DeltaCR's
anchored generation grids — see :meth:`attach_repair_source`); a source that
produces digest-matching bytes heals the chunk in place, otherwise the chunk
is **quarantined** (future reads fail loudly with the chunk id, the dedupe
key is retired so the bad bytes are never handed out again) and
:class:`ChunkCorruptionError` is raised.  Outcomes are surfaced in
:class:`RepairStats`.  Verification is off by default so the fault-free dump
hot path pays nothing.

The store is process-local and thread-safe; it is the "base storage"
(Layer 1) of the paper's architecture.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from . import faults
from .chunk_backend import tier_key

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .chunk_backend import TierManager

__all__ = [
    "ChunkCorruptionError",
    "ChunkStore",
    "ChunkStoreStats",
    "RepairStats",
    "chunk_digest",
    "iter_chunk_views",
]

DIGEST_BYTES = 16

_Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


def chunk_digest(piece: _Buffer, pad: int = 0) -> bytes:
    """blake2b-16 over ``piece`` plus ``pad`` trailing zero bytes.

    Accepts any contiguous buffer (no copy); the digest matches the bytes a
    padded chunk stores, so host memoryview chunking and device-compacted
    rows hash identically.
    """
    h = hashlib.blake2b(digest_size=DIGEST_BYTES)
    h.update(piece)
    if pad:
        h.update(bytes(pad))
    return h.digest()


def iter_chunk_views(raw: _Buffer, chunk_bytes: int) -> Iterator[Tuple[memoryview, int]]:
    """Yield zero-copy ``(piece, pad)`` views over ``raw``.

    Every chunk but the last is exactly ``chunk_bytes``; the last yields its
    short view plus the trailing pad that completes it.  Empty input yields
    one empty piece (a zero-length tensor still owns one chunk).
    """
    view = memoryview(raw).cast("B") if not isinstance(raw, memoryview) else raw.cast("B")
    n = len(view)
    if n == 0:
        yield view[:0], 0
        return
    for off in range(0, n, chunk_bytes):
        piece = view[off : off + chunk_bytes]
        yield piece, chunk_bytes - len(piece) if len(piece) < chunk_bytes else 0


@dataclass
class ChunkStoreStats:
    """Physical vs logical accounting, used by the write-amplification bench."""

    physical_bytes: int = 0          # bytes actually resident
    logical_bytes: int = 0           # bytes across all live references
    chunks_alive: int = 0
    puts: int = 0                    # put() calls
    dedup_hits: int = 0              # puts resolved by content dedupe
    bytes_written: int = 0           # physical bytes written by puts (copy-up volume)
    peak_physical_bytes: int = 0

    def snapshot(self) -> "ChunkStoreStats":
        return ChunkStoreStats(**vars(self))


class ChunkCorruptionError(RuntimeError):
    """A chunk's bytes no longer match its digest and no repair source could
    heal it; the chunk is quarantined.  Carries the chunk id so callers can
    report exactly what was lost."""

    def __init__(self, cid: int, message: str):
        super().__init__(message)
        self.cid = cid


@dataclass
class RepairStats:
    """Verified-read outcomes (the self-healing read path, observable)."""

    verified_gets: int = 0       # reads that re-hashed against the digest
    mismatches: int = 0          # digest mismatches detected
    repaired: int = 0            # chunks healed in place by a repair source
    quarantined: int = 0         # chunks quarantined (unrepairable)

    def snapshot(self) -> "RepairStats":
        return RepairStats(**vars(self))


# A repair source resolves (cid, digest, pad) -> candidate bytes or None.
# Sources must not call back into the store (they run outside its lock but a
# re-entrant get() on the corrupt cid would recurse through verification).
RepairSource = Callable[[int, bytes, int], Optional[bytes]]


@dataclass
class _Chunk:
    # ``data is None`` means the payload is demoted: resident on ``tier``
    # (warm/cold) under its content address, faulted back on the next get.
    data: Optional[bytes]
    refs: int = 1
    digest: Optional[bytes] = None
    pad: int = 0  # trailing zero-pad bytes (last chunk of a tensor)
    quarantined: bool = False
    size: int = 0                # payload length (stable across demotion)
    tier: str = "hot"            # "hot" | "warm" | "cold"
    last_use: int = 0            # recency tick (LRU demotion signal)


class ChunkStore:
    """Immutable chunk storage with explicit reference counting.

    Chunk ids are opaque monotonically increasing ints.  All methods are
    thread-safe (DeltaCR's dump worker and the foreground DeltaFS path share
    one store).
    """

    def __init__(
        self,
        *,
        chunk_bytes: int = 64 * 1024,
        dedupe: bool = True,
        verify_reads: bool = False,
        tiers: Optional["TierManager"] = None,
    ):
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.chunk_bytes = int(chunk_bytes)
        self.dedupe = bool(dedupe)
        self.verify_reads = bool(verify_reads)
        self._lock = threading.RLock()
        self._chunks: Dict[int, _Chunk] = {}
        self._by_digest: Dict[Tuple[bytes, int], int] = {}
        self._next_id = 1
        self._repair_sources: List[RepairSource] = []
        self.stats = ChunkStoreStats()
        self.repair_stats = RepairStats()
        # -- tiering ------------------------------------------------------
        # Only digest-carrying chunks are demotable: the content address is
        # the tier key AND the promotion verifier (a corrupt warm/cold blob
        # is caught before its bytes are trusted).
        self._tiers = tiers
        self._hot_bytes = 0
        self._tick = 0

    # ------------------------------------------------------------------ put
    def put(self, data: bytes, *, pad: int = 0) -> int:
        """Store one chunk, returning its id with one reference held."""
        digest = None
        if self.dedupe:
            digest = hashlib.blake2b(data, digest_size=DIGEST_BYTES).digest()
        return self._put_locked(data, digest, pad)

    def put_digested(
        self,
        data: Union[bytes, Callable[[], bytes]],
        *,
        digest: bytes,
        pad: int = 0,
    ) -> int:
        """Store a chunk whose digest the caller already computed.

        The delta-dump hot path hashes each dirty chunk exactly once; this
        entry point reuses that digest for dedupe instead of re-hashing.
        ``data`` may be a thunk so a dedupe hit never materializes bytes.
        """
        return self._put_locked(data, digest, pad)

    def _dedup_hit_locked(self, digest: Optional[bytes], pad: int) -> Optional[int]:
        """Resolve a put against an existing chunk; caller holds the lock."""
        if digest is None or not self.dedupe:
            return None
        hit = self._by_digest.get((digest, pad))
        if hit is None:
            return None
        chunk = self._chunks[hit]
        chunk.refs += 1
        self._tick += 1
        chunk.last_use = self._tick
        self.stats.dedup_hits += 1
        self.stats.logical_bytes += chunk.size
        return hit

    def _put_locked(self, data, digest: Optional[bytes], pad: int) -> int:
        # fault seam BEFORE any mutation: an injected put failure is
        # transactional by construction (no partial store state to undo)
        faults.fire("chunk_store.put")
        with self._lock:
            self.stats.puts += 1
            hit = self._dedup_hit_locked(digest, pad)
            if hit is not None:
                return hit
        # Materialize OUTSIDE the lock: the thunk/copy is a memcpy-scale
        # operation and holding the lock across it convoys the parallel
        # drain workers of the streaming dump engine.
        if callable(data):
            data = data()
        data = bytes(data)
        with self._lock:
            hit = self._dedup_hit_locked(digest, pad)   # lost a race: reuse
            if hit is not None:
                return hit
            cid = self._next_id
            self._next_id += 1
            self._tick += 1
            self._chunks[cid] = _Chunk(
                data=data, digest=digest, pad=pad, size=len(data), last_use=self._tick
            )
            if digest is not None and self.dedupe:
                self._by_digest[(digest, pad)] = cid
            self.stats.chunks_alive += 1
            self.stats.physical_bytes += len(data)
            self.stats.logical_bytes += len(data)
            self.stats.bytes_written += len(data)
            self.stats.peak_physical_bytes = max(
                self.stats.peak_physical_bytes, self.stats.physical_bytes
            )
            self._hot_bytes += len(data)
            if self._tiers is not None and self._hot_bytes > self._tiers.hot_capacity_bytes:
                self._demote_over_capacity_locked()
            return cid

    # ------------------------------------------------------------------ get
    def get(self, cid: int) -> bytes:
        with self._lock:
            chunk = self._chunks[cid]
            if chunk.quarantined:
                raise ChunkCorruptionError(
                    cid, f"chunk {cid} is quarantined (digest mismatch, unrepaired)"
                )
            self._tick += 1
            chunk.last_use = self._tick
            data, digest, pad, tier = chunk.data, chunk.digest, chunk.pad, chunk.tier
        if data is None:
            # demoted payload: fault it back from its tier.  Promotion always
            # digest-verifies (a corrupt cold object must never be trusted),
            # falling through to the repair sources on a mismatch.
            assert digest is not None
            data = self._promote(cid, digest, pad, tier)
        # read seam: a "corrupt" spec models bitrot/transient read errors
        data = faults.fire("chunk_store.get", data)
        if not self.verify_reads or digest is None:
            return data
        self.repair_stats.verified_gets += 1
        if hashlib.blake2b(data, digest_size=DIGEST_BYTES).digest() == digest:
            return data
        return self._repair_or_quarantine(cid, digest, pad)

    # -------------------------------------------------------------- tiering
    def _promote(self, cid: int, digest: bytes, pad: int, tier: str) -> bytes:
        """Fault a demoted payload back to hot, digest-verified."""
        assert self._tiers is not None
        key = tier_key(digest, pad)
        payload = self._tiers.load(key, tier)
        if (
            payload is not None
            and hashlib.blake2b(payload, digest_size=DIGEST_BYTES).digest() == digest
        ):
            payload = bytes(payload)
            with self._lock:
                chunk = self._chunks.get(cid)
                if chunk is not None and chunk.data is None:
                    chunk.data = payload
                    chunk.tier = "hot"
                    self._hot_bytes += chunk.size
            self._tiers.evict(key, tier)
            self._tiers.stats.promotions += 1
            with self._lock:
                if self._hot_bytes > self._tiers.hot_capacity_bytes:
                    self._demote_over_capacity_locked(exclude=cid)
            return payload
        if payload is not None:
            self._tiers.stats.promote_verify_failures += 1
        # the tier copy is gone or rotten: retire it and walk repair sources
        self._tiers.evict(key, tier)
        self.repair_stats.mismatches += 1
        healed = self._heal_from_sources(cid, digest, pad)
        if healed is not None:
            return healed
        self._quarantine(cid, digest, pad)
        raise ChunkCorruptionError(
            cid,
            f"chunk {cid}: demoted payload unreadable/corrupt on tier "
            f"{tier!r} and no repair source could heal it",
        )

    def _demote_over_capacity_locked(self, exclude: Optional[int] = None) -> None:
        """Spill LRU hot payloads until hot residency fits the budget.

        Victims are chosen by recency (LRU) with lower-refcount chunks going
        first among equals — a widely shared base-image chunk stays resident
        longer than a one-off delta.  Only digest-carrying chunks demote
        (the content address is the tier key + promotion verifier).
        Caller holds the store lock; I/O here is the explicit slow path.
        """
        tiers = self._tiers
        if tiers is None or self._hot_bytes <= tiers.hot_capacity_bytes:
            return
        victims = sorted(
            (
                (c.last_use, c.refs, cid)
                for cid, c in self._chunks.items()
                if c.tier == "hot"
                and c.data is not None
                and c.digest is not None
                and not c.quarantined
                and c.size > 0
                and cid != exclude
            ),
        )
        for _, _, cid in victims:
            if self._hot_bytes <= tiers.hot_capacity_bytes:
                break
            self._spill_locked(cid)
        # warm overflow cascades to cold, coldest-LRU first
        while tiers.warm_over_capacity() > 0:
            warm = sorted(
                (c.last_use, cid)
                for cid, c in self._chunks.items()
                if c.tier == "warm" and c.digest is not None
            )
            if not warm:
                break
            sunk_any = False
            for _, cid in warm:
                if tiers.warm_over_capacity() <= 0:
                    break
                chunk = self._chunks[cid]
                assert chunk.digest is not None
                new_tier = tiers.sink(tier_key(chunk.digest, chunk.pad), chunk.tier)
                if new_tier is not None:
                    chunk.tier = new_tier
                    sunk_any = True
            if not sunk_any:
                break

    def _spill_locked(self, cid: int) -> bool:
        chunk = self._chunks[cid]
        if chunk.data is None or chunk.digest is None or self._tiers is None:
            return False
        landed = self._tiers.spill(tier_key(chunk.digest, chunk.pad), chunk.data)
        if landed is None:
            return False
        chunk.tier = landed
        chunk.data = None
        self._hot_bytes -= chunk.size
        return True

    def demote(self, cid: int, *, tier: str = "warm") -> bool:
        """Explicitly spill one chunk's payload (``tier`` = "warm" | "cold").

        Returns False when the chunk has no digest (not content-addressable)
        or no tier backend exists.  Policy callers (suspend paths, tests)
        use this; organic pressure goes through the capacity check."""
        if self._tiers is None:
            return False
        with self._lock:
            chunk = self._chunks.get(cid)
            if chunk is None or chunk.quarantined or chunk.digest is None:
                return False
            if chunk.data is not None and not self._spill_locked(cid):
                return False
            if tier == "cold" and chunk.tier == "warm":
                sunk = self._tiers.sink(tier_key(chunk.digest, chunk.pad), chunk.tier)
                if sunk is not None:
                    chunk.tier = sunk
            return True

    def tier_of(self, cid: int) -> str:
        with self._lock:
            return self._chunks[cid].tier

    def tier_bytes(self) -> Dict[str, int]:
        """Resident bytes by tier (hot always reported; warm/cold when
        a TierManager is attached)."""
        out = {"hot": self._hot_bytes}
        if self._tiers is not None:
            out.update(self._tiers.bytes_by_tier())
        return out

    @property
    def tiers(self) -> Optional["TierManager"]:
        return self._tiers

    def _repair_or_quarantine(self, cid: int, digest: bytes, pad: int) -> bytes:
        """Digest mismatch on a verified read: heal from a repair source or
        quarantine and fail loudly.  Runs outside the store lock — repair
        sources walk other subsystems (persistence blobs, generation grids).
        """
        self.repair_stats.mismatches += 1
        healed = self._heal_from_sources(cid, digest, pad)
        if healed is not None:
            return healed
        self._quarantine(cid, digest, pad)
        raise ChunkCorruptionError(
            cid, f"chunk {cid}: digest mismatch and no repair source could heal it"
        )

    def _heal_from_sources(self, cid: int, digest: bytes, pad: int) -> Optional[bytes]:
        for source in list(self._repair_sources):
            try:
                candidate = source(cid, digest, pad)
            except Exception:
                continue                    # a broken source never masks the error
            if (
                candidate is not None
                and hashlib.blake2b(candidate, digest_size=DIGEST_BYTES).digest() == digest
            ):
                healed = bytes(candidate)
                with self._lock:
                    chunk = self._chunks.get(cid)
                    if chunk is not None:
                        old_size = chunk.size
                        was_resident = chunk.data is not None
                        delta = len(healed) - old_size
                        if delta:
                            self.stats.physical_bytes += delta
                            self.stats.logical_bytes += delta * chunk.refs
                        chunk.data = healed
                        chunk.size = len(healed)
                        chunk.quarantined = False
                        # healed bytes land hot; a stale tier copy was already
                        # evicted by the promotion path that got us here
                        chunk.tier = "hot"
                        self._hot_bytes += len(healed) - (old_size if was_resident else 0)
                self.repair_stats.repaired += 1
                return healed
        return None

    def _quarantine(self, cid: int, digest: bytes, pad: int) -> None:
        with self._lock:
            chunk = self._chunks.get(cid)
            if chunk is not None and not chunk.quarantined:
                chunk.quarantined = True
                # retire the dedupe key: never hand the bad bytes to a new put
                self._by_digest.pop((digest, pad), None)
                self.repair_stats.quarantined += 1

    # -------------------------------------------------------- repair plumbing
    def attach_repair_source(self, source: RepairSource) -> None:
        """Register a ``(cid, digest, pad) -> bytes | None`` healer, tried in
        attach order on verified-read mismatches."""
        self._repair_sources.append(source)

    def quarantined_ids(self) -> List[int]:
        with self._lock:
            return sorted(cid for cid, c in self._chunks.items() if c.quarantined)

    def corrupt_chunk_for_test(self, cid: int, *, byte: int = 0) -> None:
        """Chaos-test helper: flip one bit of a stored chunk in place,
        modelling silent media corruption (the digest is left untouched, so
        a verified read detects the damage)."""
        with self._lock:
            chunk = self._chunks[cid]
            if chunk.data is not None:
                if not chunk.data:
                    return
                i = byte % len(chunk.data)
                chunk.data = (
                    chunk.data[:i] + bytes([chunk.data[i] ^ 0x01]) + chunk.data[i + 1 :]
                )
                return
            tiers, digest, pad, tier = self._tiers, chunk.digest, chunk.pad, chunk.tier
        # demoted payload: mangle the tier copy in place so the next
        # promotion sees rotten bytes (models cold/warm media corruption)
        if tiers is None or digest is None:
            return
        key = tier_key(digest, pad)
        payload = tiers.load(key, tier)
        if not payload:
            return
        i = byte % len(payload)
        rotten = payload[:i] + bytes([payload[i] ^ 0x01]) + payload[i + 1 :]
        tiers.evict(key, tier)
        tiers.store_for_test(key, rotten, tier)

    def size_of(self, cid: int) -> int:
        with self._lock:
            return self._chunks[cid].size

    def pad_of(self, cid: int) -> int:
        with self._lock:
            return self._chunks[cid].pad

    def digest_of(self, cid: int) -> Optional[bytes]:
        with self._lock:
            return self._chunks[cid].digest

    # ----------------------------------------------------------- refcounting
    def incref(self, cid: int, n: int = 1) -> None:
        with self._lock:
            chunk = self._chunks[cid]
            chunk.refs += n
            self.stats.logical_bytes += n * chunk.size

    def incref_many(self, cids) -> None:
        """Batch incref under one lock acquisition (metadata-reuse hot path)."""
        with self._lock:
            chunks = self._chunks
            logical = 0
            for cid in cids:
                chunk = chunks[cid]
                chunk.refs += 1
                logical += chunk.size
            self.stats.logical_bytes += logical

    def decref(self, cid: int, n: int = 1) -> None:
        with self._lock:
            self._decref_locked(cid, n)

    def decref_many(self, cids) -> None:
        """Batch decref under one lock acquisition (dump rollback / image GC).

        Accepts repeated ids — each occurrence drops one reference, matching
        ``TensorMeta.chunk_ids`` holding one reference per listed chunk."""
        with self._lock:
            for cid in cids:
                self._decref_locked(cid, 1)

    def _decref_locked(self, cid: int, n: int) -> None:
        chunk = self._chunks[cid]
        if chunk.refs < n:
            raise RuntimeError(f"chunk {cid}: decref below zero")
        chunk.refs -= n
        self.stats.logical_bytes -= n * chunk.size
        if chunk.refs == 0:
            if chunk.digest is not None:
                self._by_digest.pop((chunk.digest, chunk.pad), None)
            self.stats.chunks_alive -= 1
            self.stats.physical_bytes -= chunk.size
            if chunk.data is not None:
                self._hot_bytes -= chunk.size
            elif self._tiers is not None and chunk.digest is not None:
                # free the demoted copy too: the tier must not leak dead bytes
                self._tiers.evict(tier_key(chunk.digest, chunk.pad), chunk.tier)
            del self._chunks[cid]

    def refs(self, cid: int) -> int:
        with self._lock:
            return self._chunks[cid].refs

    def __contains__(self, cid: int) -> bool:
        with self._lock:
            return cid in self._chunks

    def __len__(self) -> int:
        with self._lock:
            return len(self._chunks)

    # ------------------------------------------------------- tensor helpers
    def put_array(self, arr: np.ndarray) -> tuple[int, ...]:
        """Chunk a host array's byte view; returns the chunk-id tuple."""
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return self.put_bytes(flat)

    def put_bytes(self, raw: _Buffer) -> tuple[int, ...]:
        """Zero-copy chunking: pieces are memoryview slices, hashed in place;
        bytes materialize (zero-padded) only for chunks the store must keep."""
        ids = []
        for piece, pad in iter_chunk_views(raw, self.chunk_bytes):
            digest = chunk_digest(piece, pad) if self.dedupe else None
            data = lambda p=piece, q=pad: bytes(p) + bytes(q)
            if digest is None:
                ids.append(self.put(data(), pad=pad))
            else:
                ids.append(self.put_digested(data, digest=digest, pad=pad))
        return tuple(ids)

    def get_bytes(self, ids: tuple[int, ...]) -> bytes:
        if self.verify_reads:
            # correctness path: route every chunk through the verified get
            out = []
            for cid in ids:
                data = self.get(cid)
                pad = self.pad_of(cid)
                out.append(data[: len(data) - pad] if pad else data)
            return b"".join(out)
        out = []
        demoted: List[int] = []
        with self._lock:
            for i, cid in enumerate(ids):
                chunk = self._chunks[cid]
                if chunk.quarantined:
                    raise ChunkCorruptionError(
                        cid, f"chunk {cid} is quarantined (digest mismatch, unrepaired)"
                    )
                if chunk.data is None:
                    out.append(b"")         # placeholder; faulted in below
                    demoted.append(i)
                    continue
                out.append(chunk.data[: len(chunk.data) - chunk.pad] if chunk.pad else chunk.data)
        for i in demoted:
            cid = ids[i]
            data = self.get(cid)            # promotion path: verified fault-in
            pad = self.pad_of(cid)
            out[i] = data[: len(data) - pad] if pad else data
        return b"".join(out)

    def get_array(
        self, ids: tuple[int, ...], shape: tuple[int, ...], dtype: np.dtype
    ) -> np.ndarray:
        raw = self.get_bytes(ids)
        nbytes = int(np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64)))
        flat = np.frombuffer(raw[:nbytes], dtype=dtype)
        return flat.reshape(shape).copy()
