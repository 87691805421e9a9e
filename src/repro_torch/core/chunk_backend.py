"""Tiered chunk backends — hot host RAM, warm local-disk blobs, cold objects.

The :class:`~repro_torch.core.chunk_store.ChunkStore` holds every chunk's bytes in
host RAM ("hot").  At fleet scale that is the wrong resting place for the
long tail: a suspended agent's base-image chunks are read once per resume,
and N forked sandboxes share most of their bytes.  This module gives the
store a spill hierarchy behind one small protocol:

* **hot**   — the store's in-RAM ``bytes`` (no backend; the default tier),
* **warm**  — :class:`WarmBackend`: append-only local-disk blob segments
  with an in-memory extent map (the paper's tmpfs→disk demotion),
* **cold**  — :class:`ColdBackend`: an object-store-shaped backend,
  content-addressed by chunk digest.  The default
  :class:`DirObjectClient` is a sharded directory tree; any client with
  ``put_object/get_object/delete_object/list_keys`` (S3, GCS, ...) slots in.

Tier *keys* are content addresses — ``"<digest-hex>-<pad>"``, the store's
dedupe key — so demoted bytes dedupe across every sandbox sharing a store,
and a promoted read can always be digest-verified before the bytes are
trusted (a corrupt cold object is detected at promotion, not at use, and
heals through the store's repair sources).

Demotion/promotion *policy* lives in the ChunkStore (it owns the refcount
and recency signals); this module is pure mechanism plus the
:class:`TierManager` that routes spill pressure hot→warm→cold.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Protocol, Tuple

from . import faults

__all__ = [
    "ChunkBackend",
    "ColdBackend",
    "DirObjectClient",
    "ObjectClient",
    "TierManager",
    "TierStats",
    "WarmBackend",
    "tier_key",
]


def tier_key(digest: bytes, pad: int) -> str:
    """Content address of a padded chunk: the store's dedupe key, printable."""
    return f"{digest.hex()}-{int(pad)}"


class ChunkBackend(Protocol):
    """One spill tier: keyed blob storage for demoted chunk payloads."""

    name: str

    def put(self, key: str, data: bytes) -> None: ...

    def get(self, key: str) -> Optional[bytes]: ...

    def delete(self, key: str) -> None: ...

    def __contains__(self, key: str) -> bool: ...

    def bytes_used(self) -> int: ...


# --------------------------------------------------------------------------
# warm: append-only local blob segments
# --------------------------------------------------------------------------
class WarmBackend:
    """Local-disk spill tier: chunks appended to rotating blob segments.

    One file per chunk would burn an inode per 64 KiB; instead payloads are
    appended to ``seg-%06d.blob`` files (rotated at ``segment_bytes``) with
    an in-memory ``key -> (segment, offset, length)`` extent map.  ``delete``
    only marks bytes dead; a segment file is unlinked when its last live
    extent dies.  The tier is a *cache* of bytes the store can re-derive
    (durability is the persistence plane's job), so writes are not fsynced.
    """

    name = "warm"

    def __init__(self, root: str, *, segment_bytes: int = 8 << 20):
        self.root = root
        self.segment_bytes = int(segment_bytes)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._extents: Dict[str, Tuple[int, int, int]] = {}  # key -> (seg, off, len)
        self._seg_live: Dict[int, int] = {}                  # seg -> live bytes
        self._seg_size: Dict[int, int] = {}                  # seg -> total bytes
        self._seg = 0
        self._bytes = 0

    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.root, f"seg-{seg:06d}.blob")

    def put(self, key: str, data: bytes) -> None:
        data = bytes(data)
        with self._lock:
            if key in self._extents:
                return
            seg = self._seg
            if self._seg_size.get(seg, 0) + len(data) > self.segment_bytes and self._seg_size.get(seg, 0):
                self._seg = seg = seg + 1
            path = self._seg_path(seg)
            with open(path, "ab") as f:
                off = f.tell()
                f.write(data)
            self._extents[key] = (seg, off, len(data))
            self._seg_live[seg] = self._seg_live.get(seg, 0) + len(data)
            self._seg_size[seg] = off + len(data)
            self._bytes += len(data)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            ext = self._extents.get(key)
            if ext is None:
                return None
            seg, off, length = ext
            path = self._seg_path(seg)
        try:
            with open(path, "rb") as f:
                f.seek(off)
                return f.read(length)
        except OSError:
            return None

    def delete(self, key: str) -> None:
        with self._lock:
            ext = self._extents.pop(key, None)
            if ext is None:
                return
            seg, _off, length = ext
            self._bytes -= length
            live = self._seg_live.get(seg, 0) - length
            self._seg_live[seg] = live
            if live <= 0 and seg != self._seg:
                self._seg_live.pop(seg, None)
                self._seg_size.pop(seg, None)
                try:
                    os.unlink(self._seg_path(seg))
                except OSError:
                    pass

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._extents

    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes


# --------------------------------------------------------------------------
# cold: object-store-shaped, content-addressed
# --------------------------------------------------------------------------
class ObjectClient(Protocol):
    """Minimal object-store surface (S3/GCS-shaped) the cold tier needs."""

    def put_object(self, key: str, data: bytes) -> None: ...

    def get_object(self, key: str) -> Optional[bytes]: ...

    def delete_object(self, key: str) -> None: ...

    def list_keys(self) -> Iterator[str]: ...


class DirObjectClient:
    """Default object client: a sharded directory tree (``ab/abcdef...``).

    Stands in for a real bucket in tests and single-host deployments; the
    two-hex-char shard keeps any one directory from ballooning at fleet
    scale.  Writes are atomic (temp + rename) so a torn put never leaves a
    half object behind a content-addressed key.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key)

    def put_object(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get_object(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def delete_object(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def list_keys(self) -> Iterator[str]:
        for shard in sorted(os.listdir(self.root)):
            shard_dir = os.path.join(self.root, shard)
            if not os.path.isdir(shard_dir):
                continue
            for key in sorted(os.listdir(shard_dir)):
                if not key.endswith(".tmp"):
                    yield key


class ColdBackend:
    """Cold tier over an :class:`ObjectClient` (content-addressed objects)."""

    name = "cold"

    def __init__(self, client: ObjectClient):
        self.client = client
        self._lock = threading.Lock()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            known = key in self._sizes
        if known:
            return
        self.client.put_object(key, bytes(data))
        with self._lock:
            if key not in self._sizes:
                self._sizes[key] = len(data)
                self._bytes += len(data)

    def get(self, key: str) -> Optional[bytes]:
        return self.client.get_object(key)

    def delete(self, key: str) -> None:
        self.client.delete_object(key)
        with self._lock:
            size = self._sizes.pop(key, None)
            if size is not None:
                self._bytes -= size

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._sizes

    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes


# --------------------------------------------------------------------------
# the tier manager: mechanism for hot→warm→cold spill
# --------------------------------------------------------------------------
@dataclass
class TierStats:
    """Observable tier motion + residency (fed into gc stats / health())."""

    demotions_warm: int = 0       # hot → warm spills
    demotions_cold: int = 0       # warm → cold spills
    promotions: int = 0           # tier → hot faults (reads of demoted chunks)
    tier_deletes: int = 0         # demoted payloads freed (chunk died)
    promote_verify_failures: int = 0  # digest mismatch at promotion

    def snapshot(self) -> "TierStats":
        return TierStats(**vars(self))


class TierManager:
    """Routes demoted chunk payloads across the warm/cold backends.

    The ChunkStore decides *which* chunks to demote (refcount/recency); this
    object decides *where* bytes rest and moves them down (`spill`) or back
    up (`load`).  ``warm_capacity_bytes`` bounds the warm tier: spilling past
    it pushes the warm tier's overflow victims (chosen by the store) to cold.
    """

    def __init__(
        self,
        *,
        warm: Optional[WarmBackend] = None,
        cold: Optional[ColdBackend] = None,
        hot_capacity_bytes: int = 1 << 30,
        warm_capacity_bytes: int = 4 << 30,
    ):
        if warm is None and cold is None:
            raise ValueError("TierManager needs at least one backend (warm/cold)")
        self.warm = warm
        self.cold = cold
        self.hot_capacity_bytes = int(hot_capacity_bytes)
        self.warm_capacity_bytes = int(warm_capacity_bytes)
        self.stats = TierStats()

    # ------------------------------------------------------------- mechanism
    def spill(self, key: str, data: bytes) -> Optional[str]:
        """Demote one hot payload; returns the tier name it landed on."""
        faults.fire("tier.io")
        if self.warm is not None:
            self.warm.put(key, data)
            self.stats.demotions_warm += 1
            return self.warm.name
        assert self.cold is not None
        self.cold.put(key, data)
        self.stats.demotions_cold += 1
        return self.cold.name

    def sink(self, key: str, tier: str) -> Optional[str]:
        """Push an already-demoted payload one tier down (warm → cold).

        Returns the new tier name, or None when there is nowhere colder."""
        if tier != "warm" or self.warm is None or self.cold is None:
            return None
        faults.fire("tier.io")
        data = self.warm.get(key)
        if data is None:
            return None
        self.cold.put(key, data)
        self.warm.delete(key)
        self.stats.demotions_cold += 1
        return self.cold.name

    def load(self, key: str, tier: str) -> Optional[bytes]:
        """Read a demoted payload back (promotion fault).  The caller
        verifies the digest before trusting the bytes."""
        backend = self._backend(tier)
        if backend is None:
            return None
        data = backend.get(key)
        return faults.fire("tier.io", data)

    def evict(self, key: str, tier: str) -> None:
        """Drop a demoted payload (its chunk died or was promoted)."""
        backend = self._backend(tier)
        if backend is not None:
            backend.delete(key)
            self.stats.tier_deletes += 1

    def store_for_test(self, key: str, data: bytes, tier: str) -> None:
        """Chaos-test seam: place arbitrary bytes at a tier key (used to
        model on-media corruption of a demoted payload)."""
        backend = self._backend(tier)
        if backend is not None:
            backend.put(key, data)

    def _backend(self, tier: str) -> Optional[ChunkBackend]:
        if tier == "warm":
            return self.warm
        if tier == "cold":
            return self.cold
        return None

    # ----------------------------------------------------------- observables
    def bytes_by_tier(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        if self.warm is not None:
            out["warm"] = self.warm.bytes_used()
        if self.cold is not None:
            out["cold"] = self.cold.bytes_used()
        return out

    def warm_over_capacity(self) -> int:
        if self.warm is None:
            return 0
        return max(0, self.warm.bytes_used() - self.warm_capacity_bytes)


def make_local_tiers(
    root: str,
    *,
    hot_capacity_bytes: int = 1 << 30,
    warm_capacity_bytes: int = 4 << 30,
    segment_bytes: int = 8 << 20,
    cold: bool = True,
) -> TierManager:
    """Convenience constructor: warm segments + dir-object cold under ``root``."""
    warm = WarmBackend(os.path.join(root, "warm"), segment_bytes=segment_bytes)
    cold_backend = (
        ColdBackend(DirObjectClient(os.path.join(root, "cold"))) if cold else None
    )
    return TierManager(
        warm=warm,
        cold=cold_backend,
        hot_capacity_bytes=hot_capacity_bytes,
        warm_capacity_bytes=warm_capacity_bytes,
    )


_ = List  # typing re-export guard (ruff: keep List available for subclasses)
