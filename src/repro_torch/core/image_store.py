"""ImageStore — refcounted ownership of every DeltaCR dump image + lineage.

Before this module, image lifetimes were managed by convention: DeltaCR held
raw ``{image_id: DumpImage}`` dicts and callers had to ``wait_dumps()``
before reclaiming a parent checkpoint whose child delta dump was still in
flight — otherwise the drop's chunk decrefs could free bytes the child's
encode was about to re-reference (clean-chunk increfs walk the parent's
``TensorMeta.chunk_ids``).  The ImageStore replaces that convention with an
explicit, audited ownership model:

* **One record per dumping checkpoint.**  ``begin(ckpt_id)`` opens the
  record when the dump is submitted (the *checkpoint reference*);
  ``commit(ckpt_id, image)`` binds the landed :class:`DumpImage`;
  ``abort(ckpt_id)`` resolves a failed/cancelled dump.
* **Dependent references.**  Anything that needs an image's chunks to stay
  alive — an in-flight child dump delta-encoding against it, a slow-path
  restore decoding from it, a live forked sandbox that will dump against it
  — holds a reference token from :meth:`acquire`/:meth:`acquire_image` and
  releases it when done.  Tokens are record-identity-based, so a checkpoint
  id being reused can never release the wrong image.
* **Deferred frees.**  ``drop(ckpt_id)`` (GC / ``drop_checkpoint``) releases
  the checkpoint reference and immediately evicts the image's generation
  anchor (the forked pages / HBM a reclaim exists to get back), but the
  *chunk* references are only returned when the last dependent releases —
  the child dump commits bit-identically, then the parent's bytes go.
* **Lineage.**  Parent→child delta edges (``DumpImage.parent_id``) are
  queryable and, together with the rest of the store, persistable: the
  crash-consistent persistence plane (:mod:`~repro.core.persist`) snapshots
  live images via :meth:`live_images` and rebuilds them via :meth:`adopt`.

The store mutates the backing :class:`~repro_torch.core.chunk_store.ChunkStore`
only on frees (``decref_many`` of a dead image's chunk ids); all incref
traffic stays where it was — in the dump/copy-up paths that create the
references.  Lock order: callers may hold the DeltaCR lock when calling in;
the ImageStore only calls *down* (chunk store, evict hook), never back up.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from .chunk_store import ChunkStore

if TYPE_CHECKING:  # avoid a circular import; DumpImage is duck-typed here
    from .deltacr import DumpImage

__all__ = ["DumpTicket", "ImageRef", "ImageStore", "ImageStoreStats"]


@dataclass
class ImageStoreStats:
    begun: int = 0               # dump records opened
    committed: int = 0           # images that landed
    aborted: int = 0             # dumps that failed or were cancelled
    dropped: int = 0             # checkpoint references released
    freed: int = 0               # records fully released (chunks returned)
    deferred_frees: int = 0      # frees that waited on dependent references
    acquires: int = 0
    peak_records: int = 0


@dataclass
class ImageRef:
    """Opaque dependent-reference token (record identity, not ckpt id)."""

    _record: "_ImageRecord" = field(repr=False)


@dataclass
class DumpTicket:
    """Opaque in-flight-dump handle returned by :meth:`ImageStore.begin`."""

    _record: "_ImageRecord" = field(repr=False)


@dataclass
class _ImageRecord:
    ckpt_id: int
    image: Optional["DumpImage"] = None   # None while the dump is in flight
    refs: int = 0                         # dependent references outstanding
    registered: bool = True               # checkpoint reference still held
    aborted: bool = False
    dropped_while_referenced: bool = False


class ImageStore:
    """Lineage-aware, refcounted owner of a DeltaCR's dump images."""

    def __init__(
        self,
        chunks: ChunkStore,
        *,
        evict_hook: Optional[Callable[[int], None]] = None,
    ):
        self.chunks = chunks
        # Called with an image_id when its generation anchor should be
        # released (DeltaCR wires this to DeltaDumpPipeline.evict).  Fired on
        # drop (anchors return memory immediately) and again on free
        # (idempotent), never while a pipeline reader is mid-diff — the
        # pipeline's own pin protocol defers the anchor release.
        self.evict_hook = evict_hook
        self._lock = threading.RLock()
        self._by_ckpt: Dict[int, _ImageRecord] = {}
        self._by_image: Dict[int, _ImageRecord] = {}
        self._next_image_id = 1
        self.stats = ImageStoreStats()

    # ------------------------------------------------------------ lifecycle
    def allocate_image_id(self) -> int:
        with self._lock:
            image_id = self._next_image_id
            self._next_image_id += 1
            return image_id

    def begin(self, ckpt_id: int) -> "DumpTicket":
        """Open the record for a submitted dump (the checkpoint reference).

        Returns the opaque ticket the dump worker later resolves with
        :meth:`commit` or :meth:`abort`.  Re-beginning a checkpoint id that
        still has a record (an id recycled by a caller-managed counter)
        detaches the old record first — outstanding tokens and the old
        dump's ticket keep pointing at the *old* record, so they can never
        touch the new dump's image."""
        free: List[_ImageRecord] = []
        with self._lock:
            old = self._by_ckpt.get(ckpt_id)
            if old is not None:
                self._drop_locked(old, free)
            rec = _ImageRecord(ckpt_id=ckpt_id)
            self._by_ckpt[ckpt_id] = rec
            self.stats.begun += 1
            self.stats.peak_records = max(
                self.stats.peak_records, len(self._by_ckpt) + len(self._by_image)
            )
        self._free_records(free)
        return DumpTicket(rec)

    def commit(self, ticket: "DumpTicket", image: "DumpImage") -> bool:
        """Bind the landed image; returns False when the checkpoint was
        dropped mid-dump (the image is then freed as soon as its last
        dependent releases — possibly right here, and the caller must not
        register anchors for it)."""
        free: List[_ImageRecord] = []
        with self._lock:
            rec = ticket._record
            rec.image = image
            self._by_image[image.image_id] = rec
            self.stats.committed += 1
            alive = rec.registered
            self._maybe_free_locked(rec, free)
        self._free_records(free)
        return alive

    def abort(self, ticket: "DumpTicket") -> None:
        """Resolve a failed or cancelled dump: the record dies (no image was
        produced; the dump path already rolled back its chunk references)."""
        free: List[_ImageRecord] = []
        with self._lock:
            rec = ticket._record
            if rec.image is not None or rec.aborted:
                return
            rec.aborted = True
            rec.registered = False
            self.stats.aborted += 1
            self._maybe_free_locked(rec, free)
        self._free_records(free)

    def adopt(self, ckpt_id: int, image: "DumpImage") -> None:
        """Register a recovered durable image (restart recovery path).

        The caller has already materialized the image's chunk references in
        the store; this re-establishes ownership and lineage."""
        with self._lock:
            if ckpt_id in self._by_ckpt:
                raise ValueError(f"checkpoint {ckpt_id} already owns an image record")
            rec = _ImageRecord(ckpt_id=ckpt_id, image=image)
            self._by_ckpt[ckpt_id] = rec
            self._by_image[image.image_id] = rec
            self._next_image_id = max(self._next_image_id, image.image_id + 1)
            self.stats.begun += 1
            self.stats.committed += 1

    # ----------------------------------------------------------- references
    def acquire(self, ckpt_id: int) -> Optional[ImageRef]:
        """Take a dependent reference on a checkpoint's (possibly still
        in-flight) image.  None when the checkpoint never dumped or its
        record is already gone."""
        with self._lock:
            rec = self._by_ckpt.get(ckpt_id)
            if rec is None:
                return None
            rec.refs += 1
            self.stats.acquires += 1
            return ImageRef(rec)

    def acquire_image(self, image_id: Optional[int]) -> Optional[ImageRef]:
        if image_id is None:
            return None
        with self._lock:
            rec = self._by_image.get(image_id)
            if rec is None:
                return None
            rec.refs += 1
            self.stats.acquires += 1
            return ImageRef(rec)

    def release(self, ref: Optional[ImageRef]) -> None:
        """Return a dependent reference (None-tolerant)."""
        if ref is None:
            return
        free: List[_ImageRecord] = []
        with self._lock:
            rec = ref._record
            if rec.refs <= 0:
                raise RuntimeError(
                    f"image record for checkpoint {rec.ckpt_id}: release below zero"
                )
            rec.refs -= 1
            self._maybe_free_locked(rec, free)
        self._free_records(free)

    def drop(self, ckpt_id: int) -> bool:
        """Release the checkpoint reference (reclaim / drop_checkpoint).

        Non-blocking: the generation anchor is evicted immediately (memory
        back now); chunk references follow when the last dependent — e.g. a
        child delta dump still streaming — releases."""
        free: List[_ImageRecord] = []
        with self._lock:
            rec = self._by_ckpt.get(ckpt_id)
            if rec is None or not rec.registered:
                return False
            self._drop_locked(rec, free)
            if rec.image is not None and rec not in free:
                rec.dropped_while_referenced = rec.refs > 0
            evicted = {rec.image.image_id} if rec.image is not None else set()
        self._free_records(free, already_evicted=evicted)
        # anchors (forked pages / HBM) never outlive the drop, even when the
        # chunk bytes must linger for a dependent dump
        if self.evict_hook is not None:
            for image_id in evicted:
                self.evict_hook(image_id)
        return True

    # -------------------------------------------------------------- queries
    def get(self, image_id: Optional[int]) -> Optional["DumpImage"]:
        if image_id is None:
            return None
        with self._lock:
            rec = self._by_image.get(image_id)
            return rec.image if rec is not None else None

    def image_for(self, ckpt_id: int) -> Optional["DumpImage"]:
        with self._lock:
            rec = self._by_ckpt.get(ckpt_id)
            return rec.image if rec is not None else None

    def is_live(self, ckpt_id: int) -> bool:
        with self._lock:
            rec = self._by_ckpt.get(ckpt_id)
            return rec is not None and rec.registered

    def live_images(self) -> List[Tuple[int, "DumpImage"]]:
        """(ckpt_id, image) for every committed, still-registered image —
        the persistence plane's snapshot set — ordered by image id."""
        with self._lock:
            out = [
                (rec.ckpt_id, rec.image)
                for rec in self._by_ckpt.values()
                if rec.registered and rec.image is not None
            ]
        out.sort(key=lambda t: t[1].image_id)
        return out

    def children(self, image_id: int) -> List[int]:
        """Live image ids whose delta parent is ``image_id`` (lineage edges)."""
        with self._lock:
            return sorted(
                rec.image.image_id
                for rec in self._by_ckpt.values()
                if rec.image is not None and rec.image.parent_id == image_id
            )

    def find_chunk(self, cid: int) -> List[Tuple[int, str, int]]:
        """Every (image_id, tensor_name, chunk_index) that references ``cid``.

        The verified-read repair path uses this to locate an anchored
        generation grid row that can re-derive a corrupt chunk's bytes;
        dedupe means one chunk may back many images, so all locations are
        returned (newest image first — its anchor is likeliest to be live)."""
        out: List[Tuple[int, str, int]] = []
        with self._lock:
            for rec in self._by_image.values():
                if rec.image is None:
                    continue
                for name, meta in rec.image.entries.items():
                    for idx, chunk_id in enumerate(meta.chunk_ids):
                        if chunk_id == cid:
                            out.append((rec.image.image_id, name, idx))
        out.sort(key=lambda t: t[0], reverse=True)
        return out

    def live_count(self) -> int:
        with self._lock:
            return sum(
                1
                for rec in self._by_ckpt.values()
                if rec.registered and rec.image is not None
            )

    def deferred_count(self) -> int:
        """Images whose checkpoint was dropped but whose chunks are still
        pinned by dependent references (the refcounting win, observable)."""
        with self._lock:
            return sum(
                1
                for rec in self._by_image.values()
                if not rec.registered and rec.image is not None
            )

    def next_image_id(self) -> int:
        with self._lock:
            return self._next_image_id

    def set_next_image_id(self, value: int) -> None:
        """Restore the id counter after recovery (never moves backwards)."""
        with self._lock:
            self._next_image_id = max(self._next_image_id, int(value))

    def debug_validate(self) -> None:
        """Every live record's image chunks must be alive in the store."""
        with self._lock:
            for rec in self._by_image.values():
                assert rec.image is not None
                for meta in rec.image.entries.values():
                    for cid in meta.chunk_ids:
                        assert cid in self.chunks, (
                            f"image {rec.image.image_id}: dangling chunk {cid}"
                        )

    # ------------------------------------------------------------- internal
    def _drop_locked(self, rec: _ImageRecord, free: List[_ImageRecord]) -> None:
        if rec.registered:
            rec.registered = False
            self.stats.dropped += 1
        self._maybe_free_locked(rec, free)

    def _maybe_free_locked(self, rec: _ImageRecord, free: List[_ImageRecord]) -> None:
        if rec.registered or rec.refs > 0:
            return
        if rec.aborted or rec.image is not None:
            # fully resolved: unlink now, return chunks outside the lock.
            # The ckpt binding is removed only if it still points at *this*
            # record (begin() may have recycled the id onto a new dump).
            if self._by_ckpt.get(rec.ckpt_id) is rec:
                del self._by_ckpt[rec.ckpt_id]
            if rec.image is not None:
                self._by_image.pop(rec.image.image_id, None)
            free.append(rec)
        # else: dump still in flight (drop raced submission); commit/abort
        # will resolve the record and free it then

    def _free_records(
        self, free: List[_ImageRecord], *, already_evicted: Optional[set] = None
    ) -> None:
        for rec in free:
            if rec.image is not None:
                self.chunks.decref_many(
                    cid for meta in rec.image.entries.values() for cid in meta.chunk_ids
                )
                if self.evict_hook is not None and (
                    already_evicted is None or rec.image.image_id not in already_evicted
                ):
                    self.evict_hook(rec.image.image_id)
            with self._lock:
                self.stats.freed += 1
                if rec.dropped_while_referenced:
                    self.stats.deferred_frees += 1
