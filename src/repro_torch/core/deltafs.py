"""DeltaFS — runtime-reconfigurable overlay layers over a tensor namespace.

The durable dimension of a DeltaBox sandbox, split into the two roles the
concurrent sandbox tree needs:

* :class:`LayerStore` — the **shared** half: the refcounted layer table over
  one :class:`~repro_torch.core.chunk_store.ChunkStore`.  Frozen layers are
  immutable and may be referenced by any number of live namespace stacks and
  retained checkpoint configurations at once; releasing the last reference
  to a layer decrefs exactly the chunks no surviving generation shares.
  One ``LayerStore`` backs every sandbox forked from the same lineage —
  sibling sandboxes share every frozen layer byte-for-byte.

* :class:`NamespaceView` — the **per-sandbox** half: a layer *stack*
  (bottom-to-top, last element the private writable upper), a
  generation-tagged resolve cache, and the checkpoint/switch protocol:

  - ``write``     — whole-tensor copy-up into the upper layer, with every
                    chunk the write did not change *re-referenced* from the
                    parent generation (the reflink extent-map-preservation
                    analogue): physical write amplification is O(dirtied
                    chunks).
  - ``checkpoint`` — freeze the upper layer, splice it as the topmost lower
                    and install a fresh upper.  O(1) metadata; no data
                    copied.
  - ``switch``    — replace the layer stack with any previously frozen
                    configuration (rollback / restore).  O(1).
  - ``checkpoint_gen`` — per-view generation counter.  Read resolutions are
                    cached per key tagged with the generation at which they
                    were resolved; a gen mismatch lazily re-resolves against
                    the new stack (the paper's lazy switch for open files,
                    §4.1.1).

:class:`DeltaFS` is the single-sandbox facade (a ``NamespaceView`` owning a
private ``LayerStore``) and keeps the historical API; multi-sandbox callers
(:class:`~repro.core.sandbox_tree.SandboxTree`) open additional views over
``fs.layers`` so sibling sandboxes diverge only in their uppers.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .chunk_store import ChunkStore, chunk_digest, iter_chunk_views

__all__ = [
    "DeltaFS",
    "LayerConfig",
    "LayerStore",
    "NamespaceView",
    "TensorMeta",
    "array_from_bytes",
    "digest_encode_array",
    "dtype_itemsize",
    "dtype_str",
    "host_bytes",
    "torch_dtype",
]

LayerConfig = Tuple[int, ...]  # bottom-to-top tuple of frozen layer ids


# --------------------------------------------------------------------------
# dtype names shared by numpy arrays and torch tensors
# --------------------------------------------------------------------------
# Image entries record a dtype *name* ("float32", "bfloat16"), identical to
# the names the JAX package records, so images compare across packages.
# numpy has no bfloat16 (and the GPU host has no ml_dtypes): such dtypes
# cross the host as raw words of the same width and are reinterpreted as
# torch tensors of the logical dtype.
_WORD_CARRIED: Dict[str, Tuple[Any, torch.dtype]] = {
    "bfloat16": (np.int16, torch.bfloat16),
}
_DTYPE_STR: Dict[Any, str] = {}


def dtype_str(dt: Any) -> str:
    """Canonical dtype name of a numpy or torch dtype: ``torch.bfloat16``
    and ``np.float32`` give ``"bfloat16"`` and ``"float32"``."""
    s = _DTYPE_STR.get(dt)
    if s is None:
        s = str(dt)
        if s.startswith("torch."):
            s = s[len("torch."):]
        _DTYPE_STR[dt] = s
    return s


_TORCH_DTYPES: Dict[str, torch.dtype] = {
    dtype_str(d): d
    for d in (
        torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
        torch.float16, torch.bfloat16, torch.float32, torch.float64,
    )
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name ("float32", "bfloat16", ...)."""
    return _TORCH_DTYPES[name]


def dtype_itemsize(name: str) -> int:
    carried = _WORD_CARRIED.get(name)
    if carried is not None:
        return np.dtype(carried[0]).itemsize
    return np.dtype(name).itemsize


def host_bytes(arr: Any) -> np.ndarray:
    """Flat uint8 host bytes of a numpy array or a torch tensor (a view
    when the array is already contiguous on the host)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().reshape(-1).view(torch.uint8)
        return t.cpu().numpy()
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def array_from_bytes(raw: Any, shape: Tuple[int, ...], name: str) -> Any:
    """Rebuild a tensor from its stored bytes: a numpy array, or a CPU torch
    tensor for dtypes numpy cannot hold (bfloat16)."""
    n = int(np.prod(shape, dtype=np.int64))
    carried = _WORD_CARRIED.get(name)
    if carried is not None:
        words = np.frombuffer(raw, dtype=carried[0], count=n).reshape(shape)
        return torch.from_numpy(words.copy()).view(carried[1])
    return np.frombuffer(raw, dtype=np.dtype(name), count=n).reshape(shape).copy()


@dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: str
    chunk_ids: Tuple[int, ...]
    # Per-chunk blake2b-16 digests (over the zero-padded chunk bytes) and
    # the final chunk's trailing pad.  Digests make parent matching on the
    # dump/write paths a 16-byte compare instead of a full bytes equality;
    # ``digests == ()`` marks metadata from older images (byte-compare
    # fallback).
    digests: Tuple[bytes, ...] = ()
    trailing_pad: int = 0

    @property
    def nbytes(self) -> int:
        return int(dtype_itemsize(self.dtype) * int(np.prod(self.shape, dtype=np.int64)))


def digest_encode_array(
    store: ChunkStore, arr: Any, prev: Optional[TensorMeta]
) -> Tuple[TensorMeta, int]:
    """Delta-encode a host tensor against its parent entry by chunk digest.

    The one digest-delta loop shared by DeltaFS copy-ups and the DeltaCR
    digest dump path: zero-copy memoryview chunking, each chunk hashed
    exactly once, parent matching as a 16-byte digest compare (falling back
    to a full byte compare against pre-digest metadata), bytes materialized
    only for chunks the store must keep.  Returns (meta, dirtied_chunks).
    """
    shape, dtype = tuple(arr.shape), dtype_str(arr.dtype)
    raw = host_bytes(arr)
    prev_ids: Tuple[int, ...] = ()
    prev_digests: Tuple[bytes, ...] = ()
    if (
        prev is not None
        and prev.shape == shape
        and prev.dtype == dtype
    ):
        prev_ids = prev.chunk_ids
        if len(prev.digests) == len(prev_ids):
            prev_digests = prev.digests
    ids = []
    digests = []
    dirtied = 0
    trailing_pad = 0
    try:
        for idx, (piece, pad) in enumerate(iter_chunk_views(raw, store.chunk_bytes)):
            trailing_pad = pad
            digest = chunk_digest(piece, pad)
            if idx < len(prev_ids):
                if prev_digests:
                    same = prev_digests[idx] == digest
                else:  # pre-digest metadata: full byte compare
                    same = store.get(prev_ids[idx]) == bytes(piece) + bytes(pad)
                if same:
                    store.incref(prev_ids[idx])
                    ids.append(prev_ids[idx])
                    digests.append(digest)
                    continue
            ids.append(
                store.put_digested(
                    lambda p=piece, q=pad: bytes(p) + bytes(q), digest=digest, pad=pad
                )
            )
            digests.append(digest)
            dirtied += 1
    except BaseException:
        # transactional: a put/get fault mid-tensor must not strand the
        # refs this call already took — callers never see partial metas
        store.decref_many(ids)
        raise
    return (
        TensorMeta(
            shape=shape,
            dtype=dtype,
            chunk_ids=tuple(ids),
            digests=tuple(digests),
            trailing_pad=trailing_pad,
        ),
        dirtied,
    )


def read_meta_array(store: ChunkStore, meta: TensorMeta) -> Any:
    """Gather an entry's chunks back into an array of its logical dtype."""
    return array_from_bytes(store.get_bytes(meta.chunk_ids), meta.shape, meta.dtype)


@dataclass
class _Layer:
    layer_id: int
    frozen: bool = False
    refs: int = 0                       # held by live stacks + retained configs
    entries: Dict[str, TensorMeta] = field(default_factory=dict)
    tombstones: set = field(default_factory=set)


class LayerStore:
    """Shared, refcounted layer table over one chunk store.

    The multi-sandbox substrate: every :class:`NamespaceView` (one per live
    sandbox) and every retained checkpoint configuration holds per-layer
    references here.  Frozen layers are immutable, so concurrent views read
    them lock-free in spirit (the shared lock only orders refcount motion
    and table mutation); a layer — and, transitively, the chunks only it
    references — is freed exactly when the last view or configuration
    releases it.
    """

    def __init__(
        self,
        store: Optional[ChunkStore] = None,
        *,
        chunk_bytes: int = 64 * 1024,
        tiers=None,
    ):
        # explicit None check: an empty ChunkStore is falsy (len 0)
        self.chunks = (
            store if store is not None else ChunkStore(chunk_bytes=chunk_bytes, tiers=tiers)
        )
        self.lock = threading.RLock()
        self._layers: Dict[int, _Layer] = {}
        self._next_layer_id = 1

    # ----------------------------------------------------------- layer mgmt
    def new_layer(self, *, refs: int = 0) -> _Layer:
        """Register a fresh mutable layer.

        ``refs`` pre-retains the layer atomically with its creation — a
        live stack installing an upper must never expose a zero-ref layer
        to a concurrent ``debug_validate``."""
        with self.lock:
            layer = _Layer(layer_id=self._next_layer_id, refs=refs)
            self._next_layer_id += 1
            self._layers[layer.layer_id] = layer
            return layer

    def get(self, layer_id: int) -> Optional[_Layer]:
        with self.lock:
            return self._layers.get(layer_id)

    def freeze(self, layer_id: int) -> None:
        with self.lock:
            self._layers[layer_id].frozen = True

    # ---------------------------------------------------------- refcounting
    def retain_layer(self, layer_id: int) -> None:
        with self.lock:
            self._layers[layer_id].refs += 1

    def release_layer(self, layer_id: int) -> None:
        with self.lock:
            layer = self._layers[layer_id]
            layer.refs -= 1
            if layer.refs == 0:
                for meta in layer.entries.values():
                    for cid in meta.chunk_ids:
                        self.chunks.decref(cid)
                del self._layers[layer_id]

    def retain_config(self, config: Iterable[int]) -> None:
        with self.lock:
            for layer_id in config:
                self._layers[layer_id].refs += 1

    def retain_frozen_config(self, config: Iterable[int]) -> None:
        """Validate-then-retain a frozen configuration atomically.

        The one protocol shared by ``NamespaceView.switch`` and view
        mounting (``__init__``): every layer must exist and be frozen, and
        no reference moves unless all of them are."""
        with self.lock:
            for layer_id in config:
                layer = self._layers.get(layer_id)
                if layer is None or not layer.frozen:
                    raise ValueError(f"layer {layer_id} is not a frozen live layer")
            for layer_id in config:
                self._layers[layer_id].refs += 1

    def release_config(self, config: Iterable[int]) -> None:
        with self.lock:
            for layer_id in config:
                self.release_layer(layer_id)

    # -------------------------------------------------------------- helpers
    def layer_count(self) -> int:
        with self.lock:
            return len(self._layers)

    def debug_validate(self) -> None:
        """Invariant check used by property/stress tests.

        Every chunk any live layer references must be alive in the store,
        and every registered layer must be reachable (positive refcount) —
        a zero-ref layer still in the table is a leak.
        """
        with self.lock:
            for layer in self._layers.values():
                assert layer.refs > 0, f"leaked layer {layer.layer_id} (refs=0)"
                for meta in layer.entries.values():
                    for cid in meta.chunk_ids:
                        assert cid in self.chunks, f"dangling chunk {cid}"


class NamespaceView:
    """One sandbox's mount of a shared :class:`LayerStore`.

    Holds the per-sandbox state — layer stack, writable upper, resolve
    cache, generation counter — while all layer bytes live in the shared
    store.  Views created with a ``base_config`` start bit-identical to that
    frozen configuration and diverge only through their private upper; any
    number of sibling views may share the same base layers.
    """

    def __init__(self, layers: LayerStore, *, base_config: LayerConfig = ()):
        self.layers = layers
        # Per-view lock: guards this view's private state only (stack,
        # resolve cache, in-flight count).  All refcount motion and layer
        # table/entry mutation goes through LayerStore methods (or a nested
        # ``layers.lock`` block), so sibling views' metadata ops — resolves,
        # cache hits, stack reads — no longer serialize on the one shared
        # lock under wide write-heavy fan-outs.  Lock order is always
        # view lock → store lock, never the reverse.
        self._lock = threading.RLock()
        self._stack: list[int] = []      # bottom-to-top; last element is the writable upper
        self.checkpoint_gen = 0
        # key -> (generation, layer_id holding the topmost entry, is_tombstone)
        self._resolve_cache: Dict[str, Tuple[int, int, bool]] = {}
        self.lazy_reresolves = 0         # slow-path count (gen mismatch), for tests/benches
        self._closed = False
        self._inflight = 0               # ops in their unlocked heavy phase
        # stacks switched away from while ops were in flight; released by
        # the last op out so reads never gather from freed chunks
        self._pending_release: list[list[int]] = []
        with self._lock:
            layers.retain_frozen_config(base_config)   # live-stack references
            self._stack = list(base_config)
            self._push_fresh_upper()

    # Reads of *frozen* layers' entries run without the store lock: frozen
    # layers are immutable, the private upper is only mutated by this view
    # (under both locks), and our stack references keep every stacked layer
    # alive — the store lock only orders table mutation and ref motion.

    # ------------------------------------------------------------- plumbing
    @property
    def store(self) -> ChunkStore:
        """The backing chunk store (kept as the historical attribute name)."""
        return self.layers.chunks

    def _push_fresh_upper(self) -> None:
        layer = self.layers.new_layer(refs=1)      # held by this live stack
        self._stack.append(layer.layer_id)

    @property
    def upper_id(self) -> int:
        return self._stack[-1]

    @property
    def stack(self) -> LayerConfig:
        with self._lock:
            return tuple(self._stack)

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        # fail fast and loud: an operation on a closed view must not reach
        # the shared store (a write would take chunk refs it can never
        # release) nor masquerade as "key missing"
        if self._closed:
            raise RuntimeError("namespace view is closed (sandbox released)")

    def _finish_op(self) -> None:
        """End an op's unlocked heavy phase; the last one out performs any
        deferred stack releases (close() or switch() that arrived while
        this op was gathering/encoding)."""
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                for stack in self._pending_release:
                    for layer_id in stack:
                        self.layers.release_layer(layer_id)
                self._pending_release.clear()
                if self._closed:
                    self._release_stack_locked()

    def _release_stack_locked(self) -> None:
        stack, self._stack = self._stack, []
        self._resolve_cache.clear()
        for layer_id in stack:
            self.layers.release_layer(layer_id)

    # -------------------------------------------------------------- resolve
    def _resolve(self, key: str) -> Optional[TensorMeta]:
        """Topmost-entry resolution with generation-tagged caching."""
        layers = self.layers._layers
        cached = self._resolve_cache.get(key)
        if cached is not None:
            gen, layer_id, dead = cached
            if gen == self.checkpoint_gen:  # fast path: same generation
                if dead:
                    return None
                layer = layers.get(layer_id)
                if layer is not None:
                    entry = layer.entries.get(key)
                    if entry is not None:
                        return entry
            else:
                self.lazy_reresolves += 1   # slow path: stale gen, re-resolve
        for layer_id in reversed(self._stack):
            layer = layers[layer_id]
            if key in layer.tombstones:
                self._resolve_cache[key] = (self.checkpoint_gen, layer_id, True)
                return None
            meta = layer.entries.get(key)
            if meta is not None:
                self._resolve_cache[key] = (self.checkpoint_gen, layer_id, False)
                return meta
        self._resolve_cache[key] = (self.checkpoint_gen, -1, True)
        return None

    # ------------------------------------------------------------------ api
    def exists(self, key: str) -> bool:
        with self._lock:
            self._check_open()
            return self._resolve(key) is not None

    def keys(self) -> list[str]:
        with self._lock:
            self._check_open()
            layers = self.layers._layers
            seen: Dict[str, bool] = {}
            for layer_id in reversed(self._stack):
                layer = layers[layer_id]
                for k in layer.tombstones:
                    seen.setdefault(k, False)
                for k in layer.entries:
                    seen.setdefault(k, True)
            return sorted(k for k, alive in seen.items() if alive)

    def read(self, key: str) -> np.ndarray:
        with self._lock:
            self._check_open()
            meta = self._resolve(key)
            if meta is None:
                raise KeyError(key)
            self._inflight += 1
        try:
            # Chunk gather runs outside the shared layer lock (the store
            # locks itself).  The in-flight count makes a concurrent
            # close() defer the stack release, so the chunks stay alive
            # until this op finishes.
            return read_meta_array(self.store, meta)
        finally:
            self._finish_op()

    def read_meta(self, key: str) -> TensorMeta:
        with self._lock:
            self._check_open()
            meta = self._resolve(key)
            if meta is None:
                raise KeyError(key)
            return meta

    def write(self, key: str, value: np.ndarray) -> int:
        """Copy-up ``value`` into the upper layer.

        Returns the number of *physical* chunks written (the dirtied-block
        count); unchanged chunks are shared with the previous generation.
        """
        value = np.ascontiguousarray(value)
        with self._lock:
            self._check_open()
            prev = self._resolve(key)
            self._inflight += 1
        # The O(tensor-bytes) hash/encode runs outside the shared layer lock
        # (the chunk store locks itself), so sibling sandboxes' copy-ups
        # proceed in parallel.  The in-flight count keeps a concurrent
        # close() from freeing ``prev``'s chunks mid-encode.
        try:
            meta, dirtied = digest_encode_array(self.store, value, prev)
        except BaseException:
            self._finish_op()
            raise
        with self._lock:
            if self._closed:
                # closed between the two phases: return the just-taken chunk
                # refs before failing, or they would leak
                self.store.decref_many(meta.chunk_ids)
                self._finish_op()
                raise RuntimeError("namespace view is closed (sandbox released)")
            upper_id = self.upper_id
            with self.layers.lock:   # entry mutation: visible to validators
                upper = self.layers._layers[upper_id]
                old_entry = upper.entries.get(key)
                upper.entries[key] = meta
                upper.tombstones.discard(key)
            if old_entry is not None:  # second write to same key in this generation
                self.store.decref_many(old_entry.chunk_ids)
            self._resolve_cache[key] = (self.checkpoint_gen, upper_id, False)
            self._finish_op()
            return dirtied

    def delete(self, key: str) -> None:
        with self._lock:
            self._check_open()
            if self._resolve(key) is None:
                raise KeyError(key)
            upper_id = self.upper_id
            with self.layers.lock:   # entry mutation: visible to validators
                upper = self.layers._layers[upper_id]
                entry = upper.entries.pop(key, None)
                upper.tombstones.add(key)
            if entry is not None:
                self.store.decref_many(entry.chunk_ids)
            self._resolve_cache[key] = (self.checkpoint_gen, upper_id, True)

    # ------------------------------------------------------- checkpointing
    def checkpoint(self) -> LayerConfig:
        """Freeze the upper layer and install a fresh one.  O(1) metadata.

        Returns the frozen layer configuration (bottom-to-top), with one
        reference retained on every layer in it on behalf of the caller.
        """
        with self._lock:
            self._check_open()
            self.layers.freeze(self.upper_id)
            config = tuple(self._stack)
            self.layers.retain_config(config)   # caller's retained reference
            self._push_fresh_upper()
            self.checkpoint_gen += 1
            return config

    def switch(self, config: LayerConfig) -> None:
        """Atomically replace the layer stack with ``config`` + fresh upper.

        The rollback primitive: O(1) in data, O(stack depth) in metadata.
        The abandoned (possibly dirty) upper layer is released.
        """
        with self._lock:
            self._check_open()
            self.layers.retain_frozen_config(config)   # new stack references
            old_stack = list(self._stack)
            self._stack = list(config)
            self._push_fresh_upper()
            if self._inflight:
                # an unlocked read/encode may still reference the old
                # stack's chunks; the last op out releases it
                self._pending_release.append(old_stack)
            else:
                for layer_id in old_stack:    # drop old stack references
                    self.layers.release_layer(layer_id)
            self.checkpoint_gen += 1

    def retain_config(self, config: LayerConfig) -> None:
        self.layers.retain_config(config)

    def release_config(self, config: LayerConfig) -> None:
        self.layers.release_config(config)

    def close(self) -> None:
        """Release this view's live-stack references (sandbox teardown).

        Frozen layers shared with siblings or retained configurations
        survive; the private upper (and any un-checkpointed writes in it)
        is freed.  Idempotent.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._inflight == 0:
                self._release_stack_locked()
            # else: the last in-flight op's _finish_op releases the stack

    # ------------------------------------------------------------- helpers
    def write_pytree(self, prefix: str, tree: Dict[str, np.ndarray]) -> int:
        dirtied = 0
        for name, arr in tree.items():
            dirtied += self.write(f"{prefix}/{name}", arr)
        return dirtied

    def layer_count(self) -> int:
        return self.layers.layer_count()

    def debug_validate(self) -> None:
        """Invariant check used by property tests: every referenced chunk is alive."""
        self.layers.debug_validate()


class DeltaFS(NamespaceView):
    """Layered copy-on-write tensor filesystem with O(1) checkpoint/rollback.

    The single-sandbox facade: a :class:`NamespaceView` over a (by default
    private) :class:`LayerStore`.  Pass ``layers=`` to mount a view over an
    existing store — that is how :class:`~repro.core.sandbox_tree.SandboxTree`
    materializes sibling sandboxes sharing every frozen layer.
    """

    def __init__(
        self,
        store: Optional[ChunkStore] = None,
        *,
        chunk_bytes: int = 64 * 1024,
        layers: Optional[LayerStore] = None,
        base_config: LayerConfig = (),
        tiers=None,
    ):
        if layers is None:
            layers = LayerStore(store, chunk_bytes=chunk_bytes, tiers=tiers)
        super().__init__(layers, base_config=base_config)
