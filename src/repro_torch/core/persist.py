"""Crash-consistent persistence plane for the whole DeltaState.

Ported from the JAX package's ``core/persist.py``.  The on-disk format is
that module's, byte for byte (manifest records, canonical JSON docs, chunk
packs, the digest index and the ``.npz`` archive), so a root written by
either package recovers in the other.  Three things differ, all on the
device side: ``recover`` takes ``device`` (the card unless the caller asks
for the CPU), rebuilds the generation-cache anchors there, and defaults
``restore_fn`` to a :class:`~repro_torch.core.deltacr.CowTensorState` on it;
and replay actions and extras may carry torch tensors, persisted as the
same ``__nd__`` records numpy arrays are (bfloat16 as ``"bfloat16"``, read
back as a bfloat16 tensor).

The in-memory chunk store is the paper's tmpfs; real restarts need the
durable tier.  Two APIs live here:

* **The lifecycle plane** (`save_state` / `recover` /
  :class:`PersistencePlane`): snapshots the *entire* DeltaState — the
  StateManager's snapshot tree (nodes, lineage, LW replay chains, fork
  pins), the refcounted :class:`~repro_torch.core.image_store.ImageStore` image
  set with its delta edges, the DeltaFS :class:`~repro_torch.core.deltafs.LayerStore`
  (layers + tombstones), the generation-cache anchors, and every chunk any
  of them references (written once; structural sharing and content digests
  are preserved bit-identically) — and rebuilds all of it after a restart.

  Crash consistency is manifest-based: each snapshot blob is written
  temp-file-first, fsynced, then atomically renamed; only *then* is a
  checksummed record appended (and fsynced) to the append-only ``MANIFEST``
  log.  ``recover`` replays the manifest and restores the newest record
  whose checksum, file, and file digest all verify — a torn append, a
  half-written blob, or a kill anywhere mid-`save` lands on the previous
  durable snapshot, never on a partial tree.

  In-flight dumps at snapshot time are resolved transactionally: a node
  whose durable image has not landed (and its descendants) is *cleanly
  absent* from the snapshot; everything included restores bit-identically
  (chunk digests and all).

* **The legacy layer archive** (`save_store` / `load_store`): the original
  DeltaFS-only ``.npz`` format, kept for the Trainer's cross-process
  restart (`Trainer.save_checkpoints` / `load_checkpoints`).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults
from .chunk_store import ChunkStore
from .deltacr import CowTensorState, DeltaCR, DumpImage, resolve_device
from .policy import DumpPolicy
from .deltafs import (
    DeltaFS,
    LayerConfig,
    LayerStore,
    TensorMeta,
    array_from_bytes,
    dtype_str,
    host_bytes,
)
from .state_manager import Sandbox, StateManager

__all__ = [
    "DigestIndex",
    "PersistencePlane",
    "RecoveredState",
    "RecoverError",
    "compact_state",
    "find_chunk_by_digest",
    "recover",
    "save_state",
    "save_store",
    "load_store",
]

_MAGIC = b"DBOXSNAP1\n"
_MANIFEST = "MANIFEST"
_SNAP_VERSION = 1                 # legacy: doc + inline chunk blob per snapshot
_SNAP_VERSION_V2 = 2              # O(delta): doc-only snaps + shared chunk packs
_PACK_MAGIC = b"DBOXPACK1\n"
_CHUNKS_DIR = "chunks"
_INDEX_NAME = "INDEX"
_CHUNK_DIGEST_BYTES = 16          # matches ChunkStore.DIGEST_BYTES
_SAVE_TAIL_BYTES = 256 << 10
_RECOVER_TAIL_BYTES = 256 << 10

# Observability for the bounded-manifest-read contract: bytes the most
# recent manifest parse actually read.  Regression tests assert recover()
# on a multi-MB manifest stays at the tail bound instead of re-reading the
# whole append-only history.
LAST_MANIFEST_BYTES_READ = 0


class RecoverError(RuntimeError):
    """No durable snapshot could be recovered from the manifest."""


# --------------------------------------------------------------------------
# canonical encoding helpers (byte-stable: save → recover → re-save equality)
# --------------------------------------------------------------------------
def _canon_json(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _line_digest(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


def _encode_obj(x: Any) -> Any:
    """JSON-encode arbitrary replay actions / extras deterministically.

    Supports None/bool/int/float/str, lists, tuples, str-keyed dicts, bytes,
    numpy arrays and torch tensors; tuples and binary payloads round-trip
    exactly.  A tensor is written as the ``__nd__`` record of a numpy array
    with the same bytes, its dtype named as numpy (and ``ml_dtypes``) name
    it, so either package reads it back."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return x
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, tuple):
        return {"__t__": [_encode_obj(v) for v in x]}
    if isinstance(x, list):
        return [_encode_obj(v) for v in x]
    if isinstance(x, (bytes, bytearray, memoryview)):
        return {"__b__": bytes(x).hex()}
    if isinstance(x, np.ndarray):
        arr = np.ascontiguousarray(x)
        return {
            "__nd__": {
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "data": arr.tobytes().hex(),
            }
        }
    if isinstance(x, torch.Tensor):
        return {
            "__nd__": {
                "dtype": dtype_str(x.dtype),
                "shape": list(x.shape),
                "data": host_bytes(x).tobytes().hex(),
            }
        }
    if isinstance(x, dict):
        return {"__d__": {str(k): _encode_obj(v) for k, v in x.items()}}
    raise TypeError(f"unpersistable object in snapshot: {type(x)!r}")


def _decode_obj(x: Any) -> Any:
    if isinstance(x, list):
        return [_decode_obj(v) for v in x]
    if isinstance(x, dict):
        if "__t__" in x and len(x) == 1:
            return tuple(_decode_obj(v) for v in x["__t__"])
        if "__b__" in x and len(x) == 1:
            return bytes.fromhex(x["__b__"])
        if "__nd__" in x and len(x) == 1:
            # numpy alone has no bfloat16: such a record comes back as a
            # bfloat16 tensor read from its 16-bit words (deltafs's rule)
            nd = x["__nd__"]
            shape = tuple(int(s) for s in nd["shape"])
            return array_from_bytes(bytes.fromhex(nd["data"]), shape, nd["dtype"])
        if "__d__" in x and len(x) == 1:
            return {k: _decode_obj(v) for k, v in x["__d__"].items()}
        return {k: _decode_obj(v) for k, v in x.items()}
    return x


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, data: bytes) -> None:
    """Temp-write + fsync + rename: the blob is durable-or-absent."""
    # fault seam before the temp write: an injected blob-I/O failure leaves
    # at worst an orphan .tmp, never a torn visible blob
    faults.fire("persist.blob_write")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


# --------------------------------------------------------------------------
# snapshot construction
# --------------------------------------------------------------------------
def _meta_doc(meta: TensorMeta, ref) -> Dict[str, Any]:
    """``ref(cid)`` maps a live chunk id to its persistent reference —
    dense blob index (v1) or persistent chunk id (v2)."""
    doc = {
        "shape": list(meta.shape),
        "dtype": meta.dtype,
        "chunks": [ref(cid) for cid in meta.chunk_ids],
        "digests": [d.hex() for d in meta.digests],
        "trailing_pad": meta.trailing_pad,
    }
    # Emitted only for shard-native (tiled) metadata so flat-layout
    # manifests stay byte-identical to what older readers expect.
    if meta.tile_grid:
        doc["tile_grid"] = list(meta.tile_grid)
    return doc


def _durable_nodes(tree: Dict[str, Any], deltacr: DeltaCR) -> Dict[int, Dict[str, Any]]:
    """Filter the tree snapshot to nodes that are durable *right now*.

    A node survives iff its parent survives and it is (a) a reclaimed
    tombstone, (b) a lightweight marker, or (c) a full checkpoint whose
    image has landed and is still registered.  Everything else — above all
    a node whose dump is still in flight — is cleanly absent, along with
    its subtree (FIFO dump order means descendants cannot have landed)."""
    kept: Dict[int, Dict[str, Any]] = {}
    for nd in sorted(tree["nodes"], key=lambda n: n["ckpt_id"]):
        cid = int(nd["ckpt_id"])
        parent = nd["parent_id"]
        if parent is not None and int(parent) not in kept:
            continue
        if nd["reclaimed"] or nd["lightweight"]:
            kept[cid] = nd
            continue
        if deltacr.images.is_live(cid) and deltacr.images.image_for(cid) is not None:
            kept[cid] = nd
    return kept


def _build_doc_core(
    sm: Optional[StateManager],
    deltacr: DeltaCR,
    extra: Optional[Dict[str, Any]],
    ref,
) -> Dict[str, Any]:
    """Build the format-independent snapshot body (layers/images/tree/
    anchors); chunk references are produced by ``ref(cid)``."""
    store = deltacr.store

    # ---- tree + layers (trunk StateManager, when present) ----------------
    tree_doc: Optional[Dict[str, Any]] = None
    layers_doc: List[Dict[str, Any]] = []
    layer_dense: Dict[int, int] = {}
    kept_full: Optional[set] = None
    if sm is not None:
        tree = sm.snapshot_tree()
        kept = _durable_nodes(tree, deltacr)
        kept_full = {
            cid
            for cid, nd in kept.items()
            if not nd["reclaimed"] and not nd["lightweight"]
        }
        layer_store: LayerStore = sm.sandbox.fs.layers
        layer_ids = sorted(
            {
                int(lid)
                for nd in kept.values()
                if nd["layer_config"] is not None
                for lid in nd["layer_config"]
            }
        )
        layer_dense = {lid: i for i, lid in enumerate(layer_ids)}
        for lid in layer_ids:
            layer = layer_store.get(lid)
            assert layer is not None, f"snapshot references dead layer {lid}"
            entries = {}
            for key in sorted(layer.entries):
                entries[key] = _meta_doc(layer.entries[key], ref)
            layers_doc.append(
                {
                    "id": layer_dense[lid],
                    "entries": entries,
                    "tombstones": sorted(layer.tombstones),
                }
            )
        # adjust current onto the nearest kept *restorable* ancestor (skip
        # excluded in-flight nodes and reclaimed tombstones); prune
        # pins/children
        by_id = {int(n["ckpt_id"]): n for n in tree["nodes"]}
        current = tree["current"]
        while current is not None and (
            int(current) not in kept or kept[int(current)]["reclaimed"]
        ):
            current = by_id[int(current)]["parent_id"]
        nodes_doc = []
        for cid in sorted(kept):
            nd = kept[cid]
            cfg = nd["layer_config"]
            nodes_doc.append(
                {
                    "ckpt_id": cid,
                    "parent_id": nd["parent_id"],
                    "layer_config": None if cfg is None else [layer_dense[int(l)] for l in cfg],
                    "lightweight": nd["lightweight"],
                    "replay_actions": [_encode_obj(a) for a in nd["replay_actions"]],
                    "children": [int(c) for c in nd["children"] if int(c) in kept],
                    "terminal": nd["terminal"],
                    "expandable": nd["expandable"],
                    "visits": nd["visits"],
                    "value": nd["value"],
                    "reclaimed": nd["reclaimed"],
                    "created_at": nd["created_at"],
                }
            )
        root = tree["root"]
        if root is not None and int(root) not in kept:
            root = None
        tree_doc = {
            "nodes": nodes_doc,
            "current": None if current is None else int(current),
            "root": root,
            "next_ckpt": tree["next_ckpt"],
            "pins": {k: v for k, v in tree["pins"].items() if int(k) in kept},
        }

    # ---- images (the refcounted lineage) ---------------------------------
    images_doc: List[Dict[str, Any]] = []
    saved_image_ids: set = set()
    for ckpt_id, image in deltacr.images.live_images():
        if kept_full is not None and ckpt_id not in kept_full:
            continue
        entries = {}
        for key in sorted(image.entries):
            entries[key] = _meta_doc(image.entries[key], ref)
        saved_image_ids.add(image.image_id)
        images_doc.append(
            {
                "ckpt": ckpt_id,
                "image_id": image.image_id,
                "parent_id": image.parent_id,
                "entries": entries,
                "dirtied_chunks": image.dirtied_chunks,
                "dump_bytes": image.dump_bytes,
                "wall_ms": image.wall_ms,
                "mode": image.mode,
                "streamed": image.streamed,
                "stream_windows": image.stream_windows,
                "stream_window_bytes": image.stream_window_bytes,
                "encode_ms": image.encode_ms,
                "drain_ms": image.drain_ms,
                "commit_ms": image.commit_ms,
            }
        )

    # ---- generation-cache anchors ---------------------------------------
    anchors: List[int] = []
    if deltacr.pipeline is not None:
        anchors = [i for i in deltacr.pipeline.anchored_ids() if i in saved_image_ids]

    return {
        "chunk_bytes": store.chunk_bytes,
        "dedupe": store.dedupe,
        "layers": layers_doc,
        "images": images_doc,
        "next_image_id": deltacr.images.next_image_id(),
        "tree": tree_doc,
        "anchors": anchors,
        "extra": _encode_obj(extra if extra is not None else {}),
    }


def _snapshot_doc(
    sm: Optional[StateManager],
    deltacr: DeltaCR,
    extra: Optional[Dict[str, Any]],
) -> Tuple[Dict[str, Any], bytes]:
    """Build the legacy (v1) snapshot document + inline chunk blob."""
    store = deltacr.store
    chunk_index: Dict[int, int] = {}
    chunk_order: List[int] = []

    def ref(cid: int) -> int:
        dense = chunk_index.get(cid)
        if dense is None:
            dense = chunk_index[cid] = len(chunk_order)
            chunk_order.append(cid)
        return dense

    core = _build_doc_core(sm, deltacr, extra, ref)
    blobs = [store.get(cid) for cid in chunk_order]
    offsets = [0]
    for b in blobs:
        offsets.append(offsets[-1] + len(b))
    blob = b"".join(blobs)

    doc = {
        "version": _SNAP_VERSION,
        "kind": "deltastate",
        "chunk_offsets": offsets,
        "chunk_pads": [store.pad_of(cid) for cid in chunk_order],
        **core,
    }
    return doc, blob


def _snapshot_doc_v2(
    sm: Optional[StateManager],
    deltacr: DeltaCR,
    extra: Optional[Dict[str, Any]],
    index: "DigestIndex",
) -> Tuple[Dict[str, Any], List[Dict[str, Any]], List[bytes]]:
    """Build the v2 (pack-backed) full snapshot document.

    Chunk references are *persistent chunk ids* (pcids) assigned by the
    root's digest index: a chunk whose (digest, pad) is already durable
    reuses its pcid and writes zero bytes; only genuinely-new chunks are
    staged for the save's pack.  Returns ``(doc, staged_index_entries,
    staged_payloads)`` — the caller writes the pack, fills the entries'
    pack/offset fields, and commits them to the index."""
    store = deltacr.store
    assigned: Dict[int, int] = {}            # live cid -> pcid
    pending: Dict[Tuple[str, int], Dict[str, Any]] = {}
    staged_entries: List[Dict[str, Any]] = []
    staged_payloads: List[bytes] = []
    table: Dict[int, List[Any]] = {}         # pcid -> [pcid, digest_hex, pad, size]
    offset = 0

    def ref(cid: int) -> int:
        pcid = assigned.get(cid)
        if pcid is not None:
            return pcid
        data = store.get(cid)
        digest = store.digest_of(cid)
        if digest is None:
            digest = hashlib.blake2b(data, digest_size=_CHUNK_DIGEST_BYTES).digest()
        pad = store.pad_of(cid)
        key = (digest.hex(), pad)
        ent = index.lookup(*key) or pending.get(key)
        if ent is None:
            nonlocal offset
            ent = {
                "p": index.next_pcid + len(staged_entries),
                "d": key[0],
                "pad": pad,
                "s": len(data),
                "f": None,                   # filled in once the pack is named
                "o": offset,
            }
            offset += len(data)
            pending[key] = ent
            staged_entries.append(ent)
            staged_payloads.append(data)
        pcid = int(ent["p"])
        assigned[cid] = pcid
        table[pcid] = [pcid, ent["d"], int(ent["pad"]), int(ent["s"])]
        return pcid

    core = _build_doc_core(sm, deltacr, extra, ref)
    doc = {
        "version": _SNAP_VERSION_V2,
        "kind": "deltastate-full",
        "chunks": [table[p] for p in sorted(table)],
        **core,
    }
    return doc, staged_entries, staged_payloads


def _snapshot_bytes(doc: Dict[str, Any], blob: bytes) -> bytes:
    payload = _canon_json(doc)
    return _MAGIC + struct.pack("<Q", len(payload)) + payload + blob


# --------------------------------------------------------------------------
# chunk packs + digest index (v2 durable chunk storage)
# --------------------------------------------------------------------------
_PACK_RE = re.compile(r"^pack-(\d{8})\.blob$")


def _chunks_dir(root: str) -> str:
    return os.path.join(root, _CHUNKS_DIR)


def _list_packs(root: str) -> List[str]:
    d = _chunks_dir(root)
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if _PACK_RE.match(f))


def _next_pack_name(root: str) -> str:
    """Never reuse a pack name: a save whose manifest append failed leaves
    an orphan pack the index may already reference — overwriting it would
    silently corrupt every deduped reference into it."""
    existing = _list_packs(root)
    seq = 1 + max((int(_PACK_RE.match(f).group(1)) for f in existing), default=0)
    while os.path.exists(os.path.join(_chunks_dir(root), f"pack-{seq:08d}.blob")):
        seq += 1
    return f"pack-{seq:08d}.blob"


def _write_pack(
    root: str, entries: List[Dict[str, Any]], payloads: List[bytes]
) -> Tuple[str, int, str]:
    """Write one chunk pack (payloads + self-describing footer), durable-or-
    absent.  The footer lets the digest index be rebuilt from packs alone.
    Returns (pack filename, pack bytes, pack blake2b)."""
    faults.fire("persist.pack_write")
    fname = _next_pack_name(root)
    for ent in entries:
        ent["f"] = fname
    footer = _canon_json(
        {"chunks": [[int(e["p"]), e["d"], int(e["pad"]), int(e["s"])] for e in entries]}
    )
    data = b"".join(payloads) + footer + struct.pack("<Q", len(footer)) + _PACK_MAGIC
    _write_atomic(os.path.join(_chunks_dir(root), fname), data)
    return fname, len(data), hashlib.blake2b(data, digest_size=16).hexdigest()


def _read_pack_footer(path: str) -> Optional[List[List[Any]]]:
    """Parse a pack's footer; None if the file is torn/corrupt."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            tail_len = len(_PACK_MAGIC) + 8
            if size < tail_len:
                return None
            f.seek(size - tail_len)
            tail = f.read(tail_len)
            if tail[8:] != _PACK_MAGIC:
                return None
            (flen,) = struct.unpack("<Q", tail[:8])
            if flen > size - tail_len:
                return None
            f.seek(size - tail_len - flen)
            footer = json.loads(f.read(flen).decode())
        rows = footer.get("chunks")
        if not isinstance(rows, list):
            return None
        return rows
    except (OSError, ValueError, struct.error):
        return None


def _read_pack_chunk(root: str, fname: str, offset: int, size: int) -> Optional[bytes]:
    try:
        with open(os.path.join(_chunks_dir(root), fname), "rb") as f:
            f.seek(offset)
            data = f.read(size)
        return data if len(data) == size else None
    except OSError:
        return None


class DigestIndex:
    """Persistent digest → (pack, offset) sidecar index for a root.

    One checksummed line per durable chunk (same framing as the MANIFEST,
    torn tails drop harmlessly) plus ``{"n": next_pcid}`` watermark records
    keeping pcid assignment monotonic across retention rewrites.  The index
    is a cache over the packs' self-describing footers: if it is missing or
    doesn't cover a referenced pcid, it is rebuilt from the packs."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(_chunks_dir(root), _INDEX_NAME)
        self.by_key: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self.by_pcid: Dict[int, Dict[str, Any]] = {}
        self.next_pcid = 0

    @classmethod
    def load(cls, root: str) -> "DigestIndex":
        idx = cls(root)
        if os.path.exists(idx.path):
            try:
                with open(idx.path, "rb") as f:
                    raw = f.read()
            except OSError:
                raw = b""
            for rec in _parse_manifest(raw):
                idx._ingest(rec)
        return idx

    def _ingest(self, rec: Dict[str, Any]) -> None:
        if "n" in rec:
            self.next_pcid = max(self.next_pcid, int(rec["n"]))
            return
        try:
            ent = {
                "p": int(rec["p"]),
                "d": str(rec["d"]),
                "pad": int(rec["pad"]),
                "s": int(rec["s"]),
                "f": str(rec["f"]),
                "o": int(rec["o"]),
            }
        except (KeyError, TypeError, ValueError):
            return
        self.by_pcid[ent["p"]] = ent
        self.by_key[(ent["d"], ent["pad"])] = ent
        self.next_pcid = max(self.next_pcid, ent["p"] + 1)

    def lookup(self, digest_hex: str, pad: int) -> Optional[Dict[str, Any]]:
        return self.by_key.get((digest_hex, pad))

    def covers(self, pcids) -> bool:
        return all(p in self.by_pcid for p in pcids)

    def append(self, entries: List[Dict[str, Any]]) -> None:
        """Durably append new chunk records (+ the advanced watermark).
        Runs *after* the pack rename and *before* the manifest append: every
        index entry points at real bytes, and a crash here leaves at worst
        dedupe-able orphans the next GC sweeps."""
        if not entries:
            return
        faults.fire("persist.index_write")
        os.makedirs(_chunks_dir(self.root), exist_ok=True)
        lines = []
        for ent in entries:
            payload = _canon_json(ent)
            lines.append(payload + b"\t" + _line_digest(payload).encode() + b"\n")
        watermark = max(int(e["p"]) for e in entries) + 1
        payload = _canon_json({"n": watermark})
        lines.append(payload + b"\t" + _line_digest(payload).encode() + b"\n")
        with open(self.path, "ab") as f:
            if f.tell() > 0:
                with open(self.path, "rb") as r:
                    r.seek(-1, os.SEEK_END)
                    if r.read(1) != b"\n":
                        f.write(b"\n")
            f.write(b"".join(lines))
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(_chunks_dir(self.root))
        for ent in entries:
            self._ingest(ent)
        self.next_pcid = max(self.next_pcid, watermark)

    def rewrite(self) -> None:
        """Atomically rewrite the whole index (retention / compaction /
        rebuild); the old file stays valid until the rename."""
        faults.fire("persist.index_write")
        os.makedirs(_chunks_dir(self.root), exist_ok=True)
        lines = []
        for pcid in sorted(self.by_pcid):
            payload = _canon_json(self.by_pcid[pcid])
            lines.append(payload + b"\t" + _line_digest(payload).encode() + b"\n")
        payload = _canon_json({"n": self.next_pcid})
        lines.append(payload + b"\t" + _line_digest(payload).encode() + b"\n")
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(lines))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(_chunks_dir(self.root))

    def rebuild_from_packs(self) -> None:
        """Reconstruct from pack footers (newest pack wins a duplicate key,
        matching sweep semantics where live chunks move to newer packs)."""
        self.by_key.clear()
        self.by_pcid.clear()
        watermark = self.next_pcid
        for fname in _list_packs(self.root):
            rows = _read_pack_footer(os.path.join(_chunks_dir(self.root), fname))
            if rows is None:
                continue
            offset = 0
            for row in rows:
                try:
                    pcid, digest_hex, pad, size = int(row[0]), str(row[1]), int(row[2]), int(row[3])
                except (TypeError, ValueError, IndexError):
                    break
                self._ingest(
                    {"p": pcid, "d": digest_hex, "pad": pad, "s": size, "f": fname, "o": offset}
                )
                offset += size
        self.next_pcid = max(self.next_pcid, watermark)
        self.rewrite()

    def drop_packs(self, dead: set) -> None:
        for pcid in [p for p, e in self.by_pcid.items() if e["f"] in dead]:
            ent = self.by_pcid.pop(pcid)
            cur = self.by_key.get((ent["d"], ent["pad"]))
            if cur is ent:
                del self.by_key[(ent["d"], ent["pad"])]


# --------------------------------------------------------------------------
# delta-chain documents: diff + fold
# --------------------------------------------------------------------------
def _diff_docs(prev: Dict[str, Any], full: Dict[str, Any]) -> Dict[str, Any]:
    """Diff two folded v2 full docs into a delta doc.

    Sections are keyed (layers by dense id, images by ckpt, tree nodes by
    ckpt_id); an unchanged value contributes nothing.  The chunk table
    carries every pcid row absent from the previous folded table — newly
    packed or re-surfacing from an older snapshot — so a fold never needs
    any doc outside its own chain."""
    delta: Dict[str, Any] = {
        "version": _SNAP_VERSION_V2,
        "kind": "deltastate-delta",
        "chunk_bytes": full["chunk_bytes"],
        "dedupe": full["dedupe"],
        "next_image_id": full["next_image_id"],
        "anchors": full["anchors"],
        "extra": full["extra"],
    }
    prev_layers = {int(l["id"]): l for l in prev["layers"]}
    new_layers = {int(l["id"]): l for l in full["layers"]}
    delta["layers_upsert"] = [
        new_layers[i] for i in sorted(new_layers) if prev_layers.get(i) != new_layers[i]
    ]
    delta["layers_drop"] = sorted(i for i in prev_layers if i not in new_layers)
    prev_images = {int(im["ckpt"]): im for im in prev["images"]}
    new_images = {int(im["ckpt"]): im for im in full["images"]}
    delta["images_upsert"] = [
        new_images[c] for c in sorted(new_images) if prev_images.get(c) != new_images[c]
    ]
    delta["images_drop"] = sorted(c for c in prev_images if c not in new_images)
    if full["tree"] is None:
        delta["tree"] = None
    else:
        prev_nodes = (
            {int(n["ckpt_id"]): n for n in prev["tree"]["nodes"]}
            if prev.get("tree") is not None
            else {}
        )
        new_nodes = {int(n["ckpt_id"]): n for n in full["tree"]["nodes"]}
        delta["tree"] = {
            "nodes_upsert": [
                new_nodes[i] for i in sorted(new_nodes) if prev_nodes.get(i) != new_nodes[i]
            ],
            "nodes_drop": sorted(i for i in prev_nodes if i not in new_nodes),
            "current": full["tree"]["current"],
            "root": full["tree"]["root"],
            "next_ckpt": full["tree"]["next_ckpt"],
            "pins": full["tree"]["pins"],
        }
    prev_pcids = {int(row[0]) for row in prev["chunks"]}
    delta["chunks"] = [row for row in full["chunks"] if int(row[0]) not in prev_pcids]
    return delta


def _fold_delta(base: Dict[str, Any], delta: Dict[str, Any]) -> Dict[str, Any]:
    """Fold one delta doc onto a folded full doc, reproducing *exactly* the
    full doc `_snapshot_doc_v2` would have built for the same state (section
    orderings included) — diffing and byte-identity both depend on it."""
    layers = {int(l["id"]): l for l in base["layers"]}
    for l in delta["layers_upsert"]:
        layers[int(l["id"])] = l
    for i in delta["layers_drop"]:
        layers.pop(int(i), None)
    images = {int(im["ckpt"]): im for im in base["images"]}
    for im in delta["images_upsert"]:
        images[int(im["ckpt"])] = im
    for c in delta["images_drop"]:
        images.pop(int(c), None)
    if delta["tree"] is None:
        tree = None
    else:
        nodes = (
            {int(n["ckpt_id"]): n for n in base["tree"]["nodes"]}
            if base.get("tree") is not None
            else {}
        )
        for n in delta["tree"]["nodes_upsert"]:
            nodes[int(n["ckpt_id"])] = n
        for i in delta["tree"]["nodes_drop"]:
            nodes.pop(int(i), None)
        tree = {
            "nodes": [nodes[i] for i in sorted(nodes)],
            "current": delta["tree"]["current"],
            "root": delta["tree"]["root"],
            "next_ckpt": delta["tree"]["next_ckpt"],
            "pins": delta["tree"]["pins"],
        }
    table = {int(row[0]): row for row in base["chunks"]}
    for row in delta["chunks"]:
        table[int(row[0])] = row
    referenced: set = set()
    for layer in layers.values():
        for ent in layer["entries"].values():
            referenced.update(int(p) for p in ent["chunks"])
    for image in images.values():
        for ent in image["entries"].values():
            referenced.update(int(p) for p in ent["chunks"])
    return {
        "version": _SNAP_VERSION_V2,
        "kind": "deltastate-full",
        "chunks": [table[p] for p in sorted(referenced)],
        "chunk_bytes": delta["chunk_bytes"],
        "dedupe": delta["dedupe"],
        "layers": [layers[i] for i in sorted(layers)],
        "images": sorted(images.values(), key=lambda im: int(im["image_id"])),
        "next_image_id": delta["next_image_id"],
        "tree": tree,
        "anchors": delta["anchors"],
        "extra": delta["extra"],
    }


# --------------------------------------------------------------------------
# manifest log
# --------------------------------------------------------------------------
def _manifest_path(root: str) -> str:
    return os.path.join(root, _MANIFEST)


def _parse_manifest(raw: bytes) -> List[Dict[str, Any]]:
    """Parse manifest bytes, silently dropping torn/corrupt records."""
    entries: List[Dict[str, Any]] = []
    for line in raw.split(b"\n"):
        if not line:
            continue
        head, sep, digest = line.rpartition(b"\t")
        if not sep:
            continue
        if _line_digest(head) != digest.decode("ascii", "replace"):
            continue  # torn append: ignore this and any trailing garbage
        try:
            entries.append(json.loads(head.decode()))
        except ValueError:
            continue
    return entries


def _read_manifest(root: str) -> List[Dict[str, Any]]:
    global LAST_MANIFEST_BYTES_READ
    path = _manifest_path(root)
    if not os.path.exists(path):
        LAST_MANIFEST_BYTES_READ = 0
        return []
    with open(path, "rb") as f:
        raw = f.read()
    LAST_MANIFEST_BYTES_READ = len(raw)
    return _parse_manifest(raw)


def _read_manifest_tail(root: str, max_bytes: int = 256 << 10) -> List[Dict[str, Any]]:
    """Recent manifest entries only: the save and recover paths need the
    newest entries (last seq / newest chain), so they read a bounded tail
    instead of re-checksumming the whole append-only history.  A partial
    first line (mid-record seek) fails its checksum and is dropped."""
    global LAST_MANIFEST_BYTES_READ
    path = _manifest_path(root)
    if not os.path.exists(path):
        LAST_MANIFEST_BYTES_READ = 0
        return []
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - max_bytes))
        raw = f.read()
    LAST_MANIFEST_BYTES_READ = len(raw)
    return _parse_manifest(raw)


def _manifest_tail_was_complete(root: str) -> bool:
    """Whether the last tail read covered the whole manifest file (so a
    full re-read could not surface anything new)."""
    path = _manifest_path(root)
    try:
        return os.path.getsize(path) <= LAST_MANIFEST_BYTES_READ
    except OSError:
        return True


def _append_manifest(root: str, record: Dict[str, Any]) -> None:
    # fault seam before the append: a failed save leaves the snapshot blob
    # orphaned but unreferenced — recovery ignores it (checksummed manifest
    # is the source of truth), so the previous durable snapshot still wins
    faults.fire("persist.manifest_append")
    payload = _canon_json(record)
    line = payload + b"\t" + _line_digest(payload).encode() + b"\n"
    path = _manifest_path(root)
    with open(path, "ab") as f:
        # a crash mid-append can leave a torn, newline-less tail; never let
        # this record merge into it (the merged line would fail its checksum
        # and a save reported as durable would silently not be)
        if f.tell() > 0:
            with open(path, "rb") as r:
                r.seek(-1, os.SEEK_END)
                torn = r.read(1) != b"\n"
            if torn:
                f.write(b"\n")
        f.write(line)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(root)


def _verify_entry(root: str, entry: Dict[str, Any]) -> bool:
    path = os.path.join(root, entry["file"])
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    if len(data) != int(entry["bytes"]):
        return False
    return hashlib.blake2b(data, digest_size=16).hexdigest() == entry["blake2b"]


# --------------------------------------------------------------------------
# delta chains over the manifest
# --------------------------------------------------------------------------
def _entry_base(entry: Dict[str, Any]) -> int:
    return int(entry.get("base", entry["seq"]))


def _chain_entries(
    entries: List[Dict[str, Any]], head: Dict[str, Any]
) -> Optional[List[Dict[str, Any]]]:
    """The manifest entries whose docs fold to ``head``: its base full
    snapshot plus every delta between, in seq order.  None if the base or
    an intermediate link is missing from ``entries`` (e.g. a bounded tail
    read cut the chain — the caller re-reads the full manifest)."""
    if entry_fmt(head) < 2:
        return [head]
    if head.get("kind", "full") == "full":
        return [head]
    base_seq = _entry_base(head)
    by_seq = {int(e["seq"]): e for e in entries}
    chain: List[Dict[str, Any]] = []
    base = by_seq.get(base_seq)
    if base is None or base.get("kind", "full") != "full" or entry_fmt(base) < 2:
        return None
    chain.append(base)
    for seq in range(base_seq + 1, int(head["seq"]) + 1):
        link = by_seq.get(seq)
        if link is None or link.get("kind") != "delta" or _entry_base(link) != base_seq:
            return None
        chain.append(link)
    return chain


def entry_fmt(entry: Dict[str, Any]) -> int:
    return int(entry.get("fmt", 1))


def _load_doc(root: str, entry: Dict[str, Any]) -> Tuple[Dict[str, Any], bytes]:
    return _load_snapshot(os.path.join(root, entry["file"]))


def _fold_chain(
    root: str, entries: List[Dict[str, Any]], head: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Verify + load + fold ``head``'s chain into one full v2 doc.
    None when any link fails verification (torn/corrupt/missing)."""
    chain = _chain_entries(entries, head)
    if chain is None:
        return None
    folded: Optional[Dict[str, Any]] = None
    for link in chain:
        if not _verify_entry(root, link):
            return None
        try:
            doc, _ = _load_doc(root, link)
        except (OSError, RecoverError, ValueError):
            return None
        if link is chain[0]:
            if doc.get("kind") != "deltastate-full":
                return None
            folded = doc
        else:
            if doc.get("kind") != "deltastate-delta" or folded is None:
                return None
            folded = _fold_delta(folded, doc)
    return folded


def _chain_closure(
    entries: List[Dict[str, Any]], heads: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """All entries any of ``heads`` needs to fold (bases + intermediate
    deltas), deduped, in seq order.  Unresolvable chains contribute the
    head alone."""
    out: Dict[int, Dict[str, Any]] = {}
    for head in heads:
        chain = _chain_entries(entries, head) or [head]
        for link in chain:
            out[int(link["seq"])] = link
    return [out[s] for s in sorted(out)]


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------
def save_state(
    root: str,
    *,
    sm: Optional[StateManager] = None,
    deltacr: Optional[DeltaCR] = None,
    extra: Optional[Dict[str, Any]] = None,
    keep_snapshots: int = 4,
    mode: str = "auto",
    full_every: int = 8,
    fmt: int = 2,
    stats_out: Optional[Dict[str, Any]] = None,
    _cache: Optional[Dict[str, Any]] = None,
) -> int:
    """Commit one crash-consistent snapshot of the DeltaState; returns seq.

    ``sm`` snapshots the whole lifecycle plane (tree + layers + images +
    anchors); ``deltacr`` alone snapshots the image store only (the serving
    scheduler's warm-pool case).  ``extra`` rides along verbatim (JSON-able
    plus tuples/bytes/ndarrays).  Uncommitted live-upper writes and
    in-flight dumps are *not* captured — crash semantics are "back to the
    last durable checkpoint", never a partial tree.

    Saves are **O(delta)**: chunk bytes dedupe against the root's digest
    index (only never-before-seen chunks land in this save's pack), and
    with ``mode="auto"`` the snapshot document itself is a delta against
    the previous save, with a full anchor every ``full_every`` saves so
    recovery folds a bounded chain.  ``mode="full"`` forces a full-doc
    anchor; ``mode="delta"`` forces a delta when a foldable predecessor
    exists.  ``fmt=1`` writes the legacy self-contained v1 snapshot (for
    migration tests and old readers).

    Durability ordering: pack (atomic rename) → digest index (fsync'd
    append) → snapshot doc (atomic rename) → manifest append (the commit
    point).  A kill between any two steps leaves at worst orphans the next
    full save / compaction garbage-collects; the previous durable snapshot
    stays recoverable throughout.

    ``stats_out`` (when given) is filled with what the save actually wrote;
    ``_cache`` is the :class:`PersistencePlane` accelerator (previous folded
    doc + digest index) — callers without one pay a bounded chain re-read."""
    if sm is None and deltacr is None:
        raise ValueError("save_state needs sm= or deltacr=")
    cr = deltacr if deltacr is not None else sm.deltacr  # type: ignore[union-attr]
    os.makedirs(root, exist_ok=True)
    entries = _read_manifest_tail(root, max_bytes=_SAVE_TAIL_BYTES)
    seq = (max((int(e["seq"]) for e in entries), default=0)) + 1
    fname = f"snap-{seq:08d}.dbox"

    if fmt == 1:
        doc, blob = _snapshot_doc(sm, cr, extra)
        data = _snapshot_bytes(doc, blob)
        _write_atomic(os.path.join(root, fname), data)
        _append_manifest(
            root,
            {
                "seq": seq,
                "file": fname,
                "bytes": len(data),
                "blake2b": hashlib.blake2b(data, digest_size=16).hexdigest(),
            },
        )
        live_v1 = (
            {e["file"] for e in entries[-(keep_snapshots - 1):]}
            if keep_snapshots > 1
            else set()
        )
        live_v1.add(fname)
        _prune_snapshots(root, entries, live_v1, keep_snapshots)
        if stats_out is not None:
            stats_out.update(
                {"seq": seq, "kind": "full", "fmt": 1, "chain": 0,
                 "doc_bytes": len(data), "pack_bytes": 0, "new_chunks": 0,
                 "bytes_written": len(data)}
            )
        return seq

    os.makedirs(_chunks_dir(root), exist_ok=True)
    cache_ok = (
        _cache is not None
        and _cache.get("root") == root
        and _cache.get("index") is not None
    )
    index: DigestIndex = _cache["index"] if cache_ok else DigestIndex.load(root)
    full_doc, staged_entries, staged_payloads = _snapshot_doc_v2(sm, cr, extra, index)

    # ---- kind decision: delta against the previous save, full anchor
    # every `full_every` saves (or when no foldable v2 predecessor exists)
    kind, chain, base_seq = "full", 0, seq
    prev_doc: Optional[Dict[str, Any]] = None
    prev_entry = entries[-1] if entries else None
    if (
        mode != "full"
        and full_every > 1
        and prev_entry is not None
        and entry_fmt(prev_entry) >= 2
    ):
        prev_chain = int(prev_entry.get("chain", 0))
        if mode == "delta" or prev_chain + 1 < full_every:
            if cache_ok and _cache.get("seq") == int(prev_entry["seq"]):
                prev_doc = _cache.get("doc")
            if prev_doc is None:
                prev_doc = _fold_chain(root, entries, prev_entry)
            if prev_doc is not None:
                kind = "delta"
                chain = prev_chain + 1
                base_seq = _entry_base(prev_entry)
    doc_to_write = full_doc if kind == "full" else _diff_docs(prev_doc, full_doc)

    # ---- commit sequence: pack → index → doc → manifest ------------------
    pack_name: Optional[str] = None
    pack_bytes = 0
    pack_digest = ""
    if staged_payloads:
        pack_name, pack_bytes, pack_digest = _write_pack(root, staged_entries, staged_payloads)
        index.append(staged_entries)
    data = _snapshot_bytes(doc_to_write, b"")
    _write_atomic(os.path.join(root, fname), data)
    record = {
        "seq": seq,
        "file": fname,
        "bytes": len(data),
        "blake2b": hashlib.blake2b(data, digest_size=16).hexdigest(),
        "fmt": _SNAP_VERSION_V2,
        "kind": kind,
        "base": base_seq,
        "chain": chain,
        "pack": pack_name,
        "pack_bytes": pack_bytes,
        "pack_blake2b": pack_digest,
    }
    _append_manifest(root, record)

    # ---- retention: prune snap docs beyond keep + chain closure ----------
    all_entries = entries + [record]
    keep_files = _retained_files(all_entries, keep_snapshots)
    _prune_snapshots(root, entries, keep_files, keep_snapshots)
    # pack GC only on full anchors: delta saves stay strictly O(delta)
    if kind == "full":
        _gc_packs(root, index)

    if _cache is not None:
        _cache.update({"root": root, "seq": seq, "doc": full_doc, "index": index})
    if stats_out is not None:
        stats_out.update(
            {
                "seq": seq,
                "kind": kind,
                "fmt": 2,
                "chain": chain,
                "doc_bytes": len(data),
                "pack_bytes": pack_bytes,
                "new_chunks": len(staged_payloads),
                "bytes_written": len(data) + pack_bytes,
            }
        )
    return seq


def _retained_files(entries: List[Dict[str, Any]], keep_snapshots: int) -> set:
    """Snapshot files retention must keep: the newest ``keep_snapshots``
    entries plus everything their delta chains fold from."""
    keep = max(1, int(keep_snapshots))
    heads = entries[-keep:]
    return {e["file"] for e in _chain_closure(entries, heads)}


def _prune_snapshots(
    root: str,
    prior_entries: List[Dict[str, Any]],
    keep_files,
    keep_snapshots: int,
) -> None:
    """Unlink superseded snapshot files (the manifest itself stays
    append-only between compactions).  Only a bounded recent window is
    scanned — older files were unlinked by previous saves — so per-save
    work stays O(keep + chain), not O(history)."""
    live = set(keep_files)
    window = prior_entries[-(2 * (int(keep_snapshots) + 16) + 8):]
    for e in window:
        if e["file"] not in live:
            try:
                os.unlink(os.path.join(root, e["file"]))
            except OSError:
                pass


def _gc_packs(root: str, index: DigestIndex) -> None:
    """Reclaim unreferenced chunk bytes: a pack none of whose pcids is
    referenced by any on-disk snapshot doc is deleted and dropped from the
    index.  Liveness is the union of the chunk tables of every retained v2
    doc — delta docs re-list any pcid their fold introduces, so the union
    over a chain covers exactly its folded reference set."""
    live_pcids = _live_pcids(root)
    by_pack: Dict[str, int] = {}
    for ent in index.by_pcid.values():
        by_pack.setdefault(ent["f"], 0)
    for pcid in live_pcids:
        ent = index.by_pcid.get(pcid)
        if ent is not None:
            by_pack[ent["f"]] = by_pack.get(ent["f"], 0) + 1
    dead = {f for f, live in by_pack.items() if live == 0}
    # packs the index doesn't know at all (sweep leftovers) are dead too
    for fname in _list_packs(root):
        if fname not in by_pack:
            dead.add(fname)
    if not dead:
        return
    index.drop_packs(dead)
    index.rewrite()
    for fname in dead:
        try:
            os.unlink(os.path.join(_chunks_dir(root), fname))
        except OSError:
            pass


def _live_pcids(root: str) -> set:
    """Union of every on-disk v2 snapshot doc's chunk table."""
    live: set = set()
    for fname in sorted(os.listdir(root)):
        if not (fname.startswith("snap-") and fname.endswith(".dbox")):
            continue
        try:
            doc, _ = _load_snapshot(os.path.join(root, fname))
        except (OSError, RecoverError, ValueError):
            continue
        if int(doc.get("version", 1)) < _SNAP_VERSION_V2:
            continue
        for row in doc.get("chunks", []):
            live.add(int(row[0]))
    return live


# --------------------------------------------------------------------------
# recover
# --------------------------------------------------------------------------
@dataclass
class RecoveredState:
    """Everything `recover` rebuilt from the last durable snapshot."""

    seq: int
    fs: DeltaFS                       # trunk namespace view over the layers
    layer_store: LayerStore
    deltacr: DeltaCR
    state_manager: Optional[StateManager]
    current: Optional[int]            # checkpoint the pre-crash session was at
    # Fork pins recovered into the StateManager.  They record which bases
    # the pre-crash forked sandboxes descended from; those sandboxes are
    # process-local and did not survive, so a caller that does not rebuild
    # forked work over these bases should call
    # ``state_manager.release_recovered_pins()`` to make the nodes
    # GC-reclaimable again.
    recovered_pins: Dict[int, int]
    extra: Dict[str, Any]
    snapshot_path: str
    # How the trunk session was brought back to ``current``:
    #   "fast"/"slow"[+"+replay"] — auto-restored; the sandbox proc is live
    #   "skipped-needs-applier"   — current sits atop an LW replay chain and
    #                               no ``action_applier`` was supplied
    #   "disabled"                — caller passed auto_restore=False
    #   None                      — nothing to restore (no tree / no current)
    trunk_restore_mode: Optional[str] = None


def _load_snapshot(path: str) -> Tuple[Dict[str, Any], bytes]:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise RecoverError(f"{path}: bad snapshot magic")
    off = len(_MAGIC)
    (plen,) = struct.unpack_from("<Q", data, off)
    off += 8
    doc = json.loads(data[off : off + plen].decode())
    blob = data[off + plen :]
    return doc, blob


def recover(
    root: str,
    *,
    restore_fn=None,
    template_pool_size: int = 8,
    stream: bool = True,
    policy=None,
    auto_restore: bool = True,
    action_applier=None,
    device=None,
) -> RecoveredState:
    """Rebuild the full DeltaState from the newest durable snapshot.

    Walks the manifest newest-first, skipping any record whose checksum,
    blob, or blob digest fails to verify (a crash mid-`save` therefore
    recovers the previous snapshot).  Rebuilds, in order: the chunk store
    (bit-identical bytes, pads and digests), the LayerStore and every
    frozen layer, the ImageStore lineage (restores and child dumps see the
    recovered images exactly like local ones), the snapshot tree with its
    pins, and the generation-cache anchors — so the first post-restart
    dumps are already O(delta)-chained.

    ``restore_fn`` rebuilds session state from an image payload; it
    defaults to a `CowTensorState` on ``device``.  ``device`` (the card
    unless the caller asks for the CPU; without a card the call raises) is
    where the generation-cache anchors are rebuilt: there, the first
    restore after the restart scatters with ``delta_apply`` and the first
    dump diffs with the delta kernels.

    With ``auto_restore`` (the default) the trunk sandbox is restored onto
    ``current`` before this returns — the recovered StateManager's proc is
    live and immediately checkpointable/decodable, no hand-rolled
    ``sm.restore(rec.current)`` needed.  ``action_applier`` (stored on the
    StateManager either way) replays lightweight chains; when ``current``
    needs an LW replay and no applier was given, the restore is *skipped*
    (``trunk_restore_mode == "skipped-needs-applier"``) rather than raising
    — the tree is intact, the caller restores manually after wiring one.

    v2 snapshots (delta chains over shared chunk packs) and legacy v1
    snapshots (self-contained blob per save) recover through the same door:
    a v2 candidate's chain is folded onto its full anchor and its chunks
    are read digest-verified out of the packs via the persistent digest
    index (rebuilt from pack footers when missing or stale).  Any failure
    — corrupt doc, truncated chain, rotten pack bytes — falls back to the
    next older durable candidate.  The manifest is read as a bounded tail;
    the full history is parsed only if the tail holds no recoverable
    candidate."""
    dev = resolve_device(device)
    entries = _read_manifest_tail(root, max_bytes=_RECOVER_TAIL_BYTES)
    tail_complete = _manifest_tail_was_complete(root)
    build_kw = dict(
        restore_fn=restore_fn,
        template_pool_size=template_pool_size,
        stream=stream,
        policy=policy,
        auto_restore=auto_restore,
        action_applier=action_applier,
        device=dev,
    )
    result = _recover_from_entries(root, entries, **build_kw)
    if result is None and not tail_complete:
        entries = _read_manifest(root)
        result = _recover_from_entries(root, entries, **build_kw)
    if result is None:
        raise RecoverError(f"{root}: no durable snapshot in manifest")
    return result


def _recover_from_entries(
    root: str,
    entries: List[Dict[str, Any]],
    **build_kw,
) -> Optional[RecoveredState]:
    index: Optional[DigestIndex] = None
    for entry in reversed(entries):
        if not _verify_entry(root, entry):
            continue
        snap_path = os.path.join(root, entry["file"])
        try:
            if entry_fmt(entry) < 2:
                doc, blob = _load_snapshot(snap_path)
                if (
                    doc.get("kind") != "deltastate"
                    or int(doc.get("version", -1)) != _SNAP_VERSION
                ):
                    continue
                offsets = doc["chunk_offsets"]
                pads = doc["chunk_pads"]
                pieces = [
                    (i, blob[int(offsets[i]) : int(offsets[i + 1])], int(pads[i]))
                    for i in range(len(offsets) - 1)
                ]
            else:
                doc = _fold_chain(root, entries, entry)
                if doc is None:
                    continue
                if index is None:
                    index = DigestIndex.load(root)
                pieces, index = _load_chunks_v2(root, doc, index)
        except (RecoverError, OSError, ValueError, KeyError):
            continue
        return _materialize_state(
            doc, pieces, seq=int(entry["seq"]), snap_path=snap_path, **build_kw
        )
    return None


def _load_chunks_v2(
    root: str, doc: Dict[str, Any], index: DigestIndex, _rebuilt: bool = False
) -> Tuple[List[Tuple[int, bytes, int]], DigestIndex]:
    """Materialize a folded doc's chunk table out of the packs,
    digest-verifying every read.  A stale/missing index entry triggers one
    rebuild from pack footers (persisted, so the repair sticks); anything
    still unreadable raises RecoverError and the caller falls back to an
    older candidate."""
    table = [(int(r[0]), str(r[1]), int(r[2]), int(r[3])) for r in doc.get("chunks", [])]
    rebuilt = _rebuilt

    def _covered() -> bool:
        for pcid, digest_hex, _, _ in table:
            ent = index.by_pcid.get(pcid)
            if ent is None or ent["d"] != digest_hex:
                return False
        return True

    if not _covered():
        index = DigestIndex.load(root)           # in-memory copy may be stale
        if not _covered():
            index.rebuild_from_packs()
            rebuilt = True
        if not _covered():
            raise RecoverError(f"{root}: digest index cannot resolve referenced chunks")
    pieces: List[Tuple[int, bytes, int]] = []
    for pcid, digest_hex, pad, size in table:
        ent = index.by_pcid[pcid]
        data = _read_pack_chunk(root, ent["f"], int(ent["o"]), size)
        if (
            data is None
            or hashlib.blake2b(data, digest_size=_CHUNK_DIGEST_BYTES).hexdigest()
            != digest_hex
        ):
            if not rebuilt:
                # the index may point at swept/stale offsets: rebuild once
                # from the packs themselves and retry the whole table
                index.rebuild_from_packs()
                return _load_chunks_v2(root, doc, index, _rebuilt=True)
            raise RecoverError(
                f"{root}: chunk pcid={pcid} unreadable or digest-mismatched in pack"
            )
        pieces.append((pcid, data, pad))
    return pieces, index


def _materialize_state(
    doc: Dict[str, Any],
    pieces: List[Tuple[int, bytes, int]],
    *,
    seq: int,
    snap_path: str,
    restore_fn=None,
    template_pool_size: int = 8,
    stream: bool = True,
    policy=None,
    auto_restore: bool = True,
    action_applier=None,
    device: torch.device,
) -> RecoveredState:
    """Rebuild the live DeltaState from a (folded) snapshot doc + its chunk
    bytes.  ``pieces`` are ``(ref, padded bytes, pad)`` in put order; every
    meta doc's ``chunks`` list resolves through the resulting map, so the
    v1 (dense index) and v2 (pcid) formats share this entire path."""
    # ---- chunks ----------------------------------------------------------
    store = ChunkStore(chunk_bytes=int(doc["chunk_bytes"]), dedupe=bool(doc["dedupe"]))
    cid_map: Dict[int, int] = {}
    for ref, piece, pad in pieces:
        cid_map[ref] = store.put(piece, pad=pad)

    # ---- layers ----------------------------------------------------------
    layer_store = LayerStore(store)
    lid_map: Dict[int, int] = {}
    for layer_doc in doc["layers"]:
        layer = layer_store.new_layer()
        layer.frozen = True
        for key in sorted(layer_doc["entries"]):
            ent = layer_doc["entries"][key]
            ids = []
            for dense in ent["chunks"]:
                new_cid = cid_map[int(dense)]
                store.incref(new_cid)
                ids.append(new_cid)
            layer.entries[key] = TensorMeta(
                shape=tuple(int(s) for s in ent["shape"]),
                dtype=ent["dtype"],
                chunk_ids=tuple(ids),
                digests=tuple(bytes.fromhex(d) for d in ent["digests"]),
                trailing_pad=int(ent["trailing_pad"]),
                tile_grid=tuple(int(g) for g in ent.get("tile_grid", ())),
            )
        layer.tombstones.update(layer_doc["tombstones"])
        lid_map[int(layer_doc["id"])] = layer.layer_id

    # ---- DeltaCR + images ------------------------------------------------
    if policy is None:
        policy = DumpPolicy(stream=stream)
    cr = DeltaCR(
        store,
        template_pool_size=template_pool_size,
        restore_fn=(
            restore_fn
            if restore_fn is not None
            else (lambda p: CowTensorState(p, device=device))
        ),
        policy=policy,
    )
    for img_doc in doc["images"]:
        img_entries = {}
        for key in sorted(img_doc["entries"]):
            ent = img_doc["entries"][key]
            ids = []
            for dense in ent["chunks"]:
                new_cid = cid_map[int(dense)]
                store.incref(new_cid)
                ids.append(new_cid)
            img_entries[key] = TensorMeta(
                shape=tuple(int(s) for s in ent["shape"]),
                dtype=ent["dtype"],
                chunk_ids=tuple(ids),
                digests=tuple(bytes.fromhex(d) for d in ent["digests"]),
                trailing_pad=int(ent["trailing_pad"]),
                tile_grid=tuple(int(g) for g in ent.get("tile_grid", ())),
            )
        image = DumpImage(
            image_id=int(img_doc["image_id"]),
            parent_id=None if img_doc["parent_id"] is None else int(img_doc["parent_id"]),
            entries=img_entries,
            dirtied_chunks=int(img_doc["dirtied_chunks"]),
            dump_bytes=int(img_doc["dump_bytes"]),
            wall_ms=float(img_doc["wall_ms"]),
            mode=img_doc["mode"],
            streamed=bool(img_doc["streamed"]),
            stream_windows=int(img_doc["stream_windows"]),
            stream_window_bytes=int(img_doc["stream_window_bytes"]),
            encode_ms=float(img_doc["encode_ms"]),
            drain_ms=float(img_doc["drain_ms"]),
            commit_ms=float(img_doc["commit_ms"]),
        )
        cr.adopt_image(int(img_doc["ckpt"]), image)
    cr.images.set_next_image_id(int(doc["next_image_id"]))

    # balance the initial put() reference now that all consumers hold theirs
    for new_cid in cid_map.values():
        store.decref(new_cid)

    # ---- generation-cache anchors ---------------------------------------
    if cr.pipeline is not None:
        for image_id in doc["anchors"]:
            image = cr.images.get(int(image_id))
            if image is not None:
                cr.pipeline.rebuild_generation(image, device=device)

    # ---- trunk StateManager ---------------------------------------------
    fs = DeltaFS(layers=layer_store)
    sm: Optional[StateManager] = None
    current: Optional[int] = None
    tree_doc = doc["tree"]
    if tree_doc is not None:
        current = tree_doc["current"]
        decoded_tree = dict(tree_doc)
        decoded_tree["nodes"] = [
            {**nd, "replay_actions": [_decode_obj(a) for a in nd["replay_actions"]]}
            for nd in tree_doc["nodes"]
        ]
        sm = StateManager(Sandbox(fs, CowTensorState({}, device=device)), cr)
        sm.load_tree(decoded_tree, layer_map=lid_map)
        sm.action_applier = action_applier
        # each surviving node's config holds retained layer references,
        # mirroring what checkpoint() handed the trunk pre-crash
        for node in sm.nodes.values():
            if node.layer_config is not None and not node.reclaimed:
                layer_store.retain_config(node.layer_config)

    # ---- trunk auto-restore ---------------------------------------------
    trunk_restore_mode: Optional[str] = None
    if sm is not None and current is not None:
        if not auto_restore:
            trunk_restore_mode = "disabled"
        elif action_applier is None and _needs_lw_replay(sm, int(current)):
            trunk_restore_mode = "skipped-needs-applier"
        else:
            trunk_restore_mode = sm.restore(int(current))

    return RecoveredState(
        seq=seq,
        fs=fs,
        layer_store=layer_store,
        deltacr=cr,
        state_manager=sm,
        current=None if current is None else int(current),
        recovered_pins={int(k): int(v) for k, v in tree_doc["pins"].items()}
        if tree_doc is not None
        else {},
        extra=_decode_obj(doc["extra"]),
        snapshot_path=snap_path,
        trunk_restore_mode=trunk_restore_mode,
    )


def _needs_lw_replay(sm: StateManager, ckpt_id: int) -> bool:
    """Whether restoring ``ckpt_id`` must replay recorded LW actions."""
    walk: Optional[int] = ckpt_id
    while walk is not None:
        node = sm.nodes[walk]
        if not node.lightweight:
            return False
        if node.replay_actions:
            return True
        walk = node.parent_id
    return False


def find_chunk_by_digest(root: str, digest: bytes) -> Optional[bytes]:
    """Locate a chunk's durable bytes by digest: O(1) through the
    persistent digest index over the chunk packs, falling back to a linear
    scan of legacy v1 snapshot blobs for pre-pack roots.

    The self-healing read path uses this as a repair source: a chunk whose
    in-memory bytes rotted can be re-read from the fsync'd durable copy.
    Returns the exact stored bytes (padded layout) or None.  Cold path —
    runs only on a verified-read digest mismatch."""
    want = digest.hex()

    # ---- fast path: digest index over the packs --------------------------
    try:
        index = DigestIndex.load(root)
        for attempt in range(2):
            for (digest_hex, _pad), ent in index.by_key.items():
                if digest_hex != want:
                    continue
                data = _read_pack_chunk(root, ent["f"], int(ent["o"]), int(ent["s"]))
                if (
                    data is not None
                    and hashlib.blake2b(data, digest_size=_CHUNK_DIGEST_BYTES).hexdigest()
                    == want
                ):
                    return data
            # empty index but packs on disk (lost/corrupt sidecar): rebuild
            # once from the pack footers and retry
            if attempt == 0 and not index.by_key and _list_packs(root):
                index.rebuild_from_packs()
            else:
                break
    except OSError:
        pass

    # ---- legacy path: scan self-contained v1 snapshot blobs --------------
    try:
        entries = _read_manifest(root)
    except OSError:
        return None
    for entry in reversed(entries):
        try:
            if not _verify_entry(root, entry):
                continue
            doc, blob = _load_snapshot(os.path.join(root, entry["file"]))
        except (OSError, RecoverError, ValueError, KeyError):
            continue
        if doc.get("kind") != "deltastate":
            continue
        offsets = doc.get("chunk_offsets", [])
        meta_docs = [
            m
            for img in doc.get("images", [])
            for m in img.get("entries", {}).values()
        ] + [
            m
            for layer in (doc.get("layers") or [])
            for m in layer.get("entries", {}).values()
        ]
        for m in meta_docs:
            digests = m.get("digests") or []
            for i, dh in enumerate(digests):
                if dh != want:
                    continue
                dense = m["chunks"][i]
                if dense + 1 >= len(offsets):
                    continue
                piece = blob[offsets[dense] : offsets[dense + 1]]
                if hashlib.blake2b(piece, digest_size=16).digest() == digest:
                    return piece
    return None


# --------------------------------------------------------------------------
# manifest compaction
# --------------------------------------------------------------------------
def _rewrite_manifest(root: str, records: List[Dict[str, Any]]) -> None:
    """Atomically replace the MANIFEST with ``records`` (compaction's
    commit point): temp + fsync + rename, the old manifest stays the
    source of truth until the switch."""
    faults.fire("persist.manifest_append")
    lines = []
    for rec in records:
        payload = _canon_json(rec)
        lines.append(payload + b"\t" + _line_digest(payload).encode() + b"\n")
    tmp = _manifest_path(root) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(lines))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _manifest_path(root))
    _fsync_dir(root)


def _v1_doc_to_v2(
    root: str, doc: Dict[str, Any], blob: bytes, index: DigestIndex
) -> Dict[str, Any]:
    """Convert a legacy self-contained v1 doc into a v2 full doc, packing
    its inline chunk blob into the root's shared chunk storage."""
    offsets = doc["chunk_offsets"]
    pads = doc["chunk_pads"]
    pending: Dict[Tuple[str, int], Dict[str, Any]] = {}
    staged_entries: List[Dict[str, Any]] = []
    staged_payloads: List[bytes] = []
    table: Dict[int, List[Any]] = {}
    dense_to_pcid: Dict[int, int] = {}
    offset = 0
    for i in range(len(offsets) - 1):
        data = blob[int(offsets[i]) : int(offsets[i + 1])]
        pad = int(pads[i])
        digest = hashlib.blake2b(data, digest_size=_CHUNK_DIGEST_BYTES).digest()
        key = (digest.hex(), pad)
        ent = index.lookup(*key) or pending.get(key)
        if ent is None:
            ent = {
                "p": index.next_pcid + len(staged_entries),
                "d": key[0],
                "pad": pad,
                "s": len(data),
                "f": None,
                "o": offset,
            }
            offset += len(data)
            pending[key] = ent
            staged_entries.append(ent)
            staged_payloads.append(data)
        pcid = int(ent["p"])
        dense_to_pcid[i] = pcid
        table[pcid] = [pcid, ent["d"], int(ent["pad"]), int(ent["s"])]
    if staged_payloads:
        _write_pack(root, staged_entries, staged_payloads)
        index.append(staged_entries)

    def remap(meta_doc: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(meta_doc)
        out["chunks"] = [dense_to_pcid[int(i)] for i in meta_doc["chunks"]]
        return out

    v2 = {
        "version": _SNAP_VERSION_V2,
        "kind": "deltastate-full",
        "chunks": [table[p] for p in sorted(table)],
        "chunk_bytes": doc["chunk_bytes"],
        "dedupe": doc["dedupe"],
        "layers": [
            {**layer, "entries": {k: remap(v) for k, v in layer["entries"].items()}}
            for layer in doc["layers"]
        ],
        "images": [
            {**img, "entries": {k: remap(v) for k, v in img["entries"].items()}}
            for img in doc["images"]
        ],
        "next_image_id": doc["next_image_id"],
        "tree": doc["tree"],
        "anchors": doc["anchors"],
        "extra": doc["extra"],
    }
    return v2


def compact_state(
    root: str,
    *,
    keep_snapshots: int = 4,
    sweep_threshold: float = 0.5,
    stats_out: Optional[Dict[str, Any]] = None,
) -> int:
    """Rewrite the newest durable delta chain as a fresh full snapshot and
    truncate the manifest history, under the same crash-consistency
    guarantees as a save: the new full doc lands atomically, the old
    manifest stays valid until its atomic replacement, and a kill anywhere
    in between recovers exactly the pre-compaction state.

    After the switch: superseded snapshot docs (and any orphans from
    crashed saves) are unlinked, packs with no referenced chunks are
    deleted, and surviving packs whose live fraction dropped below
    ``sweep_threshold`` are rewritten so dead chunk bytes are actually
    reclaimed.  Legacy v1 roots are converted to v2 in the process.
    Returns the new full snapshot's seq."""
    faults.fire("persist.compact")
    entries = _read_manifest(root)
    os.makedirs(_chunks_dir(root), exist_ok=True)
    index = DigestIndex.load(root)

    chosen: Optional[Dict[str, Any]] = None
    folded: Optional[Dict[str, Any]] = None
    for entry in reversed(entries):
        if not _verify_entry(root, entry):
            continue
        if entry_fmt(entry) < 2:
            try:
                doc, blob = _load_doc(root, entry)
            except (OSError, RecoverError, ValueError):
                continue
            if doc.get("kind") != "deltastate":
                continue
            folded = _v1_doc_to_v2(root, doc, blob, index)
        else:
            folded = _fold_chain(root, entries, entry)
            if folded is None:
                continue
        chosen = entry
        break
    if chosen is None or folded is None:
        raise RecoverError(f"{root}: nothing durable to compact")

    seq = (max((int(e["seq"]) for e in entries), default=0)) + 1
    fname = f"snap-{seq:08d}.dbox"
    data = _snapshot_bytes(folded, b"")
    _write_atomic(os.path.join(root, fname), data)
    record = {
        "seq": seq,
        "file": fname,
        "bytes": len(data),
        "blake2b": hashlib.blake2b(data, digest_size=16).hexdigest(),
        "fmt": _SNAP_VERSION_V2,
        "kind": "full",
        "base": seq,
        "chain": 0,
        "pack": None,
        "pack_bytes": 0,
        "pack_blake2b": "",
    }

    # retention across the switch: the new full + the newest keep-1 old
    # heads (and whatever their chains still need)
    heads = [e for e in entries if _verify_entry(root, e)][-(max(1, int(keep_snapshots)) - 1):] \
        if int(keep_snapshots) > 1 else []
    kept = _chain_closure(entries, heads) if heads else []
    new_manifest = kept + [record]
    _rewrite_manifest(root, new_manifest)    # ---- the atomic switch ----

    # ---- reclaim: snap docs, dead packs, underfilled packs ---------------
    live_files = {e["file"] for e in new_manifest}
    for f in sorted(os.listdir(root)):
        if f.startswith("snap-") and (f.endswith(".dbox") or f.endswith(".tmp")) \
                and f not in live_files:
            try:
                os.unlink(os.path.join(root, f))
            except OSError:
                pass
    _gc_packs(root, index)
    swept = _sweep_packs(root, index, threshold=sweep_threshold)
    if stats_out is not None:
        stats_out.update(
            {"seq": seq, "kept_entries": len(new_manifest), "swept_packs": swept}
        )
    return seq


def _sweep_packs(root: str, index: DigestIndex, *, threshold: float = 0.5) -> int:
    """Rewrite packs whose live payload fraction fell below ``threshold``:
    their still-referenced chunks move to a fresh pack, the index is
    atomically rewritten, the old packs are unlinked.  Crash-safe: the new
    pack lands before the index switch, and an old pack outliving a crash
    is garbage-collected by the next sweep (the rebuilt index prefers the
    newest pack for a duplicated key).  Returns the number of packs
    swept."""
    live_pcids = _live_pcids(root)
    by_pack: Dict[str, List[Dict[str, Any]]] = {}
    for pcid, ent in index.by_pcid.items():
        if pcid in live_pcids:
            by_pack.setdefault(ent["f"], []).append(ent)
    victims: List[str] = []
    moved: List[Dict[str, Any]] = []
    payloads: List[bytes] = []
    for fname in _list_packs(root):
        ents = by_pack.get(fname, [])
        if not ents:
            continue                      # fully dead packs are _gc_packs' job
        try:
            total = os.path.getsize(os.path.join(_chunks_dir(root), fname))
        except OSError:
            continue
        live_bytes = sum(int(e["s"]) for e in ents)
        if total <= 0 or live_bytes / total >= threshold:
            continue
        ok = True
        datas = []
        for ent in sorted(ents, key=lambda e: int(e["o"])):
            data = _read_pack_chunk(root, fname, int(ent["o"]), int(ent["s"]))
            if data is None:
                ok = False
                break
            datas.append((ent, data))
        if not ok:
            continue
        victims.append(fname)
        for ent, data in datas:
            moved.append(ent)
            payloads.append(data)
    if not victims:
        return 0
    offset = 0
    new_entries = []
    for ent, data in zip(moved, payloads):
        new_entries.append(
            {"p": int(ent["p"]), "d": ent["d"], "pad": int(ent["pad"]),
             "s": int(ent["s"]), "f": None, "o": offset}
        )
        offset += len(data)
    new_fname, _, _ = _write_pack(root, new_entries, payloads)
    for ent in new_entries:
        index._ingest(ent)
    index.rewrite()
    for fname in victims:
        try:
            os.unlink(os.path.join(_chunks_dir(root), fname))
        except OSError:
            pass
    return len(victims)


class PersistencePlane:
    """Handle on one persistence root: repeated saves + recovery.

    The serving scheduler owns one of these when configured with
    ``persist_path``: every coalesced-suspend drain commits a manifest
    snapshot, so a warm pool of suspended sessions survives process death.

    Saves are O(delta): doc deltas against the previous save with a full
    anchor every ``full_every`` saves, chunk bytes deduped against the
    root's digest index.  With ``compact_every`` > 0 the plane compacts
    the manifest (fresh full snapshot + history truncation + pack sweep)
    every that many saves."""

    def __init__(
        self,
        root: str,
        *,
        keep_snapshots: int = 4,
        full_every: int = 8,
        compact_every: int = 0,
    ):
        self.root = root
        self.keep_snapshots = int(keep_snapshots)
        self.full_every = int(full_every)
        self.compact_every = int(compact_every)
        os.makedirs(root, exist_ok=True)
        self.saves = 0
        self.compactions = 0
        self.last_save_stats: Dict[str, Any] = {}
        # save accelerator: previous folded doc + digest index, so steady-
        # state saves never re-read the chain from disk
        self._cache: Dict[str, Any] = {}

    def save(
        self,
        *,
        sm: Optional[StateManager] = None,
        deltacr: Optional[DeltaCR] = None,
        extra: Optional[Dict[str, Any]] = None,
        mode: str = "auto",
    ) -> int:
        stats: Dict[str, Any] = {}
        seq = save_state(
            self.root,
            sm=sm,
            deltacr=deltacr,
            extra=extra,
            keep_snapshots=self.keep_snapshots,
            mode=mode,
            full_every=self.full_every,
            stats_out=stats,
            _cache=self._cache,
        )
        self.saves += 1
        self.last_save_stats = stats
        if self.compact_every > 0 and self.saves % self.compact_every == 0:
            self.compact()
        return seq

    def compact(self) -> int:
        seq = compact_state(self.root, keep_snapshots=self.keep_snapshots)
        self.compactions += 1
        self._cache.clear()       # chain layout changed; next save re-reads
        return seq

    def recover(self, *, device=None, **kw) -> RecoveredState:
        """``recover`` of this root; ``device`` as there (the card unless
        the caller asks for the CPU)."""
        return recover(self.root, device=device, **kw)

    def last_seq(self) -> Optional[int]:
        entries = _read_manifest_tail(self.root)
        if not entries and not _manifest_tail_was_complete(self.root):
            entries = _read_manifest(self.root)
        return int(entries[-1]["seq"]) if entries else None

    # --------------------------------------------------------------- repair
    def repair_source(self):
        """A ``(cid, digest, pad) -> bytes | None`` healer over this root's
        durable blobs, for :meth:`ChunkStore.attach_repair_source`."""
        def _heal(cid: int, digest: bytes, pad: int) -> Optional[bytes]:
            return find_chunk_by_digest(self.root, digest)
        return _heal

    def attach_to(self, store: ChunkStore) -> None:
        """Register this plane's durable blobs as a verified-read repair
        source on ``store``."""
        store.attach_repair_source(self.repair_source())


# --------------------------------------------------------------------------
# legacy layer-only archive (Trainer cross-process restart)
# --------------------------------------------------------------------------
# v2: chunks stored zero-padded with a chunk_pads table; entries carry
# per-chunk digests + trailing_pad.  v1 archives (unpadded, digest-less)
# still load; pre-v2 readers reject v2 archives at the version gate.
_FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)


def save_store(fs: DeltaFS, configs: Dict[str, LayerConfig], path: str) -> int:
    """Persist the layers reachable from ``configs`` (+ their chunks).

    Returns the number of unique chunks written.  Structural sharing is
    preserved: each live chunk id appears once in the blob.
    """
    layer_ids = sorted({lid for cfg in configs.values() for lid in cfg})
    chunk_ids: List[int] = []
    seen = set()
    layers_meta = {}
    for lid in layer_ids:
        layer = fs.layers.get(lid)
        assert layer is not None, f"config references dead layer {lid}"
        entries = {}
        for key, meta in layer.entries.items():
            entries[key] = {
                "shape": list(meta.shape),
                "dtype": meta.dtype,
                "chunk_ids": list(meta.chunk_ids),
                "digests": [d.hex() for d in meta.digests],
                "trailing_pad": meta.trailing_pad,
            }
            if meta.tile_grid:
                entries[key]["tile_grid"] = list(meta.tile_grid)
            for cid in meta.chunk_ids:
                if cid not in seen:
                    seen.add(cid)
                    chunk_ids.append(cid)
        layers_meta[str(lid)] = {
            "entries": entries,
            "tombstones": sorted(layer.tombstones),
        }

    blobs = [fs.store.get(cid) for cid in chunk_ids]
    offsets = np.zeros((len(blobs) + 1,), np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    data = np.frombuffer(b"".join(blobs), np.uint8) if blobs else np.zeros(0, np.uint8)

    manifest = {
        "version": _FORMAT_VERSION,
        "chunk_bytes": fs.store.chunk_bytes,
        "chunk_ids": chunk_ids,
        "chunk_pads": [fs.store.pad_of(cid) for cid in chunk_ids],
        "layers": layers_meta,
        "configs": {name: list(cfg) for name, cfg in configs.items()},
    }
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        data=data,
        offsets=offsets,
        manifest=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
    )
    # numpy appends .npz; normalize then atomically replace
    written = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(written, path)
    return len(chunk_ids)


def load_store(path: str) -> Tuple[DeltaFS, Dict[str, LayerConfig]]:
    """Rebuild a DeltaFS + named configs from ``save_store`` output."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        data = z["data"]
        offsets = z["offsets"]
    assert manifest["version"] in _READABLE_VERSIONS, manifest["version"]
    fs = DeltaFS(chunk_bytes=int(manifest["chunk_bytes"]))
    # restore chunks (new ids); pads default 0 for pre-pad archives
    pads = manifest.get("chunk_pads") or [0] * len(manifest["chunk_ids"])
    cid_map: Dict[int, int] = {}
    raw = data.tobytes()
    for i, old_cid in enumerate(manifest["chunk_ids"]):
        blob = raw[int(offsets[i]) : int(offsets[i + 1])]
        cid_map[int(old_cid)] = fs.store.put(blob, pad=int(pads[i]))
    # rebuild layers bottom-up in id order, as frozen lowers
    lid_map: Dict[int, int] = {}
    for old_lid_s, meta in sorted(manifest["layers"].items(), key=lambda kv: int(kv[0])):
        layer = fs.layers.new_layer()
        layer.frozen = True
        for key, ent in meta["entries"].items():
            ids = []
            for old_cid in ent["chunk_ids"]:
                new_cid = cid_map[int(old_cid)]
                fs.store.incref(new_cid)
                ids.append(new_cid)
            layer.entries[key] = TensorMeta(
                shape=tuple(ent["shape"]),
                dtype=ent["dtype"],
                chunk_ids=tuple(ids),
                digests=tuple(bytes.fromhex(d) for d in ent.get("digests", [])),
                trailing_pad=int(ent.get("trailing_pad", 0)),
                tile_grid=tuple(int(g) for g in ent.get("tile_grid", ())),
            )
        layer.tombstones.update(meta["tombstones"])
        lid_map[int(old_lid_s)] = layer.layer_id
    # initial put() refs balance the first incref per chunk
    for old_cid, new_cid in cid_map.items():
        fs.store.decref(new_cid)
    configs = {
        name: tuple(lid_map[int(l)] for l in cfg)
        for name, cfg in manifest["configs"].items()
    }
    for cfg in configs.values():
        fs.retain_config(cfg)
    return fs, configs
