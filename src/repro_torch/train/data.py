"""Synthetic data pipeline with sequence packing and a checkpointable cursor.

The port's own copy of the JAX package's ``train/data.py`` (numpy only, no
torch): for the same config and seed it yields byte-identical batches and
stream states, so the two packages' trainers see the same tokens.

Production shape without external datasets: a deterministic document stream
(seeded Zipf-ish token documents of variable length), packed into fixed-
length training sequences with cross-document attention masking via EOD
boundaries, sharded by data-parallel rank.

The pipeline's **cursor** (document counter per rank) is part of the coupled
training checkpoint: restoring a run resumes the stream exactly where the
saved step left off — the (data, model) analogue of the paper's coupled
(filesystem, process) pair.  A background prefetch thread keeps one batch
ahead (overlapping host data work with the device step).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "PackedStream", "PrefetchLoader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_ranks: int = 1
    rank: int = 0
    seed: int = 1234
    mean_doc_len: int = 512
    eod_id: int = 0


class PackedStream:
    """Deterministic packed-sequence stream with an explicit cursor."""

    def __init__(self, cfg: DataConfig, cursor: int = 0):
        assert cfg.global_batch % cfg.n_ranks == 0
        self.cfg = cfg
        self.cursor = int(cursor)              # documents consumed by this rank
        self._buf = np.empty((0,), np.int64)

    # ------------------------------------------------------------- stream
    def _doc(self, index: int) -> np.ndarray:
        """Deterministic document #index for this rank."""
        rng = np.random.default_rng(
            (self.cfg.seed, self.cfg.rank, index)
        )
        length = int(rng.integers(self.cfg.mean_doc_len // 4, self.cfg.mean_doc_len * 2))
        # Zipf-ish marginals make content-dedup / compression behave realistically
        toks = rng.zipf(1.3, size=length) % (self.cfg.vocab_size - 1) + 1
        return np.concatenate([toks.astype(np.int64), [self.cfg.eod_id]])

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_rank = cfg.global_batch // cfg.n_ranks
        need = per_rank * (cfg.seq_len + 1)
        while self._buf.size < need:
            self._buf = np.concatenate([self._buf, self._doc(self.cursor)])
            self.cursor += 1
        flat = self._buf[:need].reshape(per_rank, cfg.seq_len + 1)
        self._buf = self._buf[need:]
        tokens = flat[:, :-1].astype(np.int32)
        labels = flat[:, 1:].astype(np.int32)
        labels = np.where(tokens == cfg.eod_id, -1, labels)  # don't predict across EOD
        return {"tokens": tokens, "labels": labels}

    # ----------------------------------------------------------- coupling
    def state(self) -> Dict[str, np.ndarray]:
        return {
            "cursor": np.asarray([self.cursor], np.int64),
            "buf": self._buf.copy(),
        }

    def restore(self, state: Dict[str, np.ndarray]) -> None:
        self.cursor = int(state["cursor"][0])
        self._buf = np.asarray(state["buf"], np.int64).copy()


class PrefetchLoader:
    """One-batch-ahead background prefetch (host/device overlap)."""

    def __init__(self, stream: PackedStream, depth: int = 2):
        self.stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop:
            batch = self.stream.next_batch()
            state = self.stream.state()
            try:
                self._q.put((batch, state), timeout=1.0)
            except queue.Full:
                if self._stop:
                    return
                self._q.put((batch, state))

    def __next__(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Returns (batch, stream-state-after-batch) for coupled checkpoints."""
        return self._q.get()

    def stop(self) -> None:
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
