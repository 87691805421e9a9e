"""Serving engine: prefill + batched decode over forkable paged sessions.

Ported from the JAX package's ``serve/engine.py``.  The engine owns the
model (with its weights) and the page pool, and exposes the operations the
agent sandbox needs:

* ``new_session(prompt)`` — prefill a prompt into freshly allocated pages.
* ``step(sessions)``      — one batched decode step: host-side CoW
  preparation (one transactional ``materialize`` for the whole batch),
  paged decode, per-session sampling.  Sessions in the batch may be
  arbitrary forks of each other — the pool's refcounts make sharing safe.
* greedy and temperature sampling with *checkpointable* RNG: seed and
  counter live in session extras and sampling runs in numpy on the host
  (``np.random.default_rng((seed, counter))``), so a restored session
  replays the identical token stream, and the token streams equal the JAX
  package's on equal logits.

It runs eagerly; there are no compiled-program caches.

Recurrent architectures (mamba/xlstm sublayers) carry their states in
``session.extras["stage{i}/{tag}"]``, one ``(N_periods, 1, ...)`` tensor
per state leaf on the engine's device: fork is aliasing, restore is
rebinding — the degenerate-but-fastest DeltaCR case.  Every step
concatenates the batch's states into fresh tensors, which the model
updates in place, and rebinds each session's extras to its slice of them,
so a state a fork shares is never written.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..models.model import RECURRENT_KINDS, Model, stacked_cache_entry
from .kvcache import PagePool, PagedSession

__all__ = ["Engine", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0


class Engine:
    def __init__(self, model: Model, pool: PagePool):
        if model.params is None:
            raise ValueError("Engine needs a model with weights (Model.init or params=)")
        if model.device.type != pool.device.type:
            raise ValueError(f"model on {model.device} but pool on {pool.device}")
        self.model = model
        self.pool = pool
        self.cfg = model.cfg
        self.device = model.device
        self.decode_steps = 0

    # ------------------------------------------------------------ sessions
    def new_session(
        self,
        prompt_tokens: Sequence[int],
        sampling: SamplingParams = SamplingParams(),
    ) -> PagedSession:
        sess = PagedSession(self.pool)
        sess.extras["rng_seed"] = np.asarray([sampling.seed], np.int64)
        sess.extras["rng_counter"] = np.asarray([0], np.int64)
        sess.extras["temperature"] = np.asarray([sampling.temperature], np.float32)
        prompt = [int(t) for t in prompt_tokens]
        sess.tokens = list(prompt)
        S = len(prompt)
        with self.pool.lock:
            sess.ensure_writable(extra_tokens=S)
            sess.seq_len = S
            cache = self._build_cache([sess], init_recurrent=True)
            tokens = torch.as_tensor([prompt], dtype=torch.int32, device=self.device)
            logits, new_cache = self.model.prefill(tokens, cache)
            self._absorb_cache([sess], new_cache)
        logits_np = logits[0].float().cpu().numpy()
        sess.extras["last_logits"] = logits_np
        sess.extras["prompt_len"] = np.asarray([S], np.int64)
        # The first generated token comes from the prefill logits; it is
        # appended as the *pending* token (K/V not yet written — the next
        # step writes it at position seq_len).
        sess.tokens.append(self._sample(sess, logits_np))
        return sess

    # ----------------------------------------------------------- decoding
    def step(self, sessions: Sequence[PagedSession]) -> List[int]:
        """One decode step for every session; returns the sampled tokens.

        Each session's ``tokens[-1]`` is its *pending* token (sampled but not
        yet in the cache); the step commits its K/V at position ``seq_len``
        and samples the next pending token."""
        # The whole step holds the pool lock: the async-warm worker copies
        # pages into the same pool tensors this step writes.  Every
        # session's page motion is planned first, then committed through ONE
        # transactional materialize: a failure rolls every plan back before
        # any decode math runs.
        with self.pool.lock:
            plans: List[Any] = []
            try:
                for s in sessions:
                    plans.append(s.plan_writable(extra_tokens=1))
            except BaseException:
                self.pool.discard_plans(plans)
                raise
            self.pool.materialize(plans)
            last = [s.tokens[-1] for s in sessions]
            cache = self._build_cache(sessions)
            tokens = torch.as_tensor(last, dtype=torch.int32, device=self.device)
            logits, new_cache = self.model.decode_step(tokens, cache)
            self._absorb_cache(sessions, new_cache)
            for s in sessions:
                s.seq_len += 1
        out = []
        logits_np = logits.float().cpu().numpy()
        for i, s in enumerate(sessions):
            tok = self._sample(s, logits_np[i])
            s.tokens.append(tok)
            s.extras["last_logits"] = logits_np[i]
            out.append(tok)
        self.decode_steps += 1
        return out

    def generate(self, session: PagedSession, n_tokens: int) -> List[int]:
        """Return the first ``n_tokens`` generated after the prompt, stepping
        as needed (the first one was already sampled at prefill)."""
        plen = int(session.extras["prompt_len"][0])
        while len(session.tokens) < plen + n_tokens:
            self.step([session])
        return [int(t) for t in session.tokens[plen : plen + n_tokens]]

    # ----------------------------------------------------------- internals
    def _sample(self, sess: PagedSession, logits: np.ndarray) -> int:
        temp = float(sess.extras["temperature"][0])
        if temp <= 0.0:
            return int(np.argmax(logits))
        seed = int(sess.extras["rng_seed"][0])
        counter = int(sess.extras["rng_counter"][0])
        rng = np.random.default_rng((seed, counter))
        z = logits / temp
        z = z - z.max()
        p = np.exp(z) / np.sum(np.exp(z))
        tok = int(rng.choice(len(p), p=p))
        sess.extras["rng_counter"] = np.asarray([counter + 1], np.int64)
        return tok

    def _build_cache(self, sessions: Sequence[PagedSession], *,
                     init_recurrent: bool = False) -> Dict[str, Any]:
        """The paged cache for a batch: the pool's stacked K/V tensors and
        the sessions' page tables, broadcast over periods (a view), and
        each recurrent sublayer's states as fresh ``(N, B, ...)`` tensors:
        initial states at prefill (``init_recurrent``), else the
        concatenation of the sessions' extras."""
        cfg = self.cfg
        B = len(sessions)
        cache: Dict[str, Any] = {
            "lens": torch.as_tensor(
                [s.seq_len for s in sessions], dtype=torch.int32, device=self.device
            )
        }
        tables = torch.as_tensor(
            np.stack([s.table for s in sessions]), dtype=torch.int32, device=self.device
        )
        for i, stage in enumerate(cfg.stages):
            entries: Dict[str, Any] = {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    tag = f"l{li}_s{si}_{kind}"
                    if kind in ("attn", "attn_local"):
                        entries[tag] = {
                            "pk": self.pool.pools_k[f"stage{i}"][tag],
                            "pv": self.pool.pools_v[f"stage{i}"][tag],
                            "table": tables.expand((stage.n_periods,) + tuple(tables.shape)),
                        }
                    elif kind in RECURRENT_KINDS:
                        if init_recurrent:
                            entries[tag] = stacked_cache_entry(
                                kind, cfg, stage.n_periods, B, 1, self.device)
                        else:
                            per = [s.extras[f"stage{i}/{tag}"] for s in sessions]
                            entries[tag] = {
                                leaf: torch.cat([p[leaf] for p in per], dim=1)
                                for leaf in per[0]
                            }
            cache[f"stage{i}"] = entries
        return cache

    def _absorb_cache(self, sessions: Sequence[PagedSession], new_cache: Dict[str, Any]) -> None:
        """Rebind each session's recurrent states to its slice of the step's
        updated ``(N, B, ...)`` tensors (K/V were written into the pool in
        place)."""
        for key in self.pool.state_keys:
            skey, tag = key.split("/")
            for b, s in enumerate(sessions):
                s.extras[key] = {leaf: t[:, b:b + 1] for leaf, t in new_cache[skey][tag].items()}
