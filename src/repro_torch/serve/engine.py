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

Decode programs.  The reference keeps one compiled program of
``Model.decode_step`` per batch width (``_decode_jit``, ``_get_decode``).
Here ``_get_decode(batch)`` gives a :class:`DecodeProgram` for that width:
static input buffers (the tokens, lengths and page tables as one int32
tensor, staged from one host buffer by one copy; each recurrent
sublayer's states as ``(N_periods, B, ...)`` tensors) and, on a CUDA
device, one CUDA graph of ``decode_step`` captured over them.  The pool's
K/V tensors take part by address: they are written in place and never
rebound.  A step stages its inputs, replays the graph, copies the logits
to the host and clones the states once.  A width's first step on the card
runs ``decode_step`` eagerly on a side stream (which builds the kernel
library, initializes cuBLAS and gives that step's results), then captures;
every later step of that width replays.  The graphs of all widths share
one memory pool.  A capture or replay that fails raises: nothing falls
back to the eager step.  On the CPU, or with ``graphs=False``, the same
staging runs and ``decode_step`` runs eagerly over the static buffers.
Programs are keyed by the exact width and by the activation-sharding
context the step runs under (an expert-parallel MoE captures its per-rank
stages whole).  Prefill stays eager: a graph per prompt length would
replay once.

Recurrent architectures (mamba/xlstm sublayers) carry their states in
``session.extras["stage{i}/{tag}"]``, one ``(N_periods, 1, ...)`` tensor
per state leaf on the engine's device: fork is aliasing, restore is
rebinding — the degenerate-but-fastest DeltaCR case.  A step copies the
batch's states into the program's static buffers, which the model updates
in place, then rebinds each session's extras to its slice of one clone of
them: no session holds a view of a static buffer (the next replay
overwrites those), so a state a fork shares is never written.

A model with dropless MoE layers routes each decode row to its top-k
experts, and the step reads only those experts' weights
(``kernels.moe_decode``).  The program keeps each such layer's routed ids
in a static buffer and returns them after the logits, in the same output
and so in the same device-to-host copy; ``Engine.step`` counts the
distinct (layer, held expert) pairs the step read, as its ``engine.step``
span's ``experts_read`` (beside ``rows``) and the run's
``moe.experts_read`` counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..dist.sharding import current_act_ctx
from ..kernels import accounting
from ..models.model import RECURRENT_KINDS, Model, stacked_cache_entry
from .kvcache import PagePool, PagedSession

__all__ = ["DecodeProgram", "Engine", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0


class DecodeProgram:
    """``Model.decode_step`` at one batch width over static buffers, run
    eagerly or replayed from a CUDA graph (see the module docstring)."""

    def __init__(self, engine: "Engine", batch: int, *, graph: bool):
        cfg, pool, dev = engine.cfg, engine.pool, engine.device
        self.engine = engine
        self.batch = batch
        self.use_graph = graph
        B, maxp = batch, pool.max_pages
        # tokens | lengths | page tables, one host buffer and one copy
        self.host = torch.empty((B * (2 + maxp),), dtype=torch.int32,
                                pin_memory=dev.type == "cuda")
        self.staged = torch.empty_like(self.host, device=dev)
        self.tokens = self.staged[:B]
        tables = self.staged[2 * B:].view(B, maxp)
        self.cache: Dict[str, Any] = {"lens": self.staged[B:2 * B]}
        # extras key -> leaf -> static (N, B, ...) state, written in place
        self.states: Dict[str, Dict[str, torch.Tensor]] = {}
        # each dropless MoE sublayer's routed ids (N, B, K), written in place
        self.routes: List[torch.Tensor] = []
        self.held = cfg.experts_held or (0, cfg.n_experts)
        self.top_k = cfg.top_k
        for i, stage in enumerate(cfg.stages):
            entries: Dict[str, Any] = {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    tag = f"l{li}_s{si}_{kind}"
                    if kind in ("attn", "attn_local"):
                        entries[tag] = {
                            "pk": pool.pools_k[f"stage{i}"][tag],
                            "pv": pool.pools_v[f"stage{i}"][tag],
                            "table": tables.expand((stage.n_periods,) + tuple(tables.shape)),
                        }
                    elif kind in RECURRENT_KINDS:
                        entries[tag] = self.states[f"stage{i}/{tag}"] = stacked_cache_entry(
                            kind, cfg, stage.n_periods, B, 1, dev)
                    elif kind == "moe" and cfg.moe_dropless:
                        ids = torch.zeros((stage.n_periods, B, cfg.top_k), dtype=torch.int32,
                                          device=dev)
                        entries[tag] = {"ids": ids}
                        self.routes.append(ids)
            self.cache[f"stage{i}"] = entries
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None      # the graph's output
        self.notes: List[accounting.Note] = []          # what the capture counted
        self.capture_ms: Optional[float] = None
        self.replays = 0

    def body(self) -> torch.Tensor:
        """One decode step over the static buffers: the (B, V) float32
        logits, followed, where the model has dropless MoE layers, by each
        layer's routed ids as float32 (exact below 2**24); K/V and the
        static states are written in place."""
        logits = self.engine.model.decode_step(self.tokens, self.cache)[0]
        if not self.routes:
            return logits
        ids = [r.transpose(0, 1).reshape(self.batch, -1) for r in self.routes]
        return torch.cat([logits] + [t.float() for t in ids], dim=1)

    def experts_read(self, routed: np.ndarray) -> int:
        """The distinct (MoE layer, held expert) pairs of a step's routed
        ids, ``routed`` (B, layers · K) as ``body`` lays them out: the
        experts whose weights the step read."""
        lo, hi = self.held
        B, K = self.batch, self.top_k
        ids = routed.astype(np.int64).reshape(B, -1, K).transpose(1, 0, 2).reshape(-1, B * K)
        ids = np.sort(np.where((ids >= lo) & (ids < hi), ids, -1), axis=1)
        first = np.concatenate([ids[:, :1] >= 0, (ids[:, 1:] != ids[:, :-1]) & (ids[:, 1:] >= 0)],
                               axis=1)
        return int(first.sum())

    def stage(self, sessions: Sequence[PagedSession]) -> None:
        """Copy the batch's pending tokens, lengths, page tables and
        recurrent states into the static buffers."""
        pool = self.engine.pool
        for skey, tag in pool.attn_tags:
            entry = self.cache[skey][tag]
            if pool.pools_k[skey][tag] is not entry["pk"] or pool.pools_v[skey][tag] is not entry["pv"]:
                raise RuntimeError(f"the pool rebound its {skey}/{tag} K/V tensors, which a "
                                   "decode program reads by address")
        B = self.batch
        h = self.host.numpy()
        h[:B] = [s.tokens[-1] for s in sessions]
        h[B:2 * B] = [s.seq_len for s in sessions]
        h[2 * B:].reshape(B, -1)[:] = np.stack([s.table for s in sessions])
        self.staged.copy_(self.host, non_blocking=True)
        if not self.states:
            return
        with trace.span("engine.state"):
            for key, leaves in self.states.items():
                for b, s in enumerate(sessions):
                    for leaf, t in leaves.items():
                        t[:, b:b + 1].copy_(s.extras[key][leaf])

    def run(self) -> torch.Tensor:
        """The step's logits (the graph's static output on a replay: read
        it before the next run)."""
        if not self.use_graph:
            return self.body()
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        accounting.replay(self.notes)
        self.replays += 1
        return self.logits

    def _warm_up_and_capture(self) -> torch.Tensor:
        # the warm-up is this step: its K/V writes and state updates are the
        # real ones (a capture runs nothing)
        logits, self.graph, self.logits, self.notes, self.capture_ms = (
            accounting.warm_up_and_capture(self.body, *self.engine._capture_resources()))
        return logits

    def absorb(self, sessions: Sequence[PagedSession]) -> None:
        """Rebind each session's states to its slice of one clone of the
        static buffers."""
        if not self.states:
            return
        with trace.span("engine.state"):
            for key, leaves in self.states.items():
                new = {leaf: t.clone() for leaf, t in leaves.items()}
                for b, s in enumerate(sessions):
                    s.extras[key] = {leaf: t[:, b:b + 1] for leaf, t in new.items()}


class Engine:
    def __init__(self, model: Model, pool: PagePool, graphs: Optional[bool] = None):
        """``graphs=None``: a CUDA graph per batch width on a CUDA device,
        the staged eager step on the CPU.  ``graphs=False`` runs the staged
        eager step on the card too; ``graphs=True`` on the CPU raises."""
        if model.params is None:
            raise ValueError("Engine needs a model with weights (Model.init or params=)")
        if model.device.type != pool.device.type:
            raise ValueError(f"model on {model.device} but pool on {pool.device}")
        on_card = model.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True needs a CUDA device, the model is on {model.device}")
        self.model = model
        self.pool = pool
        self.cfg = model.cfg
        self.device = model.device
        self.graphs = on_card if graphs is None else bool(graphs)
        self.decode_steps = 0
        self._decode: Dict[Tuple[int, Any], DecodeProgram] = {}
        self._graph_pool: Any = None          # one memory pool for every width's graph
        self._side: Optional[torch.cuda.Stream] = None

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
            cache = self._prefill_cache(sess)
            tokens = torch.as_tensor([prompt], dtype=torch.int32, device=self.device)
            logits, new_cache = self.model.prefill(tokens, cache)
            for key in self.pool.state_keys:
                skey, tag = key.split("/")
                sess.extras[key] = dict(new_cache[skey][tag])
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
        # pages into the same pool tensors this step writes, and the next
        # step of this width overwrites the program's outputs.  Every
        # session's page motion is planned first, then committed through ONE
        # transactional materialize: a failure rolls every plan back before
        # any decode math runs.  The ``engine.step`` span runs from the
        # lock's acquisition to the last sampled token; ``engine.run`` is the
        # replay and the logits' copy, which waits for the device.
        with contextlib.ExitStack() as step:
            with self.pool.lock:
                span = step.enter_context(trace.span("engine.step"))
                plans: List[Any] = []
                try:
                    for s in sessions:
                        plans.append(s.plan_writable(extra_tokens=1))
                except BaseException:
                    self.pool.discard_plans(plans)
                    raise
                self.pool.materialize(plans)
                prog = self._get_decode(len(sessions))
                prog.stage(sessions)
                with trace.span("engine.run"):
                    out_np = prog.run().cpu().numpy()
                logits_np = out_np[:, : self.cfg.vocab_size]
                if prog.routes:
                    read = prog.experts_read(out_np[:, self.cfg.vocab_size:])
                    span.set(experts_read=read, rows=len(sessions))
                    trace.count("moe.experts_read", read)
                prog.absorb(sessions)
                for s in sessions:
                    s.seq_len += 1
            out = []
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
    def _get_decode(self, batch: int) -> DecodeProgram:
        """The decode program of width ``batch`` under the current
        activation-sharding context, made on first use."""
        ctx = current_act_ctx()
        key = (batch, None if ctx is None else tuple(sorted(ctx.items())))
        prog = self._decode.get(key)
        if prog is None:
            prog = self._decode[key] = DecodeProgram(self, batch, graph=self.graphs)
        return prog

    def _capture_resources(self) -> Tuple[Any, torch.cuda.Stream]:
        """The graph memory pool every width shares and the side stream of
        warm-ups and captures."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        return self._graph_pool, self._side

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

    def _prefill_cache(self, sess: PagedSession) -> Dict[str, Any]:
        """The paged cache of one session's prefill: the pool's stacked K/V
        tensors and its page table, broadcast over periods (a view), and
        each recurrent sublayer's initial states as fresh ``(N, 1, ...)``
        tensors."""
        cfg = self.cfg
        cache: Dict[str, Any] = {
            "lens": torch.as_tensor([sess.seq_len], dtype=torch.int32, device=self.device)
        }
        table = torch.as_tensor(sess.table[None], dtype=torch.int32, device=self.device)
        for i, stage in enumerate(cfg.stages):
            entries: Dict[str, Any] = {}
            for li, layer in enumerate(stage.period):
                for si, kind in enumerate(layer):
                    tag = f"l{li}_s{si}_{kind}"
                    if kind in ("attn", "attn_local"):
                        entries[tag] = {
                            "pk": self.pool.pools_k[f"stage{i}"][tag],
                            "pv": self.pool.pools_v[f"stage{i}"][tag],
                            "table": table.expand((stage.n_periods,) + tuple(table.shape)),
                        }
                    elif kind in RECURRENT_KINDS:
                        entries[tag] = stacked_cache_entry(
                            kind, cfg, stage.n_periods, 1, 1, self.device)
            cache[f"stage{i}"] = entries
        return cache
