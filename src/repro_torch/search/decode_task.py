"""A real-decode :class:`~repro_torch.search.mcts.AgentTask` — search over tokens.

Ported unchanged from the JAX package's ``search/decode_task.py``.  The
port's ``Engine`` keeps ``extras["last_logits"]`` as a host numpy array,
so proposing and evaluating a node never reads the card.

The paper's headline workload is tree search whose *actions are decoded by
the model itself*: a node's candidate actions are the top tokens of its last
logits, applying an action force-feeds that token and decodes ``k_tokens``
more, and the value estimate is read off the resulting distribution.  This
module closes the serving loop for MCTS:

* **Serial driver** (no scheduler): the task decodes the trunk session
  directly through ``engine.step`` — the rollback-in-place baseline.
* **Parallel driver** (``MCTS(scheduler=...)``): each forked leaf is
  admitted into the scheduler's continuous batching for its lifetime, and
  ``apply_action`` decodes through ``scheduler.generate`` — sibling leaves'
  requests coalesce into one batched engine step, while the CoW page pool
  keeps their shared prefix at zero copied bytes.

Everything is deterministic under greedy sampling: forked expansion of a
node is bit-identical to re-prefilling the node's tokens from scratch (the
differential test plane gates on exactly this).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ..core.state_manager import Sandbox

__all__ = ["DecodeSearchTask"]


class DecodeSearchTask:
    """MCTS task whose sandbox ``proc`` is a live ``PagedSession``.

    * ``propose_actions`` — the ``width`` highest-logit tokens at the node.
    * ``apply_action``    — force the pending token to the action, then
      decode ``k_tokens`` greedily (through the scheduler when the sandbox
      was admitted — ``sandbox.sched_sid`` — else directly on the engine).
    * ``evaluate``        — max softmax probability of the final logits: a
      cheap, deterministic confidence proxy in [0, 1].
    """

    def __init__(
        self,
        engine,
        *,
        scheduler=None,
        k_tokens: int = 4,
        width: int = 3,
        max_len: Optional[int] = None,
    ):
        self.engine = engine
        self.scheduler = scheduler
        self.k_tokens = int(k_tokens)
        self.width = int(width)
        # terminal guard: stop expanding before sessions outgrow max_pages
        psz = engine.pool.page_size
        cap = engine.pool.max_pages * psz
        self.max_len = int(max_len) if max_len is not None else cap - k_tokens - 1

    # ------------------------------------------------------------ protocol
    def propose_actions(self, sandbox: Sandbox, rng_seed: int) -> Sequence[Any]:
        sess = sandbox.proc
        logits = np.asarray(sess.extras["last_logits"], np.float32)
        top = np.argsort(-logits, kind="stable")[: self.width]
        return [int(t) for t in top]

    def apply_action(self, sandbox: Sandbox, action: Any) -> None:
        sched_sid = getattr(sandbox, "sched_sid", None)
        if self.scheduler is not None and sched_sid is not None:
            # the scheduler may have parked+resumed the session (identity
            # change) — always act on the live one, and rebind the sandbox
            sess = self.scheduler.session(sched_sid)
            sandbox.proc = sess
            sess.tokens[-1] = int(action)
            self.scheduler.generate(sched_sid, self.k_tokens)
            sandbox.proc = self.scheduler.session(sched_sid)
        else:
            sess = sandbox.proc
            sess.tokens[-1] = int(action)
            for _ in range(self.k_tokens):
                self.engine.step([sess])

    def evaluate(self, sandbox: Sandbox) -> float:
        sess = sandbox.proc
        logits = np.asarray(sess.extras["last_logits"], np.float64)
        z = logits - logits.max()
        p = np.exp(z)
        return float(p.max() / p.sum())

    def is_terminal(self, sandbox: Sandbox) -> bool:
        return sandbox.proc.seq_len >= self.max_len

    def is_readonly(self, action: Any) -> bool:
        return False                     # decoding always writes KV pages

    # ------------------------------------------------------------- helpers
    def decode_tokens(self, sessions: List[Any], k: int) -> List[List[int]]:
        """Batched greedy decode of ``k`` tokens for a list of sessions
        (test/benchmark convenience — one engine batch per step)."""
        out: List[List[int]] = [[] for _ in sessions]
        for _ in range(k):
            toks = self.engine.step(sessions)
            for i, t in enumerate(toks):
                out[i].append(int(t))
        return out
