"""MCTS tree search over a *real* LM serving session with C/R-protected
state, on the port.

An agent session (paged KV cache + sampling state) plus a repo filesystem
is explored with UCT: every expansion checkpoints, every selection rolls
back.  Forked branches share KV pages copy-on-write.  On the card pass a
full-width ``--arch`` (``olmo-1b``): its ``paged_attention`` takes head
dims 64, 128 and 256, and the ``-tiny`` configs have 16.

    PYTHONPATH=src python -m repro_torch.examples.mcts_search [--iterations 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DeltaCR, DeltaFS, Sandbox, StateManager
from repro_torch.core.deltacr import resolve_device
from repro_torch.models import Model
from repro_torch.search import MCTS, MCTSConfig
from repro_torch.serve import Engine, PagedSession, PagePool, SamplingParams


class LMAgentTask:
    """Actions = sampled continuations from the LM; the engine session *is*
    the process state (forked through the page pool)."""

    def __init__(self, engine: Engine, tokens_per_action: int = 4):
        self.engine = engine
        self.tokens_per_action = tokens_per_action

    def propose_actions(self, sandbox, rng_seed):
        rng = np.random.default_rng(rng_seed)
        return [int(s) for s in rng.integers(0, 1 << 30, size=3)]

    def apply_action(self, sandbox, action):
        sess: PagedSession = sandbox.proc
        sess.extras["rng_seed"] = np.asarray([action], np.int64)
        sess.extras["rng_counter"] = np.asarray([0], np.int64)
        for _ in range(self.tokens_per_action):
            self.engine.step([sess])
        # leave a durable trace of the trajectory in the repo
        sandbox.fs.write("repo/trajectory", np.asarray(sess.tokens, np.int64))

    replay_action = apply_action

    def evaluate(self, sandbox):
        sess: PagedSession = sandbox.proc
        toks = sess.tokens[-self.tokens_per_action :]
        return float(len(set(toks))) / max(len(toks), 1)     # diversity reward

    def is_terminal(self, sandbox):
        return sandbox.proc.seq_len > 96

    def is_readonly(self, action):
        return False


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.mcts_search")
    ap.add_argument("--iterations", type=int, default=15)
    ap.add_argument("--arch", default="olmo-1b-tiny")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.examples.mcts_search: {exc}", file=sys.stderr)
        return 2

    cfg = get_config(args.arch)
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    pool = PagePool(cfg, num_pages=1024, page_size=8, max_pages_per_session=32, device=device)
    engine = Engine(model, pool)

    fs = DeltaFS(chunk_bytes=4096)
    fs.write("repo/readme", np.arange(1000, dtype=np.int32))
    session = engine.new_session([1, 2, 3, 4, 5, 6, 7], SamplingParams(temperature=0.8))
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        template_pool_size=16,
    )
    sm = StateManager(Sandbox(fs, session), cr)
    task = LMAgentTask(engine)
    sm.action_applier = lambda sb, act: task.replay_action(sb, act)

    t0 = time.time()
    mcts = MCTS(sm, task, MCTSConfig(iterations=args.iterations, value_isolation=False, seed=7))
    st = mcts.run()
    cr.wait_dumps()
    best = mcts.best_leaf()
    print(
        f"{st.iterations} iterations in {time.time()-t0:.1f}s | nodes={st.nodes} "
        f"restores={st.restores} (fast={st.fast_restores}) best_value={st.best_value:.2f}"
    )
    print(f"CoW page copies: {pool.cow_copies}, warm-absorbed: {pool.warm_copies}")
    print(f"free pages: {pool.free_pages()}/{pool.num_pages}")
    if best is not None:
        sm.restore(best)
        print("best trajectory tokens:", sm.sandbox.proc.tokens[:24], "...")
    cr.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
