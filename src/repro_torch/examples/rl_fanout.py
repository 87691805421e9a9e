"""RL training step with warm-template rollout fan-out (paper §6.2.2), on
the port.

Each step: fork N rollout sessions from one warm template (page-table
copy), generate completions, score them, REINFORCE-update the policy,
tear down.  The fork primitive keeps the accelerator busy: sandbox time
is microseconds against seconds of generation/training.  On the card pass
a full-width ``--arch`` (``olmo-1b``): its ``paged_attention`` takes head
dims 64, 128 and 256, and the ``-tiny`` configs have 16.

    PYTHONPATH=src python -m repro_torch.examples.rl_fanout [--steps 3 --rollouts 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.deltacr import resolve_device
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.search import fork_n, sync_gpu_occupation
from repro_torch.serve import Engine, PagePool, SamplingParams
from repro_torch.train.optim import OptimizerConfig, adamw_init, adamw_update, tree_leaves, tree_map


def reward_fn(tokens):
    """Toy reward: prefer token diversity in the completion."""
    return len(set(tokens)) / max(len(tokens), 1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.rl_fanout")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rollouts", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=6)
    ap.add_argument("--arch", default="olmo-1b-tiny")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.examples.rl_fanout: {exc}", file=sys.stderr)
        return 2

    cfg = get_config(args.arch)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_cfg = OptimizerConfig(peak_lr=1e-4, warmup_steps=2, total_steps=100)
    opt_state = adamw_init(params, opt_cfg)
    pool = PagePool(cfg, num_pages=4096, page_size=8, max_pages_per_session=32, device=device)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]

    def reinforce_loss(p, tokens, advantage):
        toks = torch.as_tensor([tokens], dtype=torch.int32, device=device)
        hidden, _ = model._forward(p, toks[:, :-1], None, False)
        hidden = L.apply_norm(cfg.norm, p["final_norm"], hidden)
        head = p["embed"] if cfg.tie_embeddings else p["lm_head"]
        logits = hidden.float() @ head.float().T
        logp = torch.log_softmax(logits, dim=-1)
        gold = logp.gather(-1, toks[:, 1:, None].long())[..., 0]
        return -advantage * gold.mean()

    def grad_fn(p, tokens, advantage):
        tree = tree_map(lambda t: t.detach().requires_grad_(), p)
        leaves = tree_leaves(tree)
        grads = torch.autograd.grad(reinforce_loss(tree, tokens, advantage), leaves)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return tree_map(lambda t: by_leaf[id(t)], tree)

    for step in range(args.steps):
        model.params = params
        engine = Engine(model, pool)
        template = engine.new_session(prompt, SamplingParams(temperature=1.0, seed=step))

        # --- fan-out: N forks from the warm template -----------------------
        t0 = time.perf_counter()
        children, fan = fork_n(template, args.rollouts)
        t_sandbox = time.perf_counter() - t0

        # --- rollouts (distinct RNG per child -> distinct trajectories) ----
        t0 = time.perf_counter()
        rewards = []
        for i, child in enumerate(children):
            child.extras["rng_seed"] = np.asarray([1000 * step + i], np.int64)
            child.extras["rng_counter"] = np.asarray([0], np.int64)
            engine.generate(child, args.gen_tokens)
            rewards.append(reward_fn(child.tokens[len(prompt):]))
        t_gen = time.perf_counter() - t0

        # --- REINFORCE update on advantage-weighted trajectories -----------
        t0 = time.perf_counter()
        baseline = float(np.mean(rewards))
        gsum = tree_map(torch.zeros_like, params)
        for child, r in zip(children, rewards):
            g = grad_fn(params, child.tokens, r - baseline)
            gsum = tree_map(torch.add, gsum, g)
        grads = tree_map(lambda g: g / len(children), gsum)
        params, opt_state, info = adamw_update(params, grads, opt_state, opt_cfg)
        t_train = time.perf_counter() - t0

        for child in children:
            child.release()
        template.release()
        occ = sync_gpu_occupation(t_sandbox, t_gen, t_train)
        print(
            f"step {step}: fork_p50={fan.p50_ms:.3f}ms sandbox={t_sandbox*1e3:.1f}ms "
            f"gen={t_gen:.2f}s train={t_train:.2f}s occupation={occ:.3f} "
            f"mean_reward={baseline:.3f}"
        )
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
