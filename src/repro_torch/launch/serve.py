"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--prompt T ...] [--tokens N] [--sessions K] [--temperature t] [--device cpu]``.

Stands up the paged-CoW engine and serves batched requests with
forkable, C/R-protected sessions: ``--sessions`` sessions on one prompt,
each sampling with its own seed, decoded together until each holds the
prompt and ``--tokens`` generated tokens.  Serves on the card unless
``--device cpu`` is given; without a card and without that flag it exits
2.  The card's ``paged_attention`` takes head dims 64, 128 and 256, so the
``-tiny`` configs (head dim 16) serve only on the CPU; pass a full-width
``--arch`` (``olmo-1b``) there.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo-1b-tiny")
    ap.add_argument("--prompt", type=int, nargs="*", default=[1, 2, 3, 4])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default=None, help="'cpu' to serve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.deltacr import resolve_device
    from repro_torch.models import Model
    from repro_torch.serve import Engine, PagePool, SamplingParams

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.serve: {exc}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch)
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    pool = PagePool(cfg, num_pages=4096, page_size=16,
                    max_pages_per_session=max(8, (len(args.prompt) + args.tokens) // 16 + 2),
                    device=device)
    engine = Engine(model, pool)
    sessions = [
        engine.new_session(args.prompt, SamplingParams(temperature=args.temperature, seed=i))
        for i in range(args.sessions)
    ]
    for _ in range(args.tokens - 1):
        engine.step(sessions)
    for i, s in enumerate(sessions):
        print(f"session {i}: {s.tokens}")
        s.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
