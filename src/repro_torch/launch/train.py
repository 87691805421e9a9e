"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--tiny] [--steps N] [--seq-len L] [--global-batch B] [--ckpt-every K]
[--device cpu]``.

Trains on the card unless ``--device cpu`` is given; without a card and
without that flag it exits non-zero.  The sequence length and global batch
default to the config's first shape (``train_4k`` for the full-size
configs: 4096 × 256, which needs more than one card's memory for most
archs; pass smaller ones to fit).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--tiny", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="'cpu' to train on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.deltacr import resolve_device
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.train: {exc}", file=sys.stderr)
        return 2
    cfg = get_config(args.arch + ("-tiny" if args.tiny else ""))
    shape = cfg.shapes[0]
    seq = args.seq_len or shape.seq_len
    batch = args.global_batch or shape.global_batch
    model = Model(cfg, device=device)
    trainer = Trainer(
        model,
        OptimizerConfig(total_steps=args.steps),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every),
    )
    params, opt, err = trainer.init_state(0)
    params, opt, err, step = trainer.run(params, opt, err)
    print(f"done at step {step}; last loss {trainer.metrics_log[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
