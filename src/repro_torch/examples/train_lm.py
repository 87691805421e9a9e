"""End-to-end training driver: train an LM with DeltaState fault
tolerance, on the port.

Trains a reduced olmo-family model on the synthetic packed stream, taking
coupled async checkpoints, then *kills* the run mid-flight and restarts
from the last complete generation — the restart path end to end.

Defaults are sized for a CPU (~12M params, 120 steps); scale
``--layers/--d-model/--steps`` up on the card (``--steps 300`` trains a
~100M model for a few hundred steps with the same code path).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 120] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import Stage
from repro_torch.core.deltacr import resolve_device
from repro_torch.models import Model
from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step to demo restart")
    ap.add_argument("--device", default=None, help="'cpu' to train on the CPU (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.examples.train_lm: {exc}", file=sys.stderr)
        return 2

    base = get_config("olmo-1b").tiny()
    cfg = dataclasses.replace(
        base,
        name="train-lm-demo",
        stages=(Stage(period=(("attn", "mlp"),), n_periods=args.layers),),
        d_model=args.d_model,
        n_heads=4,
        n_kv_heads=4,
        head_dim=args.d_model // 4,
        d_ff=args.d_ff,
        vocab_size=args.vocab,
        mrope_sections=None,
    )
    model = Model(cfg, device=device)
    print(f"model: {model.param_count()/1e6:.1f}M params, {cfg.n_layers} layers")

    trainer = Trainer(
        model,
        OptimizerConfig(peak_lr=3e-4, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch),
        TrainerConfig(steps=args.steps, ckpt_every=20, log_every=10),
    )
    params, opt, err = trainer.init_state(0)

    fail_at = args.fail_at if args.fail_at is not None else (args.steps * 2) // 3
    t0 = time.time()
    try:
        params, opt, err, step = trainer.run(params, opt, err, fail_at=fail_at)
    except RuntimeError as exc:
        print(f"!! {exc} — restoring from the last complete checkpoint")
        params, opt, err, step = trainer.restore_latest()
        print(f"resumed at step {step} (data cursor restored with it)")
        params, opt, err, step = trainer.run(params, opt, err, start_step=step)
    dt = time.time() - t0

    losses = [f"{m['step']}:{m['loss']:.3f}" for m in trainer.metrics_log]
    print(f"finished {step} steps in {dt:.0f}s")
    print("loss curve:", " ".join(losses))
    stats = trainer.fs.store.stats
    print(
        f"checkpoint store: physical={stats.physical_bytes/1e6:.1f}MB "
        f"across {len(trainer.ckpt_index)} generations "
        f"(straggler flags: {trainer.watchdog.flagged})"
    )
    assert trainer.metrics_log[-1]["loss"] < trainer.metrics_log[0]["loss"], "loss must drop"
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
