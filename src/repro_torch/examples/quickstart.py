"""Quickstart: DeltaState in 60 lines, on the port.

A sandbox is a coupled (DeltaFS filesystem, forkable process state) pair.
Checkpoints duplicate only deltas; rollback is O(1); dumps are async.  The
agent heap is a device tensor (``CowTensorState``) on the card, or on the
CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    CowTensorState,
    DeltaCR,
    DeltaFS,
    Sandbox,
    StateManager,
    reachability_gc,
)
from repro_torch.core.deltacr import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.examples.quickstart: {exc}", file=sys.stderr)
        return 2

    # --- build a sandbox: repo tensors (durable) + agent heap (ephemeral)
    fs = DeltaFS(chunk_bytes=4096)
    fs.write("repo/main.py", np.arange(50_000, dtype=np.int32))
    proc = CowTensorState({"heap": torch.zeros(1_000_000, dtype=torch.float32)},
                          hot_keys=("heap",), device=device)
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: CowTensorState(p, device=device),
        template_pool_size=8,
    )
    sm = StateManager(Sandbox(fs, proc), cr)

    # --- checkpoint, mutate, checkpoint
    c1 = sm.checkpoint()                      # O(1) layer freeze + template fork
    sm.sandbox.fs.write("repo/main.py", np.ones(50_000, np.int32))
    sm.sandbox.proc.mutate("heap", lambda h: h.__setitem__(slice(0, 10), 1.0))
    c2 = sm.checkpoint()

    # --- rollback: coupled, millisecond-class, arbitrary target
    mode = sm.restore(c1)
    assert sm.sandbox.fs.read("repo/main.py")[0] == 0
    assert float(sm.sandbox.proc.get("heap")[0]) == 0.0
    print(f"restored c1 via {mode} path")

    mode = sm.restore(c2)
    assert float(sm.sandbox.proc.get("heap")[0]) == 1.0
    print(f"restored c2 via {mode} path")

    # --- value-time test isolation: side effects rolled back unconditionally
    def run_tests(sb):
        sb.fs.write("repo/__pycache__", np.zeros(8, np.int8))
        return 0.83

    value = sm.isolated_eval(run_tests)
    assert not sm.sandbox.fs.exists("repo/__pycache__")
    print(f"isolated eval -> {value}, side effects undone")

    # --- storage is delta-based
    cr.wait_dumps()
    stats = fs.store.stats
    print(f"physical={stats.physical_bytes/1e6:.2f} MB "
          f"logical={stats.logical_bytes/1e6:.2f} MB "
          f"(sharing={stats.logical_bytes/max(stats.physical_bytes,1):.1f}x)")
    reachability_gc(sm)
    cr.shutdown()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
