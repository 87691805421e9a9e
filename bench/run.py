#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; ``bench/README.md`` says what a run does
and prints, and how a configuration, a cell or a metric is added.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
