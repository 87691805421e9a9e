"""Find a cell's files by name.

Everything that belongs to one configuration, one cell, one driver or one
metric lives in a file of its own under ``bench/``, named after it:

    configs/<config>.json      the configuration as it is run
    models/<family>.py         builds it in the port (the system under test)
    reference/<family>.py      its plain reference
    workloads/<cell>.json      the cell: configuration, driver, traffic, limits
    drivers/<driver>.py        the loop the measured window drives, and its check
    metrics/<metric>.py        one metric: ``read(rec) -> float | None``

A later change adds files and entries; it edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str, base: Optional[Path]) -> Path:
    """``<kind>/<name><suffix>`` in ``base`` (a test's own files), else in
    ``bench/``."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    for root in ([Path(base)] if base is not None else []) + [BENCH]:
        path = root / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")


def load_json(kind: str, name: str, base: Optional[Path] = None) -> Dict[str, Any]:
    with open(_path(kind, name, ".json", base)) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Optional[Path] = None):
    path = _path(kind, name, ".py", base)
    mod_name = "bench_" + kind + "_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec(path: Optional[Path] = None) -> Dict[str, Any]:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` entries of ``spec`` that ``cell``
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]
