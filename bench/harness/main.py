"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run needs the cards its cell asks for and exits with another code
than 0, printing no result, where they are missing.  With ``--trace 0``
it reports the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and ``breakdown``.  ``--control 1`` puts the
reference's lower-precision control in the program's place in the check,
so that the run comes out not correct (the limits' upper readings); the
benchmark's own runs leave it off.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Any, Dict, Optional

from bench.harness import registry
from bench.harness.peaks import power_limit
from bench.harness.probes import Recorder
from bench.harness.trace import DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_caches(root=registry.ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and no JAX behind a library's back."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "bench-kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "bench-torch-extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "bench-triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    import torch

    spec = registry.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {entry['chips']} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), spec=spec, control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: Dict[str, Any]) -> None:
    """The compared numbers beside their limits, last on standard error;
    the result's line last on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *,
             spec: Optional[Dict[str, Any]] = None, base=None,
             control: bool = False) -> Dict[str, Any]:
    """Run ``workload`` once on ``device`` and return its result's line.
    ``base`` is a directory whose configs/, workloads/, drivers/, ... are
    searched before ``bench/``'s (a test's own files); ``spec`` is
    BENCHMARK.json.

    The cell's driver (``drivers/<driver>.py``) does what is particular to
    its traffic:

    - ``Driver(cell, cfg, family, weights, model, seed, device, rec)``
      makes the cell's inputs from ``seed``; ``rec`` is a ``Recorder``;
    - ``setup()`` warms up every shape the window uses;
    - ``window(seconds, trace)`` measures and returns the run's records,
      which the metrics read: at least ``window_s`` and ``spans``;
      ``trace`` is a ``DeviceTrace`` to start and stop, or None;
    - ``collect()`` copies what the check compares to the host, and
      ``close()`` then frees the program's state on the device;
    - ``check(reference, control)`` holds the copies to the configuration's
      plain reference and returns ``numbers`` (those the cell's ``limits``
      name, and with ``control`` the control's as ``control_<name>``),
      ``checks`` of its own (``{name: {"value", "limit"}}``), ``attempted``,
      ``failed`` and ``info``.

    A run is correct when every number is at most its limit.  In a control
    run the control's numbers stand in the program's place."""
    import torch

    t_setup = time.perf_counter()
    on_card = device.type == "cuda"
    cell = registry.load_json("workloads", workload, base)
    cfg = registry.load_json("configs", cell["config"], base)
    family = registry.load_module("models", cfg["family"], base)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    weights = family.draw_weights(cfg, seed, device)
    model = family.build(cfg, weights, device)
    log(f"weights drawn and the port built in {time.perf_counter() - t_setup:.3f} s")
    driver = registry.load_module("drivers", cell["driver"], base).Driver(
        cell, cfg, family, weights, model, seed, device, Recorder())
    del weights, model
    try:
        driver.setup()
        setup_s = time.perf_counter() - t_setup
        log(f"set-up {setup_s:.3f} s")
        dtrace = DeviceTrace() if (trace and on_card) else None
        t_window = time.perf_counter()
        record = driver.window(seconds, dtrace)
        memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        log(f"window {record['window_s']:.3f} s, closed {time.perf_counter() - t_window:.3f} s "
            f"after it began; memory peak {memory_peak} B")
        driver.collect()
    finally:
        driver.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    verdict = driver.check(registry.load_module("reference", cfg["family"], base), control)
    del driver
    log(f"check done, {time.perf_counter() - t_setup:.3f} s into the run")
    numbers = verdict["numbers"]
    checks = {name: {"value": numbers.get(f"control_{name}" if control else name),
                     "limit": limit} for name, limit in cell["limits"].items()}
    checks.update(verdict["checks"])
    correct = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    rec = dict(record, setup_s=setup_s, trace=None)
    if dtrace is not None:
        rec["trace"] = dtrace.summary([(n, a, b) for n, a, b, _, _ in record["spans"]])
    spec = spec if spec is not None else registry.benchmark_spec()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(spec, workload, kind):
        value = registry.load_module("metrics", m["name"], base).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"]), "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["info"] = dict({"power": power_limit() if on_card else None, "seed": seed,
                           "control": control, "setup_s": setup_s,
                           "window_s": record["window_s"]}, **verdict["info"])
    result["checks"] = checks
    return result
