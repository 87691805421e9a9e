#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases:

1. device — name, count, torch/CUDA versions, ``nvidia-smi`` name and power
   limit;
2. build — compiles ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc`` per
   source, in parallel) and prints the build time and ``ptxas`` report;
3. kernels — ``delta_fused``, ``delta_diff`` and ``delta_apply`` against their
   plain PyTorch versions on the card, bit-exact (``torch.equal`` on every
   output), at the main path's shapes and at edge shapes, then timed with
   CUDA events: each kernel captured in a CUDA graph, so host time stays out
   of its reading (median over many replays, L2 flushed before each, plus a
   warm reading of back-to-back launches);
4. main path — ``StateManager(Sandbox(DeltaFS, CowTensorState), DeltaCR)``
   on the card with the KV cache of the JAX package's ``qwen3-14b`` config at
   full width for one 8192-token session plus a 256 MiB heap: 8 agent turns,
   a checkpoint after each, a fast rollback and a slow (image) restore, all
   restored bytes checked against device copies;
5. report — one JSON line per kernel, the ``{"kernels": [...]}`` line, the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line is printed.  The script
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at a 700 W power limit

# -- the KV cache of the JAX package's src/repro/configs/qwen3_14b.py, full width
QWEN3_14B_LAYERS = 40
QWEN3_14B_KV_HEADS = 8
QWEN3_14B_HEAD_DIM = 128
SESSION_TOKENS = 8192          # one agent session
HEAP_BYTES = 256 << 20         # float32 device heap
N_FILES = 300                  # small DeltaFS files
TURNS = 8
TOKENS_PER_TURN = 256          # 8 rows of 64 KiB per KV tensor
PREFIX_TOKENS = 4096           # session tokens already in the cache
HEAP_ROW_FRAC = 0.01           # heap rows rewritten per turn
CHUNK_BYTES = 64 * 1024        # DeltaCR's default chunk


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------
def _as_i64(t):
    import torch

    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if t.dtype.is_floating_point:
        return t.to(torch.float64)
    return t.to(torch.int64)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over every output; fails unless bit-exact."""
    import torch

    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}"
            )
        if g.numel():
            err = max(err, float((_as_i64(g) - _as_i64(w)).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"outputs differ (max abs err {err})")
    return err


def time_ms(fn, *, flush, iters: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` in ms, CUDA events around each call after a
    memset of ``flush`` (a buffer larger than the L2).  The reading holds
    the host's time for the call as well where the call synchronises or the
    host falls behind the card: the plain versions are timed this way."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_graph_ms(fn, *, flush, iters: int = 40, batch: int = 20) -> tuple:
    """Device time of ``fn`` in ms, with no host time in it: ``fn`` is
    captured in a CUDA graph, so a timed replay is one short host call
    while the card is still busy with the memset of ``flush`` before it.

    Returns (cold, warm): ``cold`` is the median over ``iters`` replays of
    one call, each after the memset has evicted the L2; ``warm`` is one
    replay of ``batch`` calls captured back to back, divided by ``batch``."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    one, many = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(one):
        fn()
    with torch.cuda.graph(many):
        for _ in range(batch):
            fn()
    one.replay()
    many.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one.replay()
        end.record()
        pairs.append((start, end))
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    many.replay()
    end.record()
    torch.cuda.synchronize()
    cold = statistics.median(s.elapsed_time(e) for s, e in pairs)
    warm = start.elapsed_time(end) / batch
    del one, many
    return cold, warm


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _dirty_pair(gen, N: int, C: int, dirty_rows, device, *, misaligned=False):
    import torch

    if misaligned:          # a contiguous grid whose data pointer is not 16-aligned
        old = torch.empty(N * C + 1, dtype=torch.uint8, device=device)[1:].view(N, C)
        old.copy_(torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8))
    else:
        old = torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8)
    new = old.clone()
    if len(dirty_rows):
        rows = torch.as_tensor(list(dirty_rows), device=device)
        new[rows, 0] ^= 0x5A          # one byte per dirty row
        new[rows, -1] ^= 0x01
    return old, new


def check_kernels(device) -> dict:
    """Every output of each kernel equals its plain version, bit for bit.
    Returns the largest error seen per kernel (0.0 when all pass)."""
    import torch

    from repro_torch.kernels import delta_apply, delta_diff, delta_fused, ref  # noqa: F401

    gen = torch.Generator(device=device).manual_seed(1234)
    errs = {"delta_fused": 0.0, "delta_diff": 0.0, "delta_apply": 0.0}

    def rows(N, k):
        return torch.randperm(N, generator=gen, device=device)[:k].tolist()

    def fused_case(N, C, dirty, cap, **kw):
        old, new = _dirty_pair(gen, N, C, dirty, device, **kw)
        got = delta_fused(old, new, max_changed=cap)
        want = ref.fused_encode_ref(old, new, cap)
        errs["delta_fused"] = max(errs["delta_fused"], max_abs_err(got, want))
        if int(got[2]) != len(dirty):
            raise AssertionError(f"fused count {int(got[2])} != {len(dirty)}")

    def diff_case(N, C, dirty, **kw):
        old, new = _dirty_pair(gen, N, C, dirty, device, **kw)
        errs["delta_diff"] = max(
            errs["delta_diff"], max_abs_err(delta_diff(old, new), ref.delta_diff_ref(old, new))
        )

    def apply_case(N, C, n_valid, M, dtype=torch.uint8):
        base = torch.randint(-100, 100, (N, C), generator=gen, device=device).to(dtype)
        data = torch.randint(-100, 100, (M, C), generator=gen, device=device).to(dtype)
        idx = torch.full((M,), -1, dtype=torch.int32, device=device)
        idx[:n_valid] = torch.randperm(N, generator=gen, device=device)[:n_valid].to(torch.int32)
        want = ref.delta_apply_ref(base, data, idx)
        got = delta_apply(base.clone(), data, idx)
        errs["delta_apply"] = max(errs["delta_apply"], max_abs_err(got, want))

    # main-path shapes
    fused_case(256, 65536, rows(256, 8), 128)
    diff_case(4096, 65536, rows(4096, 41))
    apply_case(256, 65536, 8, 8)
    apply_case(256, 65536, 41, 64)
    apply_case(4096, 65536, 41, 64)
    # edge shapes: the sweeps of the JAX package's tests/test_kernels.py
    for N, C in [(8, 128), (37, 256), (5, 64), (64, 512), (1, 128), (37, 100)]:
        n_dirty = max(1, N // 3)
        fused_case(N, C, rows(N, n_dirty), n_dirty + 2)
        diff_case(N, C, rows(N, n_dirty))
        for dtype in (torch.uint8, torch.float32, torch.bfloat16, torch.int32):
            apply_case(N, C, n_dirty, n_dirty + 2, dtype)
    fused_case(16, 64, list(range(16)), 4)                # overflow: count > cap
    fused_case(37, 256, [], 4)                            # all clean
    fused_case(37, 256, list(range(37)), 64)              # all dirty, cap > N
    fused_case(1000, 96, rows(1000, 300), 512)            # scan over several tiles
    fused_case(37, 256, rows(37, 9), 16, misaligned=True) # scalar path
    diff_case(37, 256, [])
    diff_case(37, 256, list(range(37)))
    diff_case(37, 256, rows(37, 9), misaligned=True)
    apply_case(64, 512, 0, 8)                             # only -1 padding
    torch.cuda.synchronize()
    return errs


def time_kernels(device) -> dict:
    """kernel / plain / library times at the main path's shapes."""
    import torch

    from repro_torch.kernels import delta_apply, delta_diff, delta_fused, ref  # noqa: F401

    gen = torch.Generator(device=device).manual_seed(99)
    # 512 MiB: evicts the 50 MB L2 before each timed call
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    out = {}

    def timed(kernel, plain, library=None):
        cold, warm = time_graph_ms(kernel, flush=flush)
        return {
            "kernel_ms": cold,
            "kernel_warm_ms": warm,
            "plain_ms": time_ms(plain, flush=flush),
            "library_ms": time_graph_ms(library, flush=flush)[0] if library else None,
        }

    N, C, cap = 256, 65536, 128
    dirty = torch.randperm(N, generator=gen, device=device)[:8].tolist()
    old, new = _dirty_pair(gen, N, C, dirty, device)
    out["delta_fused"] = {
        "shape": [N, C, cap],
        **timed(lambda: delta_fused(old, new, max_changed=cap),
                lambda: ref.fused_encode_ref(old, new, cap)),
        "bound_ms": bound_ms(2 * N * C + cap * C + cap * 4 + 4 + cap * 16),
    }

    N, C = 4096, 65536
    dirty = torch.randperm(N, generator=gen, device=device)[:41].tolist()
    old, new = _dirty_pair(gen, N, C, dirty, device)
    out["delta_diff"] = {
        "shape": [N, C],
        **timed(lambda: delta_diff(old, new), lambda: ref.delta_diff_ref(old, new)),
        "bound_ms": bound_ms(2 * N * C + N),
    }
    del old, new

    for (N, C, n_valid, M), key in (
        ((256, 65536, 8, 8), "delta_apply"),
        ((4096, 65536, 41, 64), "delta_apply_heap"),
    ):
        base = torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8)
        data = torch.randint(0, 256, (M, C), generator=gen, device=device, dtype=torch.uint8)
        idx = torch.full((M,), -1, dtype=torch.int32, device=device)
        idx[:n_valid] = torch.randperm(N, generator=gen, device=device)[:n_valid].to(torch.int32)
        valid_idx = idx[:n_valid].to(torch.int64)
        valid_data = data[:n_valid]
        out[key] = {
            "shape": [N, C, M],
            **timed(lambda: delta_apply(base, data, idx),
                    lambda: ref.delta_apply_ref(base, data, idx),
                    lambda: base.index_copy_(0, valid_idx, valid_data)),
            "bound_ms": bound_ms(2 * n_valid * C + 4 * M),
        }
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at real size
# ---------------------------------------------------------------------------
def run_main_path(
    device,
    *,
    layers: int = QWEN3_14B_LAYERS,
    kv_heads: int = QWEN3_14B_KV_HEADS,
    head_dim: int = QWEN3_14B_HEAD_DIM,
    session_tokens: int = SESSION_TOKENS,
    prefix_tokens: int = PREFIX_TOKENS,
    tokens_per_turn: int = TOKENS_PER_TURN,
    heap_bytes: int = HEAP_BYTES,
    n_files: int = N_FILES,
    turns: int = TURNS,
    chunk_bytes: int = CHUNK_BYTES,
    seed: int = 0,
) -> dict:
    """Drive StateManager(Sandbox(DeltaFS, CowTensorState), DeltaCR) through
    ``turns`` agent turns with a checkpoint after each, then a fast rollback
    and a slow restore; assert every restored byte.  Returns the metrics."""
    import numpy as np
    import torch

    from repro_torch.core import (
        CowTensorState,
        DeltaCR,
        DeltaFS,
        DumpPolicy,
        Sandbox,
        StateManager,
    )

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    token_bytes = kv_heads * head_dim * 2
    assert chunk_bytes % token_bytes == 0
    tokens_per_row = chunk_bytes // token_bytes
    assert prefix_tokens % tokens_per_row == 0 and tokens_per_turn % tokens_per_row == 0
    kv_rows_per_turn = tokens_per_turn // tokens_per_row
    heap_rows = heap_bytes // chunk_bytes
    heap_touch = max(1, int(round(heap_rows * HEAP_ROW_FRAC)))

    tensors = {}
    for layer in range(layers):
        for kind in ("k", "v"):
            kv = torch.zeros(
                (session_tokens, kv_heads, head_dim), dtype=torch.bfloat16, device=device
            )
            kv[:prefix_tokens] = torch.randn(
                (prefix_tokens, kv_heads, head_dim), generator=gen, device=device
            ).to(torch.bfloat16)
            tensors[f"layer{layer}/{kind}"] = kv
    tensors["heap"] = torch.randn(heap_bytes // 4, generator=gen, device=device)

    fs = DeltaFS(chunk_bytes=chunk_bytes)     # DeltaCR dumps in the store's chunks
    for i in range(n_files):
        size = int(rng.integers(64, 1024))
        fs.write(f"repo/file{i}.py", rng.integers(0, 2**31, size=size, dtype=np.int32))
    proc = CowTensorState(tensors, device=device)
    del tensors
    cr = DeltaCR(
        store=fs.store,
        restore_fn=lambda p: CowTensorState(p, device=device),
        policy=DumpPolicy(mode="delta"),
        chunk_bytes=chunk_bytes,
    )
    sm = StateManager(Sandbox(fs, proc), cr)
    n_tensors = 2 * layers + 1
    want_dirty = 2 * layers * kv_rows_per_turn + heap_touch

    def snapshot():
        state = sm.sandbox.proc
        files = {k: sm.sandbox.fs.read(k) for k in sm.sandbox.fs.keys()}
        return {k: state.get(k).clone() for k in state.keys()}, files

    def check_restored(saved, what):
        tensors_want, files_want = saved
        state = sm.sandbox.proc
        if sorted(state.keys()) != sorted(tensors_want):
            raise AssertionError(f"{what}: restored keys differ")
        for k, t in tensors_want.items():
            if not torch.equal(state.get(k), t):
                raise AssertionError(f"{what}: tensor {k} differs")
        if sorted(sm.sandbox.fs.keys()) != sorted(files_want):
            raise AssertionError(f"{what}: file set differs")
        for k, a in files_want.items():
            if not np.array_equal(sm.sandbox.fs.read(k), a):
                raise AssertionError(f"{what}: file {k} differs")

    ckpt_ms, dump_ms, d2h, stages = [], [], [], []
    saved = {}
    sync()
    torch.cuda.reset_peak_memory_stats() if torch.device(device).type == "cuda" else None
    ckpts = [sm.checkpoint()]
    cr.wait_dumps()
    pos = prefix_tokens
    for turn in range(turns):
        # -- the agent's turn: 256 new tokens in every KV tensor, ~1% of the
        #    heap rows rewritten, one file rewritten
        for layer in range(layers):
            for kind in ("k", "v"):
                new_kv = torch.randn(
                    (tokens_per_turn, kv_heads, head_dim), generator=gen, device=device
                ).to(torch.bfloat16)
                sm.sandbox.proc.mutate(
                    f"layer{layer}/{kind}",
                    lambda t, v=new_kv, p=pos: t[p : p + tokens_per_turn].copy_(v),
                )
        pos += tokens_per_turn
        touched = torch.randperm(heap_rows, generator=gen, device=device)[:heap_touch]
        floats_per_row = chunk_bytes // 4
        offs = touched * floats_per_row + torch.randint(
            0, floats_per_row - 16, (heap_touch,), generator=gen, device=device
        )
        cols = offs[:, None] + torch.arange(16, device=device)[None, :]
        vals = torch.randn((heap_touch, 16), generator=gen, device=device)
        sm.sandbox.proc.mutate(
            "heap", lambda t: t.index_put_((cols.reshape(-1),), vals.reshape(-1))
        )
        f = f"repo/file{int(rng.integers(n_files))}.py"
        sm.sandbox.fs.write(f, rng.integers(0, 2**31, size=512, dtype=np.int32))
        sync()
        # -- checkpoint: fork + async dump; then wait for the dump to land
        kernel_before, full_before = cr.stats.kernel_keys, cr.stats.full_keys
        d2h_before = cr.pipeline.d2h_bytes
        t0 = time.perf_counter()
        c = sm.checkpoint()
        t1 = time.perf_counter()
        cr.wait_dumps()
        sync()
        t2 = time.perf_counter()
        ckpts.append(c)
        ckpt_ms.append((t1 - t0) * 1e3)
        dump_ms.append((t2 - t0) * 1e3)
        d2h.append(cr.pipeline.d2h_bytes - d2h_before)
        image = cr.dump_future(c).result()
        stages.append((image.wall_ms, image.encode_ms, image.drain_ms, image.commit_ms,
                       image.stream_windows))
        if image.mode != "delta":
            raise AssertionError(f"checkpoint {c}: mode {image.mode}, expected delta")
        if image.dirtied_chunks != want_dirty:
            raise AssertionError(
                f"checkpoint {c}: {image.dirtied_chunks} dirtied chunks, expected {want_dirty}"
            )
        if cr.stats.kernel_keys - kernel_before != n_tensors or cr.stats.full_keys != full_before:
            raise AssertionError(
                f"checkpoint {c}: kernel_keys +{cr.stats.kernel_keys - kernel_before}, "
                f"full_keys +{cr.stats.full_keys - full_before}; expected +{n_tensors} / +0"
            )
        if turn in (turns - 4, turns - 2):
            saved[c] = snapshot()
    first = cr.dump_future(ckpts[0]).result()
    if first.mode != "delta" or cr.stats.full_keys != n_tensors:
        raise AssertionError(f"first image: mode {first.mode}, full_keys {cr.stats.full_keys}")

    fast_c, slow_c = ckpts[turns - 3], ckpts[turns - 1]
    assert set(saved) == {fast_c, slow_c}
    # -- fast rollback: fork of the live template (median of a few, since
    #    a sub-ms host path is at the mercy of the host's scheduler)
    fast = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        mode = sm.restore(fast_c)
        sync()
        fast.append((time.perf_counter() - t0) * 1e3)
        if mode != "fast":
            raise AssertionError(f"rollback to {fast_c} took the {mode} path")
    fast_ms = statistics.median(fast)
    check_restored(saved[fast_c], f"fast restore of {fast_c}")
    # -- slow restore: drop the template, rebuild from the image with
    #    delta_apply over the parent generation
    if not cr.evict_template(slow_c):
        raise AssertionError(f"no template to evict for {slow_c}")
    sync()
    t0 = time.perf_counter()
    mode = sm.restore(slow_c)
    sync()
    slow_ms = (time.perf_counter() - t0) * 1e3
    if mode != "slow":
        raise AssertionError(f"restore of {slow_c} took the {mode} path")
    check_restored(saved[slow_c], f"slow restore of {slow_c}")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None
    health = cr.health()
    cr.shutdown()
    return {
        "state_bytes": int(sum(t.nbytes for t in saved[slow_c][0].values())),
        "kv_tensors": 2 * layers,
        "files": n_files,
        "checkpoints": len(ckpts),
        "dirtied_chunks_per_checkpoint": want_dirty,
        "checkpoint_call_ms_median": statistics.median(ckpt_ms),
        "dump_complete_ms_median": statistics.median(dump_ms),
        "fast_restore_ms_median": fast_ms,
        "slow_restore_ms": slow_ms,
        "d2h_bytes_per_checkpoint_median": statistics.median(d2h),
        # the dump worker's own stage clocks (median over the delta dumps):
        # encode = kernel launches + control copies, drain = row fetch +
        # checksum verify + blake2b, commit = store folds
        "dump_wall_ms_median": statistics.median(x[0] for x in stages),
        "encode_ms_median": statistics.median(x[1] for x in stages),
        "drain_ms_median": statistics.median(x[2] for x in stages),
        "commit_ms_median": statistics.median(x[3] for x in stages),
        "stream_windows_median": statistics.median(x[4] for x in stages),
        "max_memory_allocated": peak,
        "fused_checksum_mismatches": health.get("fused_checksum_mismatches"),
        "dump_retries": health["dump_retries"],
    }


def run_auto_turns(device, turns: int = 3) -> dict:
    """A few turns under DumpPolicy(mode="auto"): its per-dump selections,
    printed for information only (once calibrated it may pick "copy")."""
    import torch

    from repro_torch.core import CowTensorState, DeltaCR, DumpPolicy

    gen = torch.Generator(device=device).manual_seed(7)
    state = CowTensorState(
        {f"t{i}": torch.randn(4 << 20, generator=gen, device=device) for i in range(4)},
        device=device,
    )
    cr = DeltaCR(
        restore_fn=lambda p: CowTensorState(p, device=device), policy=DumpPolicy(mode="auto")
    )
    cr.checkpoint(state, 1, None)
    for c in range(2, 2 + turns):
        state.mutate(f"t{c % 4}", lambda t: t[: 1 << 16].add_(1.0))
        cr.checkpoint(state, c, c - 1)
    cr.wait_dumps()
    modes = [cr.dump_future(c).result().mode for c in range(1, 2 + turns)]
    cr.shutdown()
    return {"auto_modes": modes}


# ---------------------------------------------------------------------------
def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    # -- phase 1: device
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stdout.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say(f"[1 device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi_line}")

    # -- phase 2: build
    t0 = time.perf_counter()
    _build.library()
    say(f"[2 build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s) under {_build.build_dir()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"[2 build]   {line.strip()}")

    # -- phase 3: kernels against their plain versions, then times
    errs = check_kernels(device)
    say(f"[3 kernels] bit-exact against the plain versions: {json.dumps(errs)}")
    times = time_kernels(device)
    torch.cuda.empty_cache()

    # -- phase 4: the main path (launch counts taken over exactly this run)
    reset_launch_counts()
    metrics = run_main_path(device)
    launches = launch_counts()
    say(f"[4 main path] launches {json.dumps(launches)}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    card = f"{smi_line}"
    say(f"[4 main path] {json.dumps(metrics)} (card: {card})")
    say(f"[4 main path] auto mode, for information: {json.dumps(run_auto_turns(device))}")

    # -- phase 5: report
    kernels = []
    meta = {
        "delta_fused": ("src/repro_torch/kernels/csrc/delta_fused.cu",
                        "src/repro/kernels/delta_fused.py:71"),
        "delta_diff": ("src/repro_torch/kernels/csrc/delta_diff.cu",
                       "src/repro/kernels/delta_diff.py:26"),
        "delta_apply": ("src/repro_torch/kernels/csrc/delta_apply.cu",
                        "src/repro/kernels/delta_apply.py:28"),
    }
    for key, t in times.items():
        kname = "delta_apply" if key.startswith("delta_apply") else key
        say(json.dumps({"name": key, "shape": t["shape"], "launches": launches[kname],
                        "kernel_ms": t["kernel_ms"], "kernel_warm_ms": t["kernel_warm_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "library_ms": t["library_ms"],
                        "card": card}))
    for kname, (source, replaces) in meta.items():
        t = times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": errs[kname],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
        })
    say(json.dumps({"kernels": kernels}))
    say(smi_line)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
