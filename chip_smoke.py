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
   output), at the main path's shapes and at edge shapes (for
   ``delta_fused`` also the edges of its look-back: 40, 625 and 1,563
   tiles, tiles past the rows, all clean, all dirty; for ``delta_apply``
   the serving restore's 2 rows of 1,310,720 B, rows that end inside a
   segment, unaligned rows, a misaligned pointer, only padding), then the
   launch floor (an empty kernel) and each kernel timed with
   CUDA events: each kernel captured in a CUDA graph, so host time stays out
   of its reading (median over many replays, L2 flushed before each by a
   memset and, for the clean reading, by a read, plus a warm reading of
   back-to-back launches);
4. main path — ``StateManager(Sandbox(DeltaFS, CowTensorState), DeltaCR)``
   on the card with the KV cache of the JAX package's ``qwen3-14b`` config at
   full width for one 8192-token session plus a 256 MiB heap: 8 agent turns,
   a checkpoint after each, a fast rollback and a slow (image) restore, all
   restored bytes checked against device copies;
3b. serving kernels — ``page_copy_stacked`` and ``page_copy`` bit-exact
   against their plain versions at the served qwen3-14b pool and at the edge
   sweeps, ``paged_attention`` within 2e-5 (fp32) / 2e-2 (bf16) at the served
   decode shape, the sweep cases, the length edges (0 gives exactly 0) and
   the edges of its cluster split, then timed like phase 3 (also at B = 1,
   and ``page_copy_stacked`` over one pool and over the K and V pools in
   one launch, as a materialize runs it);
6. serving path — ``Engine`` over the whole ``qwen3-14b`` config (random bf16
   weights from a seed, 40 layers; the model is built once and shared with
   phase 7) and a 1024-page pool: prefill of a 2011-token prompt, decode, a
   delta checkpoint, four fast forks decoding 16 batched steps, a slow
   restore that must decode exactly what a fast fork decodes; CoW block
   accounting and the delta image's dirty rows checked, launches counted
   over this phase alone;
7. agent search — on the same model, its own 1024-page pool: (7a) a trunk
   session on phase 6's prompt under ``StateManager(Sandbox(DeltaFS,
   trunk), DeltaCR)``, (i) the serial ``MCTS`` over ``DecodeSearchTask``,
   (ii) the parallel ``MCTS`` forking sibling leaves through a
   ``SandboxTree`` into one ``Scheduler`` batch, (iii) ``decode_fanout`` of
   one node; every fork copies no page, every write copies exactly the
   shared part-full tail pages, a slow restore of each best leaf (and of a
   delta chain under it, through ``delta_apply``) decodes what a fast fork
   decodes, and the free pages return to their count before each search;
   (7b) ``rollout_fanout`` of the ``scientific`` archetype's device sandbox
   at widths 1, 4, 16 and 64 (no fork moves a chunk byte), a
   ``checkpoint_burst`` of the 64 children, a ``tree.commit`` (the winner
   restores byte-identical, the losers' storage is freed); launches counted
   over this phase alone;
8. persistence — (8a) the C/R cell of phase 4 at full size for 4 turns under
   ``mode="delta"``, a ``PersistencePlane`` save (``full_every=8``: one full
   save, then deltas) into a fresh temporary directory after each, and one
   more turn for reference; the state is freed and a fresh process
   ``recover``s the root on the card: every restored tensor and file
   against the writer's blake2b digests, the trunk restored by
   ``delta_apply`` over its anchored parent generation, and the next turn's
   checkpoint on the kernel path with the writer's device→host bytes and
   image; (8b) on phase 6's model, a ``Scheduler(persist_path=...)`` over a
   1024-page pool: two sessions on phase 6's prompt, a few steps, one
   suspended and drained so the manifest commits, 8 greedy tokens of a fast
   fork of it; scheduler, DeltaCR and pool freed, then
   ``Scheduler.recover`` over a new pool and engine, and the resumed session
   must decode the same 8 tokens; launches counted over each part (the
   recovering process's added to 8a's), then phase 6's B = 4 step profiled;
4b. checkpoint profile — the C/R cell of phase 4 for 4 turns, turn 1's
   checkpoint and dump under ``torch.profiler``: the device time one
   checkpoint costs, by kernel, copy and memset;
9. model families — each model built from the port's registry with seeded
   random bf16 weights over a 1024-page pool, on phase 6's prompt: prefill,
   16 steps with a delta checkpoint after 8 and 16, four fast forks decoding
   8 batched steps, a slow restore that must decode exactly what a fast fork
   decodes; forks copy no page and no recurrent state, and stepping a parent
   leaves its forks' states unchanged.  (9a) the whole ``qwen3-moe-30b-a3b``
   (48 attention + MoE layers, 128 experts top-8), its embedding table
   drawn at std 4 so that routing does not collapse onto a few experts;
   every routing call's capacity slots and drops are recomputed on the
   host and must match; (9b) the whole ``xlstm-1.3b`` (42 mLSTM
   and 6 sLSTM layers, no attention: its state is all recurrent and its
   dumps launch no kernel); (9c) ``gemma3-27b`` cut to one period (5
   sliding-window layers and 1 global), the prompt past the window.  (9d)
   each new sublayer at its config's full width, a 256-token prefill (1536
   for ``attn_local``) and 4 decode steps, on the card in bf16 against the
   CPU in float32 within 2e-2 relative: ``moe``, ``mamba`` (jamba),
   ``mlstm``, ``slstm``, ``attn_local`` and M-RoPE attention (qwen2-vl).
   Phase 9 runs after the profiler of phases 6 and 4b has been used, so its
   host-bound step times are slower than a fresh process's;
10. training — ``Trainer.run`` (the path of ``python -m
   repro_torch.launch.train``) at the full width of ``olmo-1b`` (16 × (attn,
   mlp), d_model 2048, vocab 50304, bf16 params, fp32 moments) on 8
   sequences of 4096 tokens in 2 microbatches: ``loss_fn`` forward and
   backward, AdamW, a coupled DeltaFS checkpoint after step 3, the
   ``trainer.step`` seam raising before step 4, ``restore_latest`` and the
   run resumed to step 5.  Every restored leaf bit-exact against a device
   clone of the snapshot, the stream state equal, the re-run step 3's loss
   equal to the pre-crash one, step 4 within 1e-3 of the pre-crash params'
   loss on its batch; step time, tokens/s, MFU against the card's bf16 dense
   peak, peak memory, snapshot, background write and restore times; no
   kernel of the port launches (checkpoints go to the host DeltaFS);
   (10b) one step of a fresh trainer under ``torch.profiler``, graphed (a
   replay) and eager (in a fresh process, whose first profile drops no
   device event): device busy time, idle share, matrix-product time,
   top kernels and the kernel count, which must be equal; then a
   checkpoint whose background write is timed with the training idle.
   Training runs through ``Trainer``'s default on the card, one CUDA graph
   of the whole step (``TrainProgram``), captured at the first step;
   phase 10 checks that every later step replayed it;
11. sharded dumps — over a logical mesh of eight ("data", "model") ranks
   on the one card: ``delta_fused``, ``delta_diff`` and ``delta_apply``
   bit-exact at its part grids; (11a) phase 4's C/R cell as a
   ``ShardedTensorState`` on a (4, 2) mesh (each KV tensor's sequence over
   "data" and heads over "model", the heap over "model") under
   ``DeltaCR(mode="delta")``: 8 turns with a checkpoint after each, a fast
   rollback, slow restores onto (4, 2) and onto (2, 4), one more turn and
   checkpoint on the state restored onto (4, 2); every restore against
   device clones, every dump gather-free with each rank's row bytes equal to
   its parts' dirty tiles and the ranks' bytes equal to the pipeline's
   device→host bytes, the first two turns' images equal to the (1, 1)
   layout's, the last image's digests equal to blake2b over
   ``array_to_grid`` rows, one ``delta_apply`` per part with dirty tiles on
   each slow restore and one delta-kernel launch per part on the dump after
   it; (11b) on phase 6's model, a 1024-page pool laid over the (4, 2)
   mesh (KV heads over "model"): phase 6's prompt decoded to a
   power-of-two page count, a checkpoint, 8 steps, a delta checkpoint
   (tiled KV entries, no gather), four fast forks at B = 4 (no page
   copied), and a slow restore (one ``delta_apply`` per part with dirty
   tiles) that must decode exactly what a fast fork decodes;
12. sharded compute — on 9a's model, right after 9a: (12a) one MoE layer
   (D 2048, 128 experts, top-8, F 768, bf16) on a (4, 256) input,
   expert-parallel over logical meshes (1, 4), (2, 4) with and without
   sequence parallelism, (4, 2) and (1, 8) with it: every rank's capacity
   slots and drops equal ``moe_apply`` on its shard's tokens as one group,
   the output within 2e-2 of that plain version's largest magnitude,
   ``aux`` within 1e-5 of the shards' mean, and each rank's collective
   bytes equal to the formula; (12b) 9a's serving run again with every
   call under ``activation_sharding`` over a (1, 4) mesh (32 experts a
   rank): 9a's gates, the all_to_all bytes of every rank equal to the
   formula over the run, the prefill logits within 2e-2 of 9a's, the peak
   at most 9a's plus 2 GiB, ``paged_attention`` once per layer a step; then
   the model is freed and (12c) ``repro_torch.launch.serve.main`` serves
   two sessions of 16 tokens at full olmo-1b width in this process;
14. decode graphs — on phase 6's model, right after phase 6: phase 6's
   prompt prefilled, a checkpoint whose dump is still in flight when the
   first step (the B = 1 capture) starts, 8 steps at B = 1 and 8 batched
   steps of four forks, through ``Engine(graphs=False)`` and
   ``Engine(graphs=True)`` in the order eager, graph, graph, eager: every
   step's tokens equal, its logits within 2e-2 (equality expected; the
   largest difference printed) and its launches of every kernel equal, each
   graphed width replayed at every step after its first; the B = 1 and
   B = 4 step ms of each mode, the capture ms of each width and the graph
   pool's bytes.  Every other phase serves through the default, a CUDA
   graph per batch width; phase 6's profiled B = 4 step is printed graphed
   and eager;
15. train graphs — right after phase 10, at its model and shape: one
   seeded state trained 4 steps by ``Trainer(graphs=False)`` and by
   ``Trainer(graphs=True)`` on the same batches: every step's loss, lr and
   grad_norm within 1e-5 relative (equality expected), every params and
   moment leaf after the last step within 1e-3 of the eager leaf's largest
   magnitude (the largest difference printed), the graphed run replaying
   every step after its first; step ms of each mode, the capture ms, the
   graph pool's bytes, peak memory and allocation retries, and the
   reserved bytes before and after ``Trainer.close()``;
13. dry run — ``repro_torch.launch.dryrun``: (13a) ``run_cell`` traces
   olmo-1b ``train_4k`` on a (16, 16) logical mesh of ``meta`` ranks and
   qwen3-14b ``decode_32k`` on (16, 16) and (2, 16, 16), and prints each
   record; (13b) olmo-1b ``train_4k`` at the largest global batch of 8, 4,
   2, 1 that fits, and qwen3-14b ``decode_32k`` at global batch 4, each
   traced on a (1, 1) ``meta`` mesh and then built by ``build_step`` on a
   (1, 1) mesh of the card and run on seeded real arguments: the card's
   ``FlopCounterMode`` count equal to the dry run's, the arguments' bytes
   equal to its ``memory.argument_bytes`` (hard gates), the step's median
   ms over 3 runs after a warm-up, its temp bytes and its FLOPs over the
   card's bf16 dense peak; no kernel of the port launches;
5. report — one JSON line per kernel, the ``{"kernels": [...]}`` line, the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Phases run in the order 1, 2, 3, 3b, 4, 6, 14, 7, 8, 11, 4b, 9a, 12, 9b, 9c,
9d, 10, 15, 10b, 13, 5.

Any failure exits non-zero before the last line is printed.  The script
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
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
PROFILED_TURN = 1              # phase 4b: the turn whose checkpoint's device time is profiled
PROFILED_TURNS = 4             # phase 4b: the turns it drives (the fewest run_main_path takes)


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

    Returns (cold, warm, clean): ``cold`` is the median over ``iters``
    replays of one call, each after the memset has evicted the L2 (and left
    it full of dirty lines, which the call's own traffic must write back);
    ``warm`` is one replay of ``batch`` calls captured back to back, divided
    by ``batch``; ``clean`` is ``cold`` with a read of ``flush`` in place of
    the memset, which evicts the L2 and leaves it clean."""
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
    clean = []
    words = flush.view(torch.int64)
    for _ in range(iters):
        words.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one.replay()
        end.record()
        clean.append((start, end))
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    many.replay()
    end.record()
    torch.cuda.synchronize()
    cold = statistics.median(s.elapsed_time(e) for s, e in pairs)
    warm = start.elapsed_time(end) / batch
    cold_clean = statistics.median(s.elapsed_time(e) for s, e in clean)
    del one, many
    return cold, warm, cold_clean


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

    def apply_case(N, C, n_valid, M, dtype=torch.uint8, misaligned=False):
        base = torch.randint(-100, 100, (N, C), generator=gen, device=device).to(dtype)
        data = torch.randint(-100, 100, (M, C), generator=gen, device=device).to(dtype)
        if misaligned:      # data's pointer one byte past a 16-byte boundary: the byte path
            spare = torch.empty(M * C + 1, dtype=torch.uint8, device=device)
            data = spare[1:].view(M, C).copy_(data)
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
    # the one-pass look-back's edges
    fused_case(5000, 96, rows(5000, 1500), 2048)          # 40 tiles: look-back past 32
    fused_case(20000, 2048, rows(20000, 3000), 4096)      # 625 tiles of 32 rows
    fused_case(200000, 96, rows(200000, 5000), 8192)      # 1,563 tiles: more than fit at once
    fused_case(37, 256, rows(37, 9), 300)                 # cap > N: two tiles past the rows
    fused_case(256, 65536, [], 128)                       # all clean at the dump shape
    fused_case(256, 65536, list(range(256)), 128)         # all dirty: overflow, one row a tile
    fused_case(700, 100, rows(700, 250), 512)             # rows not 16-byte multiples
    diff_case(37, 256, [])
    diff_case(37, 256, list(range(37)))
    diff_case(37, 256, rows(37, 9), misaligned=True)
    apply_case(64, 512, 0, 8)                             # only -1 padding
    apply_case(8, 65536, 0, 8)                            # only padding, 16 segments a row
    apply_case(128, 1310720, 2, 2)                        # the serving restore: 2 page rows
    apply_case(37, 10000, 12, 16)                         # 16-byte rows, ragged last segment
    apply_case(37, 5001, 12, 16)                          # unaligned rows: the byte path
    apply_case(37, 4096, 9, 16, misaligned=True)          # misaligned pointer: the byte path
    torch.cuda.synchronize()
    return errs


def time_launch_floor(device) -> list:
    """[cold, warm, clean] ms of an empty kernel (one block of 32 threads)
    captured alone in a graph and timed as every kernel is: the least any
    launch here can read."""
    import torch

    from repro_torch.kernels import _build

    lib = _build.library()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)

    def empty():
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib.repro_launch_floor(stream), "launch_floor")

    return list(time_graph_ms(empty, flush=flush))


def time_kernels(device) -> dict:
    """kernel / plain / library times at the main path's shapes."""
    import torch

    from repro_torch.kernels import delta_apply, delta_diff, delta_fused, ref  # noqa: F401

    gen = torch.Generator(device=device).manual_seed(99)
    # 512 MiB: evicts the 50 MB L2 before each timed call
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    out = {}

    def timed(kernel, plain, library=None):
        cold, warm, clean = time_graph_ms(kernel, flush=flush)
        return {
            "kernel_ms": cold,
            "kernel_warm_ms": warm,
            "kernel_cold_clean_ms": clean,
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
        # phase 6's slow restore: 2 dirty page rows of a 128-page session
        ((128, 1310720, 2, 2), "delta_apply_restore"),
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
# phase 3b: the serving kernels against their plain versions
# ---------------------------------------------------------------------------
# paged_attention cases of the JAX package's tests/test_kernels.py:19-28
# (B, KVH, G, D, page_size, P, max_pages, dtype name)
PA_CASES = [
    (1, 1, 1, 128, 16, 8, 2, "float32"),
    (2, 2, 4, 128, 64, 16, 4, "float32"),
    (3, 4, 2, 128, 32, 12, 3, "float32"),
    (2, 1, 8, 256, 16, 8, 4, "float32"),
    (2, 2, 5, 128, 16, 8, 3, "float32"),
    (2, 2, 4, 64, 16, 8, 3, "float32"),
    (2, 2, 4, 128, 64, 16, 4, "bfloat16"),
]
PA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the served shape: 4 forks of one qwen3-14b session, ~2040 tokens each
SERVED_B, SERVED_PSZ, SERVED_PAGES, SERVED_MAXP = 4, 16, 1024, 256
SERVED_LENS = [2035, 2040, 2047, 2050]
SERVED_SHARED_PAGES = 127              # pages the forks share (the trunk's)
COPY_PAIRS = 4                         # CoW copies of one batched materialize


def _attention_inputs(gen, B, KVH, G, D, psz, P, maxp, dtype, device, lens=None, shared=0):
    """q, pages, a page table and lengths.  With ``shared``, the B sessions
    share their first ``shared`` pages and own the rest (forks of one
    trunk); otherwise the table is random."""
    import torch

    dt = getattr(torch, dtype)
    q = torch.randn((B, KVH, G, D), generator=gen, device=device).to(dt)
    k = torch.randn((P, psz, KVH, D), generator=gen, device=device).to(dt)
    v = torch.randn((P, psz, KVH, D), generator=gen, device=device).to(dt)
    if shared:
        perm = torch.randperm(P - 1, generator=gen, device=device) + 1
        table = torch.empty((B, maxp), dtype=torch.int32, device=device)
        table[:, :shared] = perm[:shared].to(torch.int32)
        own = perm[shared:].to(torch.int32)
        for b in range(B):
            table[b, shared:] = own[b * (maxp - shared) : (b + 1) * (maxp - shared)]
    else:
        table = torch.randint(0, P, (B, maxp), generator=gen, device=device, dtype=torch.int32)
    if lens is None:
        lens = torch.randint(1, maxp * psz + 1, (B,), generator=gen, device=device,
                             dtype=torch.int32)
    else:
        lens = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k, v, table, lens


def _attention_err(got, want, tol: float) -> float:
    """Largest |got - want|; fails past ``tol`` absolute + relative."""
    g, w = got.double(), want.double()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise AssertionError(f"paged_attention differs by {float((g - w).abs().max())} > {tol}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def check_serving_kernels(device) -> dict:
    """page_copy / page_copy_stacked bit-exact (the whole pool compared, so
    pages outside dst are shown untouched) and paged_attention within its
    tolerance, at the served shapes and the edge sweeps.  Returns the
    largest error per kernel."""
    import torch

    from repro_torch.kernels import page_copy, page_copy_stacked, paged_attention, ref
    from repro_torch.kernels.paged_attention import split_count

    gen = torch.Generator(device=device).manual_seed(4321)
    errs = {"page_copy": 0.0, "page_copy_stacked": 0.0, "paged_attention": 0.0}

    def copy_case(shape, n, dtype, stacked):
        pool = torch.randint(-1000, 1000, shape, generator=gen, device=device).to(dtype)
        P = shape[1] if stacked else shape[0]
        perm = torch.randperm(P, generator=gen, device=device).tolist()
        src, dst = perm[:n], perm[n : 2 * n]
        s, d = torch.tensor(src, device=device), torch.tensor(dst, device=device)
        if stacked:
            want = ref.page_copy_stacked_ref(pool, s, d)
            got = page_copy_stacked(pool, src, dst)
        else:
            want = ref.page_copy_ref(pool, s, d)
            got = page_copy(pool, src, dst)
        key = "page_copy_stacked" if stacked else "page_copy"
        errs[key] = max(errs[key], max_abs_err(got, want))

    def pools_case(shape, n, dtype, n_pools):
        """Several pools of one shape in one call, as a materialize makes it."""
        pools = [torch.randint(-1000, 1000, shape, generator=gen, device=device).to(dtype)
                 for _ in range(n_pools)]
        perm = torch.randperm(shape[1], generator=gen, device=device).tolist()
        src, dst = perm[:n], perm[n : 2 * n]
        s, d = torch.tensor(src, device=device), torch.tensor(dst, device=device)
        wants = [ref.page_copy_stacked_ref(p, s, d) for p in pools]
        page_copy_stacked(pools, src, dst)
        for p, w in zip(pools, wants):
            errs["page_copy_stacked"] = max(errs["page_copy_stacked"], max_abs_err(p, w))

    def attention_case(*args, lens=None, shared=0, split=None):
        B, KVH, maxp = args[0], args[1], args[6]
        if split is not None and split_count(B, KVH, maxp) != split:
            raise AssertionError(f"case {args}: split {split_count(B, KVH, maxp)}, "
                                 f"expected {split}")
        q, k, v, table, seq = _attention_inputs(gen, *args, device, lens=lens, shared=shared)
        got = paged_attention(q, k, v, table, seq)
        want = ref.paged_attention_ref(q, k, v, table, seq)
        errs["paged_attention"] = max(
            errs["paged_attention"], _attention_err(got, want, PA_TOL[args[-1]])
        )
        return got, seq

    kv = (QWEN3_14B_KV_HEADS, QWEN3_14B_HEAD_DIM)
    # served shapes: the stacked qwen3-14b pool, n = 4 pairs; one period alone
    copy_case((QWEN3_14B_LAYERS, SERVED_PAGES, SERVED_PSZ, *kv), COPY_PAIRS, torch.bfloat16, True)
    copy_case((SERVED_PAGES, SERVED_PSZ, *kv), COPY_PAIRS, torch.bfloat16, False)
    # a served materialize: the K and V pools in one launch; then 9 pools of
    # 300 pairs, which take 2 x 2 chunks
    pools_case((QWEN3_14B_LAYERS, SERVED_PAGES, SERVED_PSZ, *kv), COPY_PAIRS, torch.bfloat16, 2)
    pools_case((3, 640, 16, 2, 64), 300, torch.float32, 9)
    # edge sweeps of the JAX package's tests/test_kernels.py:61-71, and n = 1
    for P, psz, KVH, D in [(8, 16, 2, 128), (12, 64, 1, 256), (6, 16, 4, 64)]:
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for n in (P // 2 - 1, 1):
                copy_case((P, psz, KVH, D), n, dtype, False)
                copy_case((3, P, psz, KVH, D), n, dtype, True)
    attention_case(SERVED_B, *kv[:1], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP,
                   "bfloat16", lens=SERVED_LENS, shared=SERVED_SHARED_PAGES)
    for case in PA_CASES:
        attention_case(*case)
    for lens in ([16, 1], [48, 15]):                  # page boundary, whole table, length 1
        attention_case(2, 1, 2, 128, 16, 6, 3, "float32", lens=lens)
    got, _ = attention_case(2, 2, 5, 128, 16, 8, 3, "float32", lens=[0, 17])
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("paged_attention: seq_len == 0 must give exactly 0")
    # the cluster split's edges (the split each case must take is asserted)
    served = (kv[0], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP)
    for dtype in ("float32", "bfloat16"):                 # lengths 0, 1 and ~2000 in one batch
        got, _ = attention_case(3, *served, dtype, lens=[0, 1, 2000], split=8)
        if got[0].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: seq_len == 0 must give exactly 0")
        # 2 active pages over a cluster of 16: 14 blocks without a page
        attention_case(1, kv[0], 5, kv[1], 16, 64, 64, dtype, lens=[20], split=16)
        attention_case(2, 2, 8, 256, 16, 64, 64, dtype, split=16)   # largest smem and registers
        attention_case(2, 2, 4, 128, 16, 64, 37, dtype, split=8)    # 37 pages over 8 blocks
    attention_case(1, *served, "bfloat16", lens=[2043], split=16)  # B = 1, served width
    # phase 9's served shapes: qwen3-moe-30b-a3b's layers and gemma3-27b's
    # global layer over a 136-page table, 4 forks of one session and one
    # alone; then their stacked pools as a materialize passes them (the K
    # and V of qwen3-moe's 48 periods; gemma3's 6 layers' 12 pools, which
    # take 2 launches)
    for name, split_b4 in (("qwen3-moe-30b-a3b", 16), ("gemma3-27b", 4)):
        fam = family_config(name)
        shape = (fam.n_kv_heads, fam.n_heads // fam.n_kv_heads, fam.head_dim, SERVED_PSZ,
                 SERVED_PAGES, FAMILY_MAX_PAGES)
        attention_case(SERVED_B, *shape, "bfloat16", lens=SERVED_LENS,
                       shared=SERVED_SHARED_PAGES, split=split_b4)
        attention_case(1, *shape, "bfloat16", lens=[2043], split=16)
    moe = family_config("qwen3-moe-30b-a3b")
    moe_pool = (moe.stages[0].n_periods, SERVED_PAGES, SERVED_PSZ, moe.n_kv_heads, moe.head_dim)
    copy_case(moe_pool, COPY_PAIRS, torch.bfloat16, True)
    pools_case(moe_pool, COPY_PAIRS, torch.bfloat16, 2)
    gemma = family_config("gemma3-27b", 1)
    pools_case((1, SERVED_PAGES, SERVED_PSZ, gemma.n_kv_heads, gemma.head_dim), COPY_PAIRS,
               torch.bfloat16, 2 * gemma.n_layers)
    torch.cuda.synchronize()
    return errs


def time_serving_kernels(device) -> dict:
    """kernel / plain / library times of the serving kernels at the served
    shapes, with the bytes each must move."""
    import torch

    from repro_torch.kernels import paged_attention, ref
    from repro_torch.kernels.page_copy import launch_kernel
    from repro_torch.kernels.paged_attention import max_active_clusters, split_count

    gen = torch.Generator(device=device).manual_seed(77)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
    out = {}
    kv = (QWEN3_14B_KV_HEADS, QWEN3_14B_HEAD_DIM)

    for key, shape in (
        ("page_copy_stacked", (QWEN3_14B_LAYERS, SERVED_PAGES, SERVED_PSZ, *kv)),
        ("page_copy", (SERVED_PAGES, SERVED_PSZ, *kv)),
    ):
        pool = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        stacked = pool if key == "page_copy_stacked" else pool[None]
        P = stacked.shape[1]
        perm = torch.randperm(P - 1, generator=gen, device=device) + 1
        s = perm[:COPY_PAIRS].to(torch.int32)
        d = perm[COPY_PAIRS : 2 * COPY_PAIRS].to(torch.int32)
        sl, dl = s.long(), d.long()
        s_host, d_host = s.cpu().numpy(), d.cpu().numpy()
        plain = ref.page_copy_stacked_ref if key == "page_copy_stacked" else ref.page_copy_ref
        if key == "page_copy_stacked":
            library = lambda: stacked.__setitem__((slice(None), dl), stacked[:, sl])  # noqa: E731
        else:
            library = lambda: pool.__setitem__(dl, pool[sl])  # noqa: E731
        cold, warm, clean = time_graph_ms(lambda: launch_kernel([stacked], s_host, d_host),
                                          flush=flush)
        page_bytes = stacked[0, 0].numel() * stacked.element_size()
        out[key] = {
            "shape": list(shape) + [COPY_PAIRS],
            "kernel_ms": cold,
            "kernel_warm_ms": warm,
            "kernel_cold_clean_ms": clean,
            "plain_ms": time_ms(lambda: plain(pool, s, d), flush=flush),
            "library_ms": time_graph_ms(library, flush=flush)[0],
            # each source page read once, each destination page written once
            "bound_ms": bound_ms(2 * COPY_PAIRS * stacked.shape[0] * page_bytes
                                 + 2 * COPY_PAIRS * 4),
        }
        del pool, stacked
    # what a served materialize launches: the K and V pools in one launch
    shape = (QWEN3_14B_LAYERS, SERVED_PAGES, SERVED_PSZ, *kv)
    pools = [torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
             for _ in range(2)]
    perm = torch.randperm(SERVED_PAGES - 1, generator=gen, device=device) + 1
    s = perm[:COPY_PAIRS].to(torch.int32)
    d = perm[COPY_PAIRS : 2 * COPY_PAIRS].to(torch.int32)
    s_host, d_host = s.cpu().numpy(), d.cpu().numpy()
    cold, warm, clean = time_graph_ms(lambda: launch_kernel(pools, s_host, d_host),
                                      flush=flush)
    page_bytes = pools[0][0, 0].numel() * pools[0].element_size()
    out["page_copy_stacked_kv"] = {
        "shape": list(shape) + [COPY_PAIRS, len(pools)],
        "kernel_ms": cold,
        "kernel_warm_ms": warm,
        "kernel_cold_clean_ms": clean,
        "plain_ms": time_ms(lambda: [ref.page_copy_stacked_ref(p, s, d) for p in pools],
                            flush=flush),
        "library_ms": None,
        "library_note": "two pools: no single PyTorch call (see the one-pool row)",
        "bound_ms": bound_ms(len(pools) * 2 * COPY_PAIRS * shape[0] * page_bytes
                             + 2 * COPY_PAIRS * 4),
    }
    del pools

    q, k, v, table, lens = _attention_inputs(
        gen, SERVED_B, kv[0], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP, "bfloat16",
        device, lens=SERVED_LENS, shared=SERVED_SHARED_PAGES,
    )
    cold, warm, clean = time_graph_ms(lambda: paged_attention(q, k, v, table, lens),
                                      flush=flush)
    split = split_count(SERVED_B, kv[0], SERVED_MAXP)
    # bytes this call needs: every session's active K and V rows (forks'
    # shared pages counted once per session, no dedup), q, out, the active
    # table entries and the lengths
    tokens = sum(SERVED_LENS)
    row = kv[0] * kv[1] * 2
    active_pages = sum(-(-n // SERVED_PSZ) for n in SERVED_LENS)
    out["paged_attention"] = {
        "shape": [SERVED_B, kv[0], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP],
        "kernel_ms": cold,
        "kernel_warm_ms": warm,
        "kernel_cold_clean_ms": clean,
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(q, k, v, table, lens), flush=flush),
        "library_ms": None,
        "library_note": "no single PyTorch call reads K/V through a page table",
        "bound_ms": bound_ms(2 * tokens * row + 2 * q.numel() * 2 + 4 * active_pages
                             + 4 * SERVED_B),
        # clusters of this launch, their size, and how many the card holds at once
        "clusters": [SERVED_B * kv[0], split, max_active_clusters(5, kv[1], torch.bfloat16, split)],
        # the forks share their first pages: each distinct page read once
        "bound_unique_ms": bound_ms(
            2 * SERVED_PSZ * row * (SERVED_SHARED_PAGES + active_pages
                                    - SERVED_B * SERVED_SHARED_PAGES)
            + 2 * q.numel() * 2 + 4 * active_pages + 4 * SERVED_B),
    }
    # one session at the served width: the largest cluster
    lens1 = [2043]
    q, k, v, table, lens = _attention_inputs(
        gen, 1, kv[0], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP, "bfloat16", device,
        lens=lens1,
    )
    cold, warm, clean = time_graph_ms(lambda: paged_attention(q, k, v, table, lens),
                                      flush=flush)
    pages1 = -(-lens1[0] // SERVED_PSZ)
    out["paged_attention_b1"] = {
        "shape": [1, kv[0], 5, kv[1], SERVED_PSZ, SERVED_PAGES, SERVED_MAXP],
        "kernel_ms": cold,
        "kernel_warm_ms": warm,
        "kernel_cold_clean_ms": clean,
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(q, k, v, table, lens), flush=flush),
        "library_ms": None,
        "library_note": "no single PyTorch call reads K/V through a page table",
        "bound_ms": bound_ms(2 * lens1[0] * row + 2 * q.numel() * 2 + 4 * pages1 + 4),
    }
    return out


# ---------------------------------------------------------------------------
# phase 6: the serving path at full qwen3-14b size
# ---------------------------------------------------------------------------
# the JAX package's src/repro/configs/qwen3_14b.py, whole: 40 layers, d_model
# 5120, 40 heads over 8 KV heads, head_dim 128, d_ff 17408, vocab 151936, bf16
SERVE_CONFIG = "qwen3-14b"
SERVE_PAGES = 1024              # 2.5 GiB of K/V pool at this width
SERVE_PAGE_SIZE = 16
SERVE_MAX_PAGES = 256
SERVE_PROMPT = 2011
SERVE_C1_STEPS = 8              # c1 at seq_len 2019: 127 pages, tail page part-full
SERVE_C2_STEPS = 16             # c2 at seq_len 2035: 128 pages
SERVE_FORKS = 4
SERVE_FORK_STEPS = 16
SERVE_SLOW_STEPS = 4


def build_serving_model(device, config: str = SERVE_CONFIG, seed: int = 0):
    """The whole model of ``config`` on ``device`` with random weights from
    a seeded ``torch.Generator``; phases 6 and 7 share one."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    model = Model(get_config(config), device=device)
    model.init(torch.Generator(device=device).manual_seed(seed))
    return model


def run_serving_path(
    device,
    *,
    model=None,
    config: str = SERVE_CONFIG,
    num_pages: int = SERVE_PAGES,
    page_size: int = SERVE_PAGE_SIZE,
    max_pages: int = SERVE_MAX_PAGES,
    prompt_len: int = SERVE_PROMPT,
    c1_steps: int = SERVE_C1_STEPS,
    c2_steps: int = SERVE_C2_STEPS,
    forks: int = SERVE_FORKS,
    fork_steps: int = SERVE_FORK_STEPS,
    slow_steps: int = SERVE_SLOW_STEPS,
    seed: int = 0,
) -> dict:
    """Prefill, decode, checkpoint, fork, delta dump and fast and slow
    restore of a paged session through ``Engine`` under
    ``StateManager(Sandbox(DeltaFS, trunk), DeltaCR)``; asserts the CoW
    block accounting, the dirty page rows of the delta image, and that a
    slow restore decodes exactly what a fast fork decodes.  ``model`` is
    built from ``config`` and ``seed`` unless given (``init_s`` then times
    the pool and engine only).  Returns the metrics."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCR, DeltaFS, DumpPolicy, Sandbox, StateManager
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import Engine, PagePool, PagedSession

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = build_serving_model(device, config, seed)
    cfg = model.cfg
    config = cfg.name
    pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device)
    eng = Engine(model, pool)
    sync()
    init_s = time.perf_counter() - t0
    n_layers = cfg.n_layers
    psz = page_size

    mat_ms = []
    materialize = pool.materialize

    def timed_materialize(plans, **kw):
        sync()
        t = time.perf_counter()
        n = materialize(plans, **kw)
        sync()
        if n:
            mat_ms.append((time.perf_counter() - t) * 1e3)
        return n

    pool.materialize = timed_materialize

    def steps(sessions, n):
        """n batched steps; per-step ms and the token streams."""
        ms, streams = [], [[] for _ in sessions]
        for _ in range(n):
            sync()
            t = time.perf_counter()
            toks = eng.step(sessions)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            for i, tok in enumerate(toks):
                streams[i].append(tok)
        return ms, streams

    launches0 = dict(launch_counts())
    steps0 = eng.decode_steps
    prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
    # -- warm-up, and for information the dense-cache path on the same prompt:
    #    a dense prefill, then (below) one dense decode step
    cache = model.init_cache(1, prompt_len + 1)
    dense0, cache = model.prefill(torch.tensor([prompt], dtype=torch.int32, device=device), cache)
    # -- 1-2: prefill the trunk, decode to c1
    sync()
    t = time.perf_counter()
    trunk = eng.new_session(prompt)
    sync()
    prefill_ms = (time.perf_counter() - t) * 1e3
    first_token = trunk.tokens[-1]
    dense1, _ = model.decode_step(torch.tensor([first_token], dtype=torch.int32, device=device),
                                  cache)
    del cache
    prefill_diff = float(np.abs(dense0[0].float().cpu().numpy() - trunk.extras["last_logits"]).max())
    b1_ms, _ = steps([trunk], 1)
    step1_diff = float(np.abs(dense1[0].float().cpu().numpy() - trunk.extras["last_logits"]).max())
    ms, _ = steps([trunk], c1_steps - 1)
    b1_ms += ms
    s1 = trunk.seq_len
    if s1 != prompt_len + c1_steps or s1 % psz == 0:
        raise AssertionError(f"c1 at seq_len {s1}: its tail page must be part-full")

    fs = DeltaFS()
    cr = DeltaCR(
        store=fs.store, async_warm=False, policy=DumpPolicy(mode="delta"),
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
    )
    sm = StateManager(Sandbox(fs, trunk), cr)
    fs.write("task/prompt.txt", np.asarray(prompt, np.int32))
    c1 = sm.checkpoint()
    cr.wait_dumps()
    img1 = cr.dump_future(c1).result()

    # -- 3: 16 more trunk steps; the first CoW-copies the shared tail page
    st0 = dict(vars(pool.stats))
    ms, _ = steps([trunk], 1)
    b1_ms += ms
    if pool.stats.cow_copies != st0["cow_copies"] + 1:
        raise AssertionError(f"first trunk step: {pool.stats.cow_copies - st0['cow_copies']} "
                             "CoW copies, expected 1 (the shared tail page)")
    ms, _ = steps([trunk], c2_steps - 1)
    b1_ms += ms
    s2 = trunk.seq_len
    want_fresh = (s2 - 1) // psz - (s1 - 1) // psz
    if (pool.stats.fresh_allocs - st0["fresh_allocs"] != want_fresh
            or pool.stats.cow_copies != st0["cow_copies"] + 1):
        raise AssertionError(f"trunk steps: {vars(pool.stats)} vs {st0}")
    d2h0 = cr.pipeline.d2h_bytes
    sync()
    t = time.perf_counter()
    c2 = sm.checkpoint()
    ckpt_call_ms = (time.perf_counter() - t) * 1e3
    cr.wait_dumps()
    sync()
    dump_ms = (time.perf_counter() - t) * 1e3
    d2h = cr.pipeline.d2h_bytes - d2h0
    img2 = cr.dump_future(c2).result()
    if img2.mode != "delta":
        raise AssertionError(f"c2 image mode {img2.mode}, expected delta")
    want_rows = list(range((s1 - 1) // psz, (s2 - 1) // psz + 1))
    kv_keys = [k for k in img2.entries if k.startswith("kv/")]
    row_bytes = 0
    for key in kv_keys:
        new_ids, old_ids = img2.entries[key].chunk_ids, img1.entries[key].chunk_ids
        rows = [i for i in range(len(new_ids)) if i >= len(old_ids) or new_ids[i] != old_ids[i]]
        if rows != want_rows:
            raise AssertionError(f"{key}: dirty page rows {rows}, expected {want_rows}")
        row_bytes = img2.entries[key].nbytes // len(new_ids)
    # the unfused plan fetches the dirty row of the first K = n1 rows, the
    # grown tail rows, and its control copies (idx of the pow2 capacity,
    # count)
    K2 = 1 << ((s1 - 1) // psz).bit_length()
    cap = cr.pipeline._capacity(K2)
    want_d2h = len(kv_keys) * (len(want_rows) * row_bytes + 4 * cap + 4)
    if on_card and d2h != want_d2h:
        raise AssertionError(f"c2 moved {d2h} B device->host, expected {want_d2h}")

    # -- 4: four fast restores of c2, divergent pending tokens, 16 batched steps
    copied0 = pool.stats.copied_pages
    fast_ms, kids = [], []
    for _ in range(forks):
        sync()
        t = time.perf_counter()
        kid, path = cr.restore(c2)
        fast_ms.append((time.perf_counter() - t) * 1e3)
        if path != "fast":
            raise AssertionError(f"restore of c2 took the {path} path")
        kids.append(kid)
    if pool.stats.copied_pages != copied0:
        raise AssertionError("forking copied pages")
    actions = rng.choice(cfg.vocab_size, size=forks, replace=False).tolist()
    for kid, a in zip(kids, actions):
        kid.tokens[-1] = int(a)
    st0 = dict(vars(pool.stats))
    pcs0 = launch_counts()["page_copy_stacked"]
    b4_ms, streams = steps(kids, 1)
    # one materialize that copies: one page_copy_stacked launch takes the
    # K and V pools of every layer
    if (pool.stats.cow_copies - st0["cow_copies"] != forks
            or pool.stats.materialize_calls - st0["materialize_calls"] != 1
            or (on_card and launch_counts()["page_copy_stacked"] - pcs0 != 1)):
        raise AssertionError(f"first fork step: {vars(pool.stats)} vs {st0}")
    ms, more = steps(kids, fork_steps - 1)
    b4_ms += ms
    streams = [a + b for a, b in zip(streams, more)]
    if len({tuple(s) for s in streams}) != forks:
        raise AssertionError(f"fork streams did not diverge: {streams}")

    # -- 5: slow restore of c2 against a fast fork taken before the eviction
    fast = cr.restore(c2)[0]
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
             for k, v in fast.dump_payload().items()}
    if not cr.evict_template(c2):
        raise AssertionError("no template to evict for c2")
    sync()
    t = time.perf_counter()
    slow, path = cr.restore(c2)
    sync()
    slow_ms = (time.perf_counter() - t) * 1e3
    if path != "slow":
        raise AssertionError(f"restore of c2 after eviction took the {path} path")
    got = slow.dump_payload()
    if sorted(got) != sorted(saved):
        raise AssertionError("slow restore: payload keys differ")
    for k, want in saved.items():
        same = (torch.equal(got[k], want) if isinstance(want, torch.Tensor)
                else np.array_equal(np.asarray(got[k]), want))
        if not same:
            raise AssertionError(f"slow restore: {k} differs from c2")
    outs = {}
    for name, sess in (("slow", slow), ("fast", fast)):
        logits = []
        toks = []
        for _ in range(slow_steps):
            toks += eng.step([sess])
            logits.append(torch.from_numpy(np.array(sess.extras["last_logits"])))
        outs[name] = (toks, logits)
    if outs["slow"][0] != outs["fast"][0] or not all(
        torch.equal(a, b) for a, b in zip(outs["slow"][1], outs["fast"][1])
    ):
        raise AssertionError("slow-restored and fast-forked sessions decode differently")
    launches = {k: n - launches0.get(k, 0) for k, n in launch_counts().items()}
    n_steps = eng.decode_steps - steps0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    health = cr.health()
    for sess in kids + [fast, slow, sm.sandbox.proc]:
        sess.release()
    cr.shutdown()
    return {
        "config": config,
        "layers": n_layers,
        "params": model.param_count(),
        "launches": launches,
        "decode_steps": n_steps,
        "init_s": init_s,
        "prefill_ms": prefill_ms,
        "prefill_tokens": prompt_len,
        "decode_ms_b1_median": statistics.median(b1_ms),
        "tokens_per_s_b1": 1e3 / statistics.median(b1_ms),
        "decode_ms_b4_median": statistics.median(b4_ms),
        "tokens_per_s_b4": forks * 1e3 / statistics.median(b4_ms),
        "materialize_ms_median": statistics.median(mat_ms),
        "materialize_calls_timed": len(mat_ms),
        "checkpoint_call_ms": ckpt_call_ms,
        "dump_complete_ms": dump_ms,
        "fast_restore_ms_median": statistics.median(fast_ms),
        "slow_restore_ms": slow_ms,
        "d2h_bytes_c2": d2h,
        "c2_dirtied_chunks": img2.dirtied_chunks,
        "page_row_bytes": row_bytes,
        "max_memory_allocated": peak,
        "dense_vs_paged_max_abs_logit_diff": {"prefill": prefill_diff, "step1": step1_diff},
        "cow_copies": pool.stats.cow_copies,
        "dump_retries": health["dump_retries"],
    }


def _device_rows(prof) -> list:
    """(name, device ms, count) of every device-side event of a profile
    (kernels, copies, memsets), largest first."""
    rows = []
    for e in prof.key_averages():
        # device-side events only: an operator's own entry repeats the time
        # of the kernels it launched
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_decode_step(device, model, *, graphs=None, num_pages: int = SERVE_PAGES,
                        page_size: int = SERVE_PAGE_SIZE, max_pages: int = SERVE_MAX_PAGES,
                        prompt_len: int = SERVE_PROMPT, batch: int = SERVE_FORKS,
                        seed: int = 0) -> dict:
    """Phase 6's batched decode step under ``torch.profiler``, on a pool of
    its own and an ``Engine(graphs=graphs)``: phase 6's prompt prefilled,
    forked ``batch`` ways with divergent pending tokens, one step to take
    the tail pages' CoW copies (and, graphed, to capture), then the
    profiled step (graphed: a replay).  It runs after phase 7, since the
    profiler, once used, slows the host's launches for the rest of the
    process."""
    import numpy as np

    from repro_torch.serve import Engine, PagePool

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device)
    eng = Engine(model, pool, graphs=graphs)
    trunk = eng.new_session(rng.integers(0, cfg.vocab_size, size=prompt_len).tolist())
    kids = [trunk.fork() for _ in range(batch)]
    for kid, a in zip(kids, rng.choice(cfg.vocab_size, size=batch, replace=False).tolist()):
        kid.tokens[-1] = int(a)
    eng.step(kids)
    profile = _profile_step(eng, kids)
    profile["graphs"] = eng.graphs
    for sess in kids + [trunk]:
        sess.release()
    return profile


def _profile_step(eng, sessions, top: int = 8) -> dict:
    """One batched decode step under ``torch.profiler``: host wall time,
    the device's busy time (sum of kernel self times on the one stream),
    the idle share, and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step(sessions)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    return {
        "batch": len(sessions),
        "wall_ms": wall,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall if wall > 0 else None,
        "kernel_launches": sum(r[2] for r in rows),
        "top": [[name[:60], ms, n] for name, ms, n in rows[:top]],
    }


# ---------------------------------------------------------------------------
# phase 14: the Engine's decode programs as CUDA graphs, against the eager step
# ---------------------------------------------------------------------------
GRAPH_STEPS = 8                           # steps at each width: B = 1, then B = SERVE_FORKS
GRAPH_TOL = 2e-2                          # graphed logits against the eager ones (equality expected)
GRAPH_RUNS = (False, True, True, False)   # Engine(graphs=...) of each run: eager, graph, graph, eager


def graph_pool_bytes(handle) -> int:
    """Bytes of the caching allocator's segments in the graph memory pool
    ``handle`` (0 for None)."""
    import torch

    if handle is None:
        return 0
    want = tuple(handle)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want)


def _graph_run(device, model, *, graphs: bool, prompt, actions, num_pages: int,
               page_size: int, max_pages: int, steps: int) -> dict:
    """One run of phase 14 through ``Engine(model, pool, graphs=graphs)`` on
    a pool of its own: ``prompt`` prefilled, a checkpoint whose dump is
    still in flight when the first step (graphed: the B = 1 capture)
    starts, ``steps`` B = 1 steps, then ``len(actions)`` forks with those
    pending tokens decoding ``steps`` batched steps.  Per step: the tokens,
    the logits, the launches of every kernel and the host ms."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import Engine, PagePool, PagedSession

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    reserved0 = torch.cuda.memory_reserved() if on_card else 0
    pool = PagePool(model.cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device)
    eng = Engine(model, pool, graphs=graphs)
    cr = DeltaCR(async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    rec = {"tokens": [], "logits": [], "launches": [], "ms": [], "batch": []}

    def step(batch):
        before = launch_counts()
        sync()
        t = time.perf_counter()
        rec["tokens"].append(eng.step(batch))
        sync()
        rec["ms"].append((time.perf_counter() - t) * 1e3)
        rec["launches"].append({k: n - before[k] for k, n in launch_counts().items()})
        rec["logits"].append(np.stack([s.extras["last_logits"] for s in batch]))
        rec["batch"].append(len(batch))

    trunk = eng.new_session(prompt)
    cr.checkpoint(trunk, 1, None)
    dump = cr.dump_future(1)
    rec["dump_in_flight_at_first_step"] = not dump.done()
    step([trunk])
    rec["dump_in_flight_after_first_step"] = not dump.done()
    for _ in range(steps - 1):
        step([trunk])
    kids = [trunk.fork() for _ in actions]
    for kid, a in zip(kids, actions):
        kid.tokens[-1] = int(a)
    for _ in range(steps):
        step(kids)
    cr.wait_dumps()
    sync()
    progs = sorted(eng._decode.values(), key=lambda p: p.batch)
    if graphs and not all(p.graph is not None and p.replays == steps - 1 for p in progs):
        raise AssertionError(f"graphed run: {[(p.batch, p.replays) for p in progs]} replays, "
                             f"expected {steps - 1} at each width")
    rec["capture_ms"] = {p.batch: p.capture_ms for p in progs}
    rec["graph_pool_bytes"] = graph_pool_bytes(eng._graph_pool)
    rec["reserved_growth_bytes"] = torch.cuda.memory_reserved() - reserved0 if on_card else None
    for sess in kids + [trunk]:
        sess.release()
    cr.shutdown()
    return rec


def run_graph_path(device, model, *, num_pages: int = SERVE_PAGES,
                   page_size: int = SERVE_PAGE_SIZE, max_pages: int = SERVE_MAX_PAGES,
                   prompt_len: int = SERVE_PROMPT, forks: int = SERVE_FORKS,
                   steps: int = GRAPH_STEPS, runs=GRAPH_RUNS, seed: int = 0) -> dict:
    """Phase 14: on phase 6's model and prompt, the runs of ``_graph_run``
    with ``graphs`` as ``runs`` lists them (a CPU rehearsal runs eager
    only).  Gates, against the
    first eager run: every step's tokens equal, its logits within
    ``GRAPH_TOL``, and its launches of every kernel equal; each graphed
    width replayed at every step after its first.  Returns the largest
    logit difference, each mode's B = 1 and B = ``forks`` step ms (medians
    over both runs of the mode, without each width's first step), and each
    graphed run's capture ms by width, graph-pool bytes and reserved-memory
    growth."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cfg = model.cfg
    prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()   # phase 6's prompt
    actions = rng.choice(cfg.vocab_size, size=forks, replace=False).tolist()
    recs = [_graph_run(device, model, graphs=g, prompt=prompt, actions=actions,
                       num_pages=num_pages, page_size=page_size, max_pages=max_pages,
                       steps=steps) for g in runs]
    ref = recs[runs.index(False)]
    diff = 0.0
    for g, rec in zip(runs, recs):
        if rec["tokens"] != ref["tokens"]:
            raise AssertionError(f"graphs={g}: tokens {rec['tokens']} differ from the eager "
                                 f"run's {ref['tokens']}")
        if rec["launches"] != ref["launches"]:
            raise AssertionError(f"graphs={g}: launches per step {rec['launches']} differ from "
                                 f"the eager run's {ref['launches']}")
        for a, b in zip(rec["logits"], ref["logits"]):
            diff = max(diff, float(np.abs(a - b).max()))
    if diff > GRAPH_TOL:
        raise AssertionError(f"graphed logits differ from the eager ones by {diff} > {GRAPH_TOL}")

    def median_ms(graphs: bool, batch: int) -> float:
        ms = [m for g, rec in zip(runs, recs) if g == graphs
              for i, (m, b) in enumerate(zip(rec["ms"], rec["batch"]))
              if b == batch and rec["batch"].index(b) != i]
        return statistics.median(ms)

    graphed = [rec for g, rec in zip(runs, recs) if g]
    return {
        "config": cfg.name,
        "runs": ["graph" if g else "eager" for g in runs],
        "steps_per_width": steps,
        "max_abs_logit_diff": diff,
        "tokens_equal": True,
        "launches_per_step": ref["launches"][-1],
        "step_ms_b1": {m: median_ms(g, 1) for m, g in (("eager", False), ("graph", True))
                       if g in runs},
        f"step_ms_b{forks}": {m: median_ms(g, forks) for m, g in (("eager", False), ("graph", True))
                              if g in runs},
        "first_step_ms": [{str(b): rec["ms"][rec["batch"].index(b)] for b in (1, forks)}
                          for rec in recs],
        "capture_ms": [rec["capture_ms"] for rec in graphed],
        "graph_pool_bytes": [rec["graph_pool_bytes"] for rec in graphed],
        "reserved_growth_bytes": [rec["reserved_growth_bytes"] for rec in recs],
        "dump_in_flight_at_capture": [rec["dump_in_flight_at_first_step"] for rec in graphed],
        "dump_in_flight_after_capture_step": [rec["dump_in_flight_after_first_step"]
                                              for rec in graphed],
    }


# ---------------------------------------------------------------------------
# phase 7: agent search on the card at full qwen3-14b width
# ---------------------------------------------------------------------------
SEARCH_ITERATIONS = 12
SEARCH_LEAVES = 4               # parallel driver: leaves per batch (the scheduler's max_batch)
SEARCH_BATCH_WINDOW_MS = 2.0    # the scheduler's batching window, as benchmarks/fig6_decode_fanout.py
SEARCH_K_TOKENS = 4             # tokens a search action decodes
SEARCH_WIDTH = 3                # actions proposed (and children) per node
SEARCH_GC_EVERY = 4
SEARCH_SEED = 7
FANOUT_CHILDREN = 4             # 7a (iii): children of one node, one action each
FANOUT_TOKENS = 8
GATE_TOKENS = 4                 # tokens the slow-restore gate decodes per session
RL_ARCHETYPE = "scientific"     # 24 files of 128 KiB, a 32 MiB heap over 8 arrays
RL_WIDTHS = (1, 4, 16, 64)


def _percentiles(ms) -> dict:
    import numpy as np

    if not ms:
        return {"n": 0}
    return {"n": len(ms), "p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99))}


def _last_search_trace() -> dict:
    """The program's own record of the newest search (``repro_torch.trace``):
    per span name its count and summed ms, and the run's counters."""
    from repro_torch import trace

    runs = [s.run for s in trace.snapshot()["spans"] if s.name == "search.run"]
    if not runs:
        return {}
    snap = trace.snapshot(max(runs))
    spans: dict = {}
    for s in snap["spans"]:
        n, ms = spans.get(s.name, (0, 0.0))
        spans[s.name] = (n + 1, ms + (s.t1_ns - s.t0_ns) / 1e6)
    return {"spans_ms": {k: [n, round(ms, 3)] for k, (n, ms) in sorted(spans.items())},
            "counters": snap["counters"]}


def run_search_path(
    device,
    *,
    model=None,
    config: str = SERVE_CONFIG,
    num_pages: int = SERVE_PAGES,
    page_size: int = SERVE_PAGE_SIZE,
    max_pages: int = SERVE_MAX_PAGES,
    prompt_len: int = SERVE_PROMPT,
    iterations: int = SEARCH_ITERATIONS,
    rl_widths=RL_WIDTHS,
    seed: int = 0,
) -> dict:
    """Phase 7: 7a decode search (serial and parallel MCTS over
    ``DecodeSearchTask``, a scheduler fan-out) and 7b RL fan-out over device
    sandboxes, with their gates.  Returns the metrics."""
    import torch

    if model is None:
        model = build_serving_model(device, config, seed)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"decode_search": run_decode_search(
        device, model, num_pages=num_pages, page_size=page_size, max_pages=max_pages,
        prompt_len=prompt_len, iterations=iterations, seed=seed)}
    out["rl_fanout"] = run_rl_fanout(device, widths=rl_widths, seed=seed)
    out["max_memory_allocated"] = (
        torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None)
    return out


def run_decode_search(device, model, *, num_pages, page_size, max_pages, prompt_len,
                      iterations, seed) -> dict:
    """7a: a trunk session prefills phase 6's prompt under
    ``StateManager(Sandbox(DeltaFS, trunk), DeltaCR)``; (i) the serial MCTS
    (rollback in place), (ii) the parallel MCTS (sibling leaves forked
    through a ``SandboxTree`` and decoded in one batch by a ``Scheduler``),
    (iii) ``decode_fanout`` of one node of (ii).  Gates every fork (no page
    copied), every CoW write (exactly the shared part-full tail pages), a
    slow restore of each search's best leaf against a fast fork of it, and
    the free pages after each search."""
    import collections
    import weakref

    import numpy as np
    import torch

    from repro_torch.core import (
        DeltaCR, DeltaFS, DumpPolicy, Sandbox, SandboxTree, StateManager, reachability_gc,
    )
    from repro_torch.kernels import launch_counts
    from repro_torch.search import MCTS, DecodeSearchTask, MCTSConfig, decode_fanout
    from repro_torch.serve import Engine, PagePool, PagedSession, Scheduler, SchedulerConfig

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = model.cfg
    psz = page_size
    pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device)
    eng = Engine(model, pool)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()   # phase 6's prompt

    # -- probes: batch widths and step times, CoW writes against their
    #    prediction, forks
    widths = collections.Counter()
    step_ms = []
    engine_step = eng.step

    def counted_step(sessions):
        widths[len(sessions)] += 1
        sync()
        t = time.perf_counter()
        toks = engine_step(sessions)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return toks

    eng.step = counted_step
    written = weakref.WeakSet()          # sessions that have made their first write
    first_writes = collections.Counter()  # copies made by each session's first write
    materialize = pool.materialize

    def checked_materialize(plans, **kw):
        with pool.lock:
            want = {}
            for p in plans:
                s = p.session
                tail = int(s.table[s.seq_len // psz]) if s.seq_len // psz < len(s.table) else 0
                want[id(p)] = int(s.seq_len % psz != 0 and tail != 0 and pool.refs[tail] > 1)
            cow0 = pool.stats.cow_copies
            n = materialize(plans, **kw)
            if n != sum(want.values()) or pool.stats.cow_copies - cow0 != n:
                raise AssertionError(f"a write copied {n} pages, the tails predict "
                                     f"{sum(want.values())}")
            for p in plans:
                if p.session not in written and p.session.seq_len > 0:   # not a prefill
                    written.add(p.session)
                    first_writes[want[id(p)]] += 1
            return n

    pool.materialize = checked_materialize
    fork_ms = []
    forks = collections.Counter()
    session_fork = PagedSession.fork

    def checked_fork(sess):
        """Every fork (template, dump, tree child, restore) under the pool
        lock: the clone's table is its parent's, no page copied or taken."""
        with pool.lock:
            before = (pool.stats.copied_pages, pool.stats.fresh_allocs, pool.free_pages())
            clone = session_fork(sess)
            after = (pool.stats.copied_pages, pool.stats.fresh_allocs, pool.free_pages())
            if after != before or not np.array_equal(clone.table, sess.table):
                raise AssertionError(f"a fork copied or took pages: {before} -> {after}")
            forks["forks"] += 1
        return clone

    dump_ms = []

    def probe_cr(cr):
        """Times every fast restore (a fork) and every dump's encode."""
        restore, checkpoint = cr.restore, cr.checkpoint

        def timed_restore(ckpt_id):
            t = time.perf_counter()
            state, path = restore(ckpt_id)
            if path == "fast":
                fork_ms.append((time.perf_counter() - t) * 1e3)
            return state, path

        def timed_checkpoint(state, ckpt_id, *args, **kw):
            checkpoint(state, ckpt_id, *args, **kw)
            fut = cr.dump_future(ckpt_id)
            if fut is not None:
                fut.add_done_callback(
                    lambda f: f.exception() is None and dump_ms.append(f.result().wall_ms))

        cr.restore, cr.checkpoint = timed_restore, timed_checkpoint

    PagedSession.fork = checked_fork
    try:
        steps0 = eng.decode_steps
        sync()
        t = time.perf_counter()
        trunk = eng.new_session(prompt)
        sync()
        prefill_ms = (time.perf_counter() - t) * 1e3
        fs = DeltaFS()
        cr = DeltaCR(
            store=fs.store, async_warm=False, policy=DumpPolicy(mode="delta"),
            restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
        )
        probe_cr(cr)
        # each search runs on a fork of the trunk, which keeps the prompt's pages
        sm = StateManager(Sandbox(fs, trunk.fork()), cr)
        fs.write("task/prompt.txt", np.asarray(prompt, np.int32))
        free0 = pool.free_pages()
        # for reference: B = 1 steps with no dump in flight
        idle = trunk.fork()
        step_ms.clear()
        for _ in range(SEARCH_K_TOKENS):
            eng.step([idle])
        idle.release()
        idle_step_ms = statistics.median(step_ms)

        def search(name, mcts_cfg, *, scheduler=None, tree=None):
            task = DecodeSearchTask(eng, scheduler=scheduler, k_tokens=SEARCH_K_TOKENS,
                                    width=SEARCH_WIDTH)
            mcts = MCTS(sm, task, mcts_cfg, tree=tree, scheduler=scheduler)
            fork_ms.clear()
            widths.clear()
            step_ms.clear()
            dump_ms.clear()
            sync()
            st = mcts.run()
            sync()
            cr.wait_dumps()
            return mcts, {
                "driver": name, "nodes": st.nodes, "iterations": st.iterations,
                "wall_s": st.wall_s, "nodes_per_s": st.nodes / st.wall_s,
                "trace": _last_search_trace(),
                "restores": st.restores, "fast_restores": st.fast_restores,
                "slow_restores": st.slow_restores, "forks": st.forks,
                "checkpoints": st.checkpoints, "parallel_batches": st.parallel_batches,
                "fork_ms": _percentiles(fork_ms), "batch_widths": dict(sorted(widths.items())),
                "step_ms": _percentiles(step_ms),
                "dumps": len(dump_ms), "dump_ms": _percentiles(dump_ms),
                "dump_ms_sum": sum(dump_ms),
            }

        def slow_restore_gate(ckpt_id) -> dict:
            """The node's template evicted, its slow restore is byte-identical
            to a fast fork taken before the eviction, and both decode the same
            tokens and logits."""
            fast, path = cr.restore(ckpt_id)
            if path != "fast":                   # evicted by the search: now re-injected
                fast.release()
                fast, path = cr.restore(ckpt_id)
            saved = {k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
                     for k, v in fast.dump_payload().items()}
            if not cr.evict_template(ckpt_id):
                raise AssertionError(f"no template to evict for {ckpt_id}")
            sync()
            t = time.perf_counter()
            slow, path = cr.restore(ckpt_id)
            sync()
            slow_ms = (time.perf_counter() - t) * 1e3
            if path != "slow":
                raise AssertionError(f"restore of {ckpt_id} after eviction took the {path} path")
            got = slow.dump_payload()
            if sorted(got) != sorted(saved):
                raise AssertionError("slow restore: payload keys differ")
            for k, want in saved.items():
                same = (torch.equal(got[k], want) if isinstance(want, torch.Tensor)
                        else np.array_equal(np.asarray(got[k]), want))
                if not same:
                    raise AssertionError(f"slow restore of {ckpt_id}: {k} differs")
            decoded = {}
            for name, sess in (("slow", slow), ("fast", fast)):
                toks, logits = [], []
                for _ in range(GATE_TOKENS):
                    toks += eng.step([sess])
                    logits.append(torch.from_numpy(np.array(sess.extras["last_logits"])))
                decoded[name] = (toks, logits)
                sess.release()
            if decoded["slow"][0] != decoded["fast"][0] or not all(
                torch.equal(a, b) for a, b in zip(decoded["slow"][1], decoded["fast"][1])
            ):
                raise AssertionError(f"slow-restored and fast-forked {ckpt_id} decode differently")
            return {"node": ckpt_id, "path": path, "slow_restore_ms": slow_ms,
                    "tokens": decoded["slow"][0]}

        def delta_chain_gate(ckpt_id) -> dict:
            """A fork of the node dumped whole (a), decoded, dumped as a delta
            against a (b): b's slow restore rebuilds it over a's generation with
            delta_apply, and is held to the same gate."""
            sess = cr.restore(ckpt_id)[0]
            a = sm.allocate_ckpt_id()
            cr.checkpoint(sess, a, None)
            for _ in range(GATE_TOKENS):
                eng.step([sess])
            b = sm.allocate_ckpt_id()
            cr.checkpoint(sess, b, a)
            cr.wait_dumps()
            sess.release()
            if cr.dump_future(b).result().mode != "delta":
                raise AssertionError("the chain's second dump is not a delta image")
            apply0 = launch_counts()["delta_apply"]
            gate = slow_restore_gate(b)
            gate["delta_apply_launches"] = launch_counts()["delta_apply"] - apply0
            if on_card and gate["delta_apply_launches"] <= 0:
                raise AssertionError("the chain's slow restore launched no delta_apply")
            for c in (b, a):
                cr.drop_checkpoint(c)
            return gate

        def back_to_baseline(tree=None) -> int:
            """Release the live forks, GC, drop the search's checkpoints and its
            session: the trunk holds the only pages, as before the search.  The
            next search starts on a new fork of the trunk."""
            if tree is not None:
                tree.release_all()
            for node in sm.live_nodes():
                node.expandable = False          # the search is over
            reachability_gc(sm)
            for node in sm.live_nodes():
                sm.reclaim(node.ckpt_id)
            cr.wait_dumps()
            sm.sandbox.proc.release()
            free = pool.free_pages()
            if free != free0:
                raise AssertionError(f"{free} free pages after the search, {free0} before it")
            sm.sandbox.proc = trunk.fork()
            return free

        # (i) serial MCTS: rollback in place, template restores through sm.restore
        mcts, serial = search("serial", MCTSConfig(
            iterations=iterations, expand_width=SEARCH_WIDTH, value_isolation=False,
            gc_every=SEARCH_GC_EVERY, seed=SEARCH_SEED))
        serial["best_leaf"] = slow_restore_gate(mcts.best_leaf())
        serial["delta_chain"] = delta_chain_gate(mcts.best_leaf())
        back_to_baseline()

        # (ii) parallel MCTS: sibling leaves forked and decoded in one batch
        sched = Scheduler(eng, cr, SchedulerConfig(max_batch=SEARCH_LEAVES,
                                                   batch_window_ms=SEARCH_BATCH_WINDOW_MS))
        tree = SandboxTree(sm)
        mcts, parallel = search("parallel", MCTSConfig(
            iterations=iterations, parallel_leaves=SEARCH_LEAVES, expand_width=SEARCH_WIDTH,
            gc_every=SEARCH_GC_EVERY, seed=SEARCH_SEED), scheduler=sched, tree=tree)
        best = mcts.best_leaf()

        # (iii) decode_fanout: children of one node, each forced to its own action
        actions = rng.choice(cfg.vocab_size, size=FANOUT_CHILDREN, replace=False).tolist()
        widths.clear()
        sync()
        t = time.perf_counter()
        streams, _, res = decode_fanout(tree, best, FANOUT_CHILDREN, sched, FANOUT_TOKENS,
                                        actions=actions)
        sync()
        fanout = {"node": best, "actions": actions, "streams": streams,
                  "wall_ms": (time.perf_counter() - t) * 1e3,
                  "fork_ms": {"p50": res.p50_ms, "p99": res.p99_ms},
                  "batch_widths": dict(sorted(widths.items()))}
        if len({tuple(s) for s in streams}) != FANOUT_CHILDREN:
            raise AssertionError(f"fan-out streams did not diverge: {streams}")
        parallel["best_leaf"] = slow_restore_gate(best)
        free = back_to_baseline(tree)
        n_steps = eng.decode_steps - steps0
        health = sched.health()
        sm.sandbox.proc.release()
        trunk.release()
        cr.shutdown()
        return {
            "config": cfg.name, "layers": cfg.n_layers, "prefill_ms": prefill_ms,
            "idle_step_ms_b1": idle_step_ms,
            "serial": serial, "parallel": parallel, "fanout": fanout,
            "first_divergent_writes": {f"{k} copies": v for k, v in sorted(first_writes.items())},
            "session_forks_checked": forks["forks"],
            "decode_steps": n_steps, "free_pages": free, "dump_failures": health["dump_failures"],
        }
    finally:
        PagedSession.fork = session_fork


def run_rl_fanout(device, *, widths=RL_WIDTHS, seed: int = 0) -> dict:
    """7b: the ``scientific`` archetype's sandbox (its heap a
    ``CowTensorState`` on ``device``) forked by ``rollout_fanout`` at each
    width, one ``SyntheticAgentTask`` action per rollout; then a
    ``checkpoint_burst`` of the widest fan-out's children and a
    ``tree.commit`` of one winner.  Gates: no fork moves a chunk byte,
    every dump lands, the committed heap restores byte-identical (fast and
    slow), the losers' storage is freed."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core import (
        CowTensorState, DeltaCR, DeltaFS, Sandbox, SandboxTree, StateManager,
    )
    from repro_torch.kernels import launch_counts
    from repro_torch.search import (
        ARCHETYPES, SyntheticAgentTask, build_sandbox_state, checkpoint_burst, rollout_fanout,
    )
    from repro_torch.search.archetypes import Action

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    launches0 = dict(launch_counts())
    spec = ARCHETYPES[RL_ARCHETYPE]
    fs = DeltaFS()
    proc = build_sandbox_state(spec, fs, seed=seed, device=device)
    cr = DeltaCR(store=fs.store, restore_fn=lambda p: CowTensorState(p, device=device))
    sm = StateManager(Sandbox(fs, proc), cr)
    task = SyntheticAgentTask(spec)
    sm.action_applier = task.replay_action
    c0 = sm.checkpoint()
    cr.wait_dumps()
    tree = SandboxTree(sm)
    rng = np.random.default_rng(seed + 1)
    stats = fs.store.stats
    out = {"archetype": spec.name, "heap_bytes": sum(proc.get(k).nbytes for k in proc.keys()),
           "widths": {}}
    kids = []
    for n in widths:
        actions = [Action(seed=int(rng.integers(1 << 31)), readonly=False) for _ in range(n)]
        cr.wait_dumps()
        before = dict(vars(stats))
        after_forks = []

        def rollout(child, i):
            if i == 0:
                after_forks.append(dict(vars(stats)))
            task.apply_action(child, actions[i])
            return task.evaluate(child)

        last = n == widths[-1]
        sync()
        t = time.perf_counter()
        rewards, res = rollout_fanout(tree, n, rollout, ckpt_id=c0, teardown=not last)
        sync()
        if after_forks[0] != before:
            raise AssertionError(f"fan-out of {n} moved chunk bytes: {after_forks[0]} vs {before}")
        out["widths"][n] = {"fork_ms": {"p50": res.p50_ms, "p99": res.p99_ms},
                            "forks_per_s": res.forks_per_s,
                            "rollouts_ms": (time.perf_counter() - t) * 1e3}
        if last:
            kids = sorted(tree.live_sandboxes(), key=lambda s: s.sandbox_id)
            winner = kids[int(np.argmax(rewards))]
    ids = [sm.allocate_ckpt_id() for _ in kids]
    parents = [tree.base_ckpt(k.sandbox_id) for k in kids]
    futs, submit_ms = checkpoint_burst(cr, [k.proc for k in kids], ids, parents, wait=True)
    images = [f.result() for f in futs]          # every dump landed, or this raises
    out["burst"] = {"children": len(kids), "submit_ms": submit_ms,
                    "modes": dict(collections.Counter(img.mode for img in images))}
    saved = {k: winner.proc.get(k).clone() for k in winner.proc.keys()}
    phys = stats.physical_bytes
    final = tree.commit(winner.sandbox_id)
    cr.wait_dumps()
    freed = phys - stats.physical_bytes
    if freed <= 0:
        raise AssertionError(f"commit freed no loser storage ({phys} -> {stats.physical_bytes} B)")
    # the trunk's fast restore onto the committed node, and a slow one
    cr.evict_template(final)
    slow, path = cr.restore(final)
    if path != "slow":
        raise AssertionError(f"restore of the committed node took the {path} path")
    for name, state in (("fast", sm.sandbox.proc), ("slow", slow)):
        for k, want in saved.items():
            if not torch.equal(state.get(k), want):
                raise AssertionError(f"{name} restore of the committed node: {k} differs")
    slow.release()
    for i in ids:
        cr.drop_checkpoint(i)
    cr.wait_dumps()
    health = cr.health()
    if health["dump_failures"]:
        raise AssertionError(f"{health['dump_failures']} dumps failed")
    out["commit"] = {"node": final, "loser_bytes_freed": freed,
                     "physical_bytes_after": stats.physical_bytes}
    tree.release_all()
    sm.sandbox.proc.release()
    cr.shutdown()
    out["launches"] = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at real size
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CRCell:
    """The C/R cell's shapes: the KV cache of one session of the JAX
    package's qwen3-14b config at full width, a float32 heap and small
    DeltaFS files.  Each agent turn writes ``tokens_per_turn`` new tokens
    into every KV tensor, rewrites 1% of the heap's rows and one file.
    Phases 4 and 8a drive it."""

    layers: int = QWEN3_14B_LAYERS
    kv_heads: int = QWEN3_14B_KV_HEADS
    head_dim: int = QWEN3_14B_HEAD_DIM
    session_tokens: int = SESSION_TOKENS
    prefix_tokens: int = PREFIX_TOKENS
    tokens_per_turn: int = TOKENS_PER_TURN
    heap_bytes: int = HEAP_BYTES
    n_files: int = N_FILES
    chunk_bytes: int = CHUNK_BYTES

    @property
    def heap_rows(self) -> int:
        return self.heap_bytes // self.chunk_bytes

    @property
    def heap_touch(self) -> int:
        return max(1, int(round(self.heap_rows * HEAP_ROW_FRAC)))

    @property
    def n_tensors(self) -> int:
        return 2 * self.layers + 1

    @property
    def want_dirty(self) -> int:
        """The dirty rows of one turn's delta image."""
        tokens_per_row = self.chunk_bytes // (self.kv_heads * self.head_dim * 2)
        return 2 * self.layers * (self.tokens_per_turn // tokens_per_row) + self.heap_touch

    def build(self, device, gen, rng):
        """The cell's state on ``device`` under ``StateManager(Sandbox(DeltaFS,
        CowTensorState), DeltaCR(mode="delta"))``; returns ``(sm, cr)``."""
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

        token_bytes = self.kv_heads * self.head_dim * 2
        assert self.chunk_bytes % token_bytes == 0
        tokens_per_row = self.chunk_bytes // token_bytes
        assert self.prefix_tokens % tokens_per_row == 0
        assert self.tokens_per_turn % tokens_per_row == 0
        tensors = {}
        shape = (self.kv_heads, self.head_dim)
        for layer in range(self.layers):
            for kind in ("k", "v"):
                kv = torch.zeros((self.session_tokens, *shape), dtype=torch.bfloat16,
                                 device=device)
                kv[: self.prefix_tokens] = torch.randn(
                    (self.prefix_tokens, *shape), generator=gen, device=device
                ).to(torch.bfloat16)
                tensors[f"layer{layer}/{kind}"] = kv
        tensors["heap"] = torch.randn(self.heap_bytes // 4, generator=gen, device=device)

        fs = DeltaFS(chunk_bytes=self.chunk_bytes)   # DeltaCR dumps in the store's chunks
        for i in range(self.n_files):
            size = int(rng.integers(64, 1024))
            fs.write(f"repo/file{i}.py", rng.integers(0, 2**31, size=size, dtype=np.int32))
        proc = CowTensorState(tensors, device=device)
        del tensors
        cr = DeltaCR(
            store=fs.store,
            restore_fn=lambda p: CowTensorState(p, device=device),
            policy=DumpPolicy(mode="delta"),
            chunk_bytes=self.chunk_bytes,
        )
        return StateManager(Sandbox(fs, proc), cr), cr

    def turn(self, sm, index: int, gen, rng) -> None:
        """Agent turn ``index`` (from 0): its new tokens land after the
        prefix and the ``index`` turns before it."""
        import numpy as np
        import torch

        device = gen.device
        pos = self.prefix_tokens + index * self.tokens_per_turn
        n = self.tokens_per_turn
        for layer in range(self.layers):
            for kind in ("k", "v"):
                new_kv = torch.randn(
                    (n, self.kv_heads, self.head_dim), generator=gen, device=device
                ).to(torch.bfloat16)
                sm.sandbox.proc.mutate(
                    f"layer{layer}/{kind}", lambda t, v=new_kv: t[pos : pos + n].copy_(v)
                )
        touched = torch.randperm(self.heap_rows, generator=gen, device=device)[: self.heap_touch]
        floats_per_row = self.chunk_bytes // 4
        offs = touched * floats_per_row + torch.randint(
            0, floats_per_row - 16, (self.heap_touch,), generator=gen, device=device
        )
        cols = offs[:, None] + torch.arange(16, device=device)[None, :]
        vals = torch.randn((self.heap_touch, 16), generator=gen, device=device)
        sm.sandbox.proc.mutate(
            "heap", lambda t: t.index_put_((cols.reshape(-1),), vals.reshape(-1))
        )
        f = f"repo/file{int(rng.integers(self.n_files))}.py"
        sm.sandbox.fs.write(f, rng.integers(0, 2**31, size=512, dtype=np.int32))

    def timed_turn(self, sm, cr, index: int, gen, rng, sync, *, profile: bool = False) -> dict:
        """Turn ``index``, then its checkpoint with the dump waited for
        (under ``torch.profiler`` with ``profile``); asserts the kernel path:
        a delta image of exactly the turn's dirty rows, every tensor diffed
        by the kernels, none on the full path.  Returns the checkpoint id,
        its call and dump ms, its device→host bytes, the image and the
        profile (or None)."""
        self.turn(sm, index, gen, rng)
        sync()
        kernel_before, full_before = cr.stats.kernel_keys, cr.stats.full_keys
        d2h_before = cr.pipeline.d2h_bytes
        prof = _start_device_profile() if profile else None
        t0 = time.perf_counter()
        c = sm.checkpoint()
        t1 = time.perf_counter()
        cr.wait_dumps()
        sync()
        t2 = time.perf_counter()
        image = cr.dump_future(c).result()
        if image.mode != "delta" or image.dirtied_chunks != self.want_dirty:
            raise AssertionError(f"checkpoint {c}: a {image.mode} image of {image.dirtied_chunks} "
                                 f"dirty rows, expected delta of {self.want_dirty}")
        if (cr.stats.kernel_keys - kernel_before != self.n_tensors
                or cr.stats.full_keys != full_before):
            raise AssertionError(
                f"checkpoint {c}: kernel_keys +{cr.stats.kernel_keys - kernel_before}, full_keys "
                f"+{cr.stats.full_keys - full_before}; expected +{self.n_tensors} / +0")
        return {"ckpt": c, "checkpoint_ms": (t1 - t0) * 1e3, "dump_ms": (t2 - t0) * 1e3,
                "d2h_bytes": cr.pipeline.d2h_bytes - d2h_before, "image": image,
                "device": None if prof is None else _stop_device_profile(prof, index)}


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
    profile_turn=None,
) -> dict:
    """Drive StateManager(Sandbox(DeltaFS, CowTensorState), DeltaCR) through
    ``turns`` agent turns with a checkpoint after each, then a fast rollback
    and a slow restore; assert every restored byte.  With ``profile_turn``,
    that turn's checkpoint and dump run under ``torch.profiler`` (on the
    card) and stay out of the clock medians.  Returns the metrics."""
    import numpy as np
    import torch

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    cell = CRCell(layers=layers, kv_heads=kv_heads, head_dim=head_dim,
                  session_tokens=session_tokens, prefix_tokens=prefix_tokens,
                  tokens_per_turn=tokens_per_turn, heap_bytes=heap_bytes, n_files=n_files,
                  chunk_bytes=chunk_bytes)
    sm, cr = cell.build(device, gen, rng)
    n_tensors = cell.n_tensors
    want_dirty = cell.want_dirty

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
    device_per_ckpt = None
    saved = {}
    sync()
    torch.cuda.reset_peak_memory_stats() if torch.device(device).type == "cuda" else None
    ckpts = [sm.checkpoint()]
    cr.wait_dumps()
    for turn in range(turns):
        # -- the agent's turn (256 new tokens in every KV tensor, ~1% of the
        #    heap rows and one file rewritten), its checkpoint and dump
        out = cell.timed_turn(sm, cr, turn, gen, rng, sync,
                              profile=on_card and turn == profile_turn)
        ckpts.append(out["ckpt"])
        d2h.append(out["d2h_bytes"])
        image = out["image"]
        if out["device"] is None:
            ckpt_ms.append(out["checkpoint_ms"])
            dump_ms.append(out["dump_ms"])
            stages.append((image.wall_ms, image.encode_ms, image.drain_ms, image.commit_ms,
                           image.stream_windows))
        else:
            device_per_ckpt = out["device"]
        if turn in (turns - 4, turns - 2):
            saved[out["ckpt"]] = snapshot()
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
        "kv_tensors": 2 * cell.layers,
        "files": n_files,
        "checkpoints": len(ckpts),
        "dirtied_chunks_per_checkpoint": want_dirty,
        "timed_turns": len(ckpt_ms),
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
        "device_per_checkpoint": device_per_ckpt,
        "fused_checksum_mismatches": health.get("fused_checksum_mismatches"),
        "dump_retries": health["dump_retries"],
    }


def _start_device_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _stop_device_profile(prof, turn: int, top: int = 8) -> dict:
    """The device time of everything the profiled window ran on the card,
    on any thread (the dump worker launches the dump's kernels)."""
    import torch

    torch.cuda.synchronize()
    prof.stop()
    rows = _device_rows(prof)
    fused = [r for r in rows if "delta_fused" in r[0]]
    return {
        "turn": turn,
        "device_busy_ms": sum(r[1] for r in rows),
        "device_events": sum(r[2] for r in rows),
        "delta_fused_ms": sum(r[1] for r in fused),
        "delta_fused_launches": sum(r[2] for r in fused),
        "top": [[name[:60], ms, n] for name, ms, n in rows[:top]],
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
# phase 8: persistence on the card
# ---------------------------------------------------------------------------
PERSIST_TURNS = 4              # 8a: turns of the C/R cell, a plane save after each
PERSIST_FULL_EVERY = 8         # 8a: PersistencePlane(full_every=8): a full save, then deltas
PERSIST_CHILD_TIMEOUT_S = 600  # 8a: the recovering process's time limit
WARM_STEPS = 4                 # 8b: batched steps of both sessions before the suspend
WARM_TOKENS = 8                # 8b: greedy tokens compared across the teardown


@contextlib.contextmanager
def _spans(sync, targets):
    """Sum the wall time of every call of each ``(owner, name)`` in
    ``targets`` while the block runs (each call ends in ``sync()``); yields
    the sums in ms by name and puts the originals back after."""
    spent = {name: 0.0 for _, name in targets}
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]
    for owner, name, fn in saved:
        def wrapper(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                sync()
                spent[_name] += (time.perf_counter() - t) * 1e3

        setattr(owner, name, wrapper)
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _turn_rngs(device, seed: int, index: int):
    """Turn ``index``'s own generators, so a process that recovers the state
    can replay that turn's writes exactly."""
    import numpy as np
    import torch

    return (torch.Generator(device=device).manual_seed(seed + 1 + index),
            np.random.default_rng(seed + 1 + index))


def _state_digests(sm) -> dict:
    """blake2b of every tensor of the session state and every file."""
    import hashlib

    import numpy as np

    from repro_torch.core.deltafs import host_bytes

    proc, fs = sm.sandbox.proc, sm.sandbox.fs
    out = {k: hashlib.blake2b(host_bytes(proc.get(k)).tobytes(), digest_size=16).hexdigest()
           for k in sorted(proc.keys())}
    out.update({f"file:{k}": hashlib.blake2b(np.ascontiguousarray(fs.read(k)).tobytes(),
                                             digest_size=16).hexdigest()
                for k in sorted(fs.keys())})
    return out


def _image_digest(image) -> str:
    """blake2b over an image's entries: names, shapes, dtypes, pads and
    chunk digests (every entry must carry its digests)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for name, meta in sorted(image.entries.items()):
        if len(meta.digests) != len(meta.chunk_ids):
            raise AssertionError(f"image entry {name} carries no chunk digests")
        h.update(f"{name}|{meta.shape}|{meta.dtype}|{meta.trailing_pad}|".encode())
        h.update(b"".join(meta.digests))
    return h.hexdigest()


def _turn_numbers(out: dict) -> dict:
    """A timed turn's numbers, its image by digest."""
    return {"ckpt": out["ckpt"], "checkpoint_ms": out["checkpoint_ms"],
            "dump_ms": out["dump_ms"], "d2h_bytes": out["d2h_bytes"],
            "image": _image_digest(out["image"])}


def run_persist_path(device, *, cell=None, turns: int = PERSIST_TURNS,
                     full_every: int = PERSIST_FULL_EVERY, seed: int = 0) -> dict:
    """8a: the C/R cell for ``turns`` turns under ``mode="delta"``, a
    ``PersistencePlane`` save into a fresh temporary directory after each;
    then one more turn, whose device→host bytes and image the recovering
    process must reproduce.  The state is torn down, and a fresh process
    (``persist_child``) recovers the root on ``device`` and checks it.
    Returns the numbers of both processes; the directory is removed."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import PersistencePlane
    from repro_torch.core import persist

    cell = cell if cell is not None else CRCell()
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        root = str(Path(tmp) / "root")
        t0 = time.perf_counter()
        sm, cr = cell.build(device, torch.Generator(device=device).manual_seed(seed),
                            np.random.default_rng(seed))
        sm.checkpoint()
        cr.wait_dumps()
        sync()
        build_s = time.perf_counter() - t0
        plane = PersistencePlane(root, full_every=full_every)
        turn_out, saves = [], []
        for index in range(turns):
            turn_out.append(_turn_numbers(cell.timed_turn(
                sm, cr, index, *_turn_rngs(device, seed, index), sync)))
            d2h_before = cr.pipeline.d2h_bytes
            parts = [(persist, "_snapshot_doc_v2"), (persist, "_write_pack")]
            with _spans(sync, parts) as spent:
                t = time.perf_counter()
                seq = plane.save(sm=sm)
                save_ms = (time.perf_counter() - t) * 1e3
            if cr.pipeline.d2h_bytes != d2h_before:
                raise AssertionError(f"save {seq} moved {cr.pipeline.d2h_bytes - d2h_before} "
                                     "device bytes")
            st = plane.last_save_stats
            saves.append({"seq": seq, "kind": st["kind"], "save_ms": save_ms,
                          "doc_build_ms": spent["_snapshot_doc_v2"],
                          "pack_write_ms": spent["_write_pack"],
                          "bytes_written": st["bytes_written"], "pack_bytes": st["pack_bytes"],
                          "doc_bytes": st["doc_bytes"], "new_chunks": st["new_chunks"]})
        if [x["kind"] for x in saves] != ["full"] + ["delta"] * (turns - 1):
            raise AssertionError(f"save kinds {[x['kind'] for x in saves]}")
        want = {"root": root, "device": str(device), "cell": dataclasses.asdict(cell),
                "seed": seed, "turn": turns, "current": sm.current,
                "digests": _state_digests(sm)}
        # the same next turn, here: what the recovered state must reproduce
        want["next_turn"] = _turn_numbers(cell.timed_turn(
            sm, cr, turns, *_turn_rngs(device, seed, turns), sync))
        peak = torch.cuda.max_memory_allocated() if on_card else None
        cr.shutdown()
        del sm, cr, plane
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        spec = str(Path(tmp) / "want.json")
        Path(spec).write_text(json.dumps(want))
        code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]; "
                f"import chip_smoke; chip_smoke.persist_child({spec!r})")
        t = time.perf_counter()
        try:
            child = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), text=True,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   timeout=PERSIST_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as exc:
            raise AssertionError(f"recovering process killed after {exc.timeout} s") from exc
        child_s = time.perf_counter() - t
        if child.returncode != 0:
            raise AssertionError(f"recovering process exited {child.returncode}:\n"
                                 f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
        recovered = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "build_s": build_s,
        "turns": turn_out,
        "saves": saves,
        "next_turn": want["next_turn"],
        "max_memory_allocated": peak,
        "child_process_s": child_s,
        "recovered": recovered,
    }


def persist_child(spec_path: str) -> None:
    """8a's recovering process: ``recover`` the root of ``spec_path`` on its
    device and check (i) every restored tensor and file against the
    writer's digests, (ii) how the trunk came back and that ``delta_apply``
    ran over the anchored parent generation, (iii) that the next turn's
    checkpoint takes the kernel path and moves the device→host bytes, and
    makes the image, that the writer's same turn did.  Prints its numbers
    as one JSON line; raises on any failed check."""
    import torch

    from repro_torch.core import DumpPolicy, StateManager, persist, recover
    from repro_torch.core.delta_pipeline import DeltaDumpPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts

    want = json.loads(Path(spec_path).read_text())
    device = torch.device(want["device"])
    cell = CRCell(**want["cell"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    parts = [(persist, "_fold_chain"), (persist, "_load_chunks_v2"),
             (persist, "_read_pack_chunk"),
             (DeltaDumpPipeline, "rebuild_generation"), (StateManager, "restore")]
    reset_launch_counts()
    with _spans(sync, parts) as spent:
        t = time.perf_counter()
        rec = recover(want["root"], device=device, policy=DumpPolicy(mode="delta"))
        sync()
        recover_ms = (time.perf_counter() - t) * 1e3
    recover_launches = dict(launch_counts())
    sm, cr = rec.state_manager, rec.deltacr
    anchors = cr.pipeline.anchored_ids()
    # (i) the restored bytes, against the writer's digests
    got = _state_digests(sm)
    if got != want["digests"]:
        bad = sorted(k for k in set(got) | set(want["digests"])
                     if got.get(k) != want["digests"].get(k))
        raise AssertionError(f"recovered state differs in {len(bad)} entries: {bad[:8]}")
    # (ii) the trunk's restore scattered over its anchored parent generation
    image = cr.images.image_for(rec.current)
    if rec.current != want["current"] or rec.trunk_restore_mode != "slow":
        raise AssertionError(f"trunk at {rec.current} by {rec.trunk_restore_mode!r}, expected "
                             f"{want['current']} by 'slow'")
    if image.parent_id not in anchors:
        raise AssertionError(f"parent image {image.parent_id} not among anchors {anchors}")
    if on_card and recover_launches["delta_apply"] <= 0:
        raise AssertionError("the restore over the anchored parent launched no delta_apply")
    # (iii) the next turn's checkpoint, on the kernel path
    reset_launch_counts()
    turn = _turn_numbers(cell.timed_turn(
        sm, cr, want["turn"], *_turn_rngs(device, want["seed"], want["turn"]), sync))
    turn_launches = dict(launch_counts())
    ref = want["next_turn"]
    if turn["d2h_bytes"] != ref["d2h_bytes"] or turn["image"] != ref["image"]:
        raise AssertionError(f"post-recovery turn: {turn['d2h_bytes']} B device→host, image "
                             f"{turn['image']}; the writer's turn: {ref['d2h_bytes']} B, "
                             f"{ref['image']}")
    if on_card and turn_launches["delta_fused"] <= 0:
        raise AssertionError("the post-recovery checkpoint launched no delta_fused")
    # one more turn, for information: the first dump's cost against a warm one
    second = _turn_numbers(cell.timed_turn(
        sm, cr, want["turn"] + 1, *_turn_rngs(device, want["seed"], want["turn"] + 1), sync))
    turns_launches = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated() if on_card else None
    cr.shutdown()
    print(json.dumps({
        "seq": rec.seq,
        "trunk_restore_mode": rec.trunk_restore_mode,
        "current": rec.current,
        "anchors": anchors,
        "restore_parent_image": image.parent_id,
        "recover_ms": recover_ms,
        "read_ms": recover_ms - spent["rebuild_generation"] - spent["restore"],
        "read_docs_ms": spent["_fold_chain"],
        "read_packs_ms": spent["_load_chunks_v2"],
        "read_packs_io_ms": spent["_read_pack_chunk"],
        "anchor_rebuild_ms": spent["rebuild_generation"],
        "trunk_restore_ms": spent["restore"],
        "recover_launches": recover_launches,
        "checkpoint_ms": turn["checkpoint_ms"],
        "dump_ms": turn["dump_ms"],
        "d2h_bytes": turn["d2h_bytes"],
        "second_turn": {k: second[k] for k in ("checkpoint_ms", "dump_ms", "d2h_bytes")},
        "turn_launches": turn_launches,
        "launches": {k: recover_launches[k] + turns_launches[k] for k in recover_launches},
        "tensors_checked": sum(1 for k in got if not k.startswith("file:")),
        "files_checked": sum(1 for k in got if k.startswith("file:")),
        "max_memory_allocated": peak,
    }), flush=True)


def run_warm_pool_path(
    device,
    *,
    model=None,
    config: str = SERVE_CONFIG,
    num_pages: int = SERVE_PAGES,
    page_size: int = SERVE_PAGE_SIZE,
    max_pages: int = SERVE_MAX_PAGES,
    prompt_len: int = SERVE_PROMPT,
    steps: int = WARM_STEPS,
    tokens: int = WARM_TOKENS,
    seed: int = 0,
) -> dict:
    """8b: a ``Scheduler(persist_path=...)`` over a fresh pool serves two
    sessions on phase 6's prompt, suspends one and drains, so the manifest
    commits; a fast fork of the suspended session decodes ``tokens`` greedy
    tokens.  Scheduler, DeltaCR and pool are then freed, and
    ``Scheduler.recover`` over a new pool and engine (same weights) must
    resume the session to decode the same tokens.  Returns the numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import DeltaCR
    from repro_torch.serve import (
        Engine,
        PagePool,
        PagedSession,
        SamplingParams,
        Scheduler,
        SchedulerConfig,
    )

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if model is None:
        model = build_serving_model(device, config, seed)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()   # phase 6's prompt
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def new_pool():
        return PagePool(cfg, num_pages=num_pages, page_size=page_size,
                        max_pages_per_session=max_pages, device=device)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_warm_pool_")
    try:
        root = str(Path(tmp) / "warm-pool")
        pool = new_pool()
        eng = Engine(model, pool)
        cr = DeltaCR(template_pool_size=8,
                     restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
        sched = Scheduler(eng, cr, SchedulerConfig(max_batch=4, persist_path=root))
        a = sched.submit(prompt, SamplingParams())
        b = sched.submit(prompt, SamplingParams())
        for _ in range(steps):
            sched.step()
        before = list(sched.handles[a].session.tokens)
        sched.suspend(a)                           # coalesced: the eviction waits for the dump
        ckpt = sched.handles[a].ckpt_id
        fork, path = cr.restore(ckpt)               # the template is still live: a fast fork
        if path != "fast":
            raise AssertionError(f"fork of the suspended session took the {path} path")
        want = [int(eng.step([fork])[0]) for _ in range(tokens)]
        fork.release()
        cr.wait_dumps()
        t = time.perf_counter()
        if sched._drain_suspends() < 1:
            raise AssertionError("the landed dump evicted no template")
        drain_ms = (time.perf_counter() - t) * 1e3
        health = sched.health()
        save = dict(sched.plane.last_save_stats)
        if health.get("persist_saves") != 1 or save["kind"] != "full":
            raise AssertionError(f"plane after the drain: {health.get('persist_saves')} saves, "
                                 f"{save.get('kind')}")
        steps_before = eng.decode_steps
        sched.finish(b)
        cr.shutdown()
        del sched, cr, eng, pool, fork
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        freed_to = torch.cuda.memory_allocated() if on_card else None

        pool2 = new_pool()
        eng2 = Engine(model, pool2)
        sync()
        t = time.perf_counter()
        sched2 = Scheduler.recover(
            eng2, root, restore_fn=lambda p: PagedSession.restore_from_payload(pool2, p))
        sync()
        recover_ms = (time.perf_counter() - t) * 1e3
        handles = sorted((h.sid, h.state) for h in sched2.handles.values())
        if handles != [(a, "suspended")]:
            raise AssertionError(f"recovered handles {handles}, expected [({a}, 'suspended')]")
        t = time.perf_counter()
        sched2.resume(a)
        sync()
        resume_ms = (time.perf_counter() - t) * 1e3
        if list(sched2.handles[a].session.tokens) != before:
            raise AssertionError("the resumed session's tokens differ from the suspended one's")
        got = [int(sched2.step()[a]) for _ in range(tokens)]
        if got != want:
            raise AssertionError(f"resumed session decoded {got}, the fast fork {want}")
        peak = torch.cuda.max_memory_allocated() if on_card else None
        sched2.finish(a)
        sched2.cr.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "config": cfg.name,
        "prompt_tokens": prompt_len,
        "session_tokens": len(before),
        "tokens": got,
        "save": save,
        "drain_and_save_ms": drain_ms,
        "memory_after_teardown": freed_to,
        "recover_ms": recover_ms,
        "resume_ms": resume_ms,
        "decode_steps": steps_before + eng2.decode_steps,
        "layers": cfg.n_layers,
        "max_memory_allocated": peak,
    }


# ---------------------------------------------------------------------------
# phase 11: shard-native dumps over a logical mesh on the card
# ---------------------------------------------------------------------------
SHARD_MESH = (4, 2)             # ("data", "model") ranks, all on the one card
SHARD_MESH_OTHER = (2, 4)       # 11a's second restore layout
SHARD_CHECK_TURNS = 2           # 11a: turns whose images are held against the (1, 1) layout
SHARD_SERVE_STEPS = 8           # 11b: decode steps between the two checkpoints
SHARD_FORK_STEPS = 4            # 11b: batched steps of the four forks


def _shard_specs(mesh) -> dict:
    """11a's layout: each KV tensor's sequence over "data" and heads over
    "model" (``cache_specs(long_context=True)`` and the pool's TP split);
    the heap over "model"."""
    from repro_torch.dist.placement import NamedSharding, PartitionSpec as P

    return {"kv": NamedSharding(mesh, P("data", "model", None)),
            "heap": NamedSharding(mesh, P("model"))}


def _shard_cell_state(cell, device, seed: int, mesh_shape):
    """Phase 4's C/R cell as a ``ShardedTensorState`` on a logical mesh of
    ``mesh_shape``; returns the state and each key's sharding."""
    import torch

    from repro_torch.dist.placement import device_put
    from repro_torch.dist.shard_dump import ShardedTensorState
    from repro_torch.launch.mesh import make_logical_mesh

    gen = torch.Generator(device=device).manual_seed(seed)
    specs = _shard_specs(make_logical_mesh(mesh_shape, device=device))
    arrays, shardings = {}, {}
    for layer in range(cell.layers):
        for kind in ("k", "v"):
            kv = torch.zeros((cell.session_tokens, cell.kv_heads, cell.head_dim),
                             dtype=torch.bfloat16, device=device)
            kv[: cell.prefix_tokens] = torch.randn(
                (cell.prefix_tokens, cell.kv_heads, cell.head_dim), generator=gen, device=device
            ).to(torch.bfloat16)
            key = f"layer{layer}/{kind}"
            arrays[key], shardings[key] = device_put(kv, specs["kv"]), specs["kv"]
            del kv
    heap = torch.randn(cell.heap_bytes // 4, generator=gen, device=device)
    arrays["heap"], shardings["heap"] = device_put(heap, specs["heap"]), specs["heap"]
    return ShardedTensorState(arrays), shardings


def _shard_turn(cell, state, index: int, device, seed: int) -> None:
    """Phase 4's agent turn ``index`` through ``set``: its tokens into every
    KV tensor and 1% of the heap's rows, drawn from the turn's own
    generator so another layout can replay it."""
    import torch

    gen, _ = _turn_rngs(device, seed, index)
    pos = cell.prefix_tokens + index * cell.tokens_per_turn
    n = cell.tokens_per_turn
    for layer in range(cell.layers):
        for kind in ("k", "v"):
            key = f"layer{layer}/{kind}"
            new_kv = torch.randn((n, cell.kv_heads, cell.head_dim), generator=gen,
                                 device=device).to(torch.bfloat16)
            state.set(key, state.get(key).with_box((slice(pos, pos + n),), new_kv))
    touched = torch.randperm(cell.heap_rows, generator=gen, device=device)[: cell.heap_touch]
    floats_per_row = cell.chunk_bytes // 4
    offs = touched * floats_per_row + torch.randint(
        0, floats_per_row - 16, (cell.heap_touch,), generator=gen, device=device
    )
    cols = (offs[:, None] + torch.arange(16, device=device)[None, :]).reshape(-1)
    vals = torch.randn((cell.heap_touch * 16,), generator=gen, device=device)
    state.set("heap", state.get("heap").with_flat(cols, vals))


def _image_chunk_digests(image) -> dict:
    return {k: (tuple(m.tile_grid), m.digests) for k, m in sorted(image.entries.items())}


def _part_plan(cr, image, parent, state) -> dict:
    """What the per-part dump of ``image`` must have moved, from its entries
    against ``parent``'s: per rank, the row bytes (a part's dirty tiles, or
    all of its tiles where they overflow its capacity), and the parts by
    route: kernel-diffed with a dirty tile, overflowed, fused-sized."""
    import numpy as np

    from repro_torch.dist import shard_dump as sd

    rows = {}
    routes = {"dirty_parts": 0, "overflow_parts": 0, "fused_parts": 0, "unfused_parts": 0}
    kv_ranks, heap_ranks = set(), set()
    pipe = cr.pipeline
    for key, meta in image.entries.items():
        if not meta.tile_grid:
            continue
        plan = sd.TilePlan.from_meta(meta)
        old = parent.entries[key].chunk_ids
        dirty = np.asarray([a != b for a, b in zip(meta.chunk_ids, old)])
        for part in sd.sharded_view(state.get(key), plan).parts:
            k2 = 1 << (part.n_local - 1).bit_length()
            cap = pipe._capacity(k2)
            fused = pipe.fused and cap * plan.tile_bytes <= pipe.FUSED_VMEM_BYTES
            routes["fused_parts" if fused else "unfused_parts"] += 1
            d = int(dirty[part.tile_ids].sum())
            if not d:
                continue
            routes["dirty_parts"] += 1
            n = part.n_local if d > cap else d
            routes["overflow_parts"] += int(d > cap)
            rows[part.rank] = rows.get(part.rank, 0) + n * plan.tile_bytes
            (heap_ranks if key == "heap" else kv_ranks).add(part.rank)
    return {"rows_by_rank": rows, "kv_ranks": sorted(kv_ranks),
            "heap_ranks": sorted(heap_ranks), **routes}


def _device_frees() -> int:
    """``cudaFree`` calls of the caching allocator so far (0 off the card)."""
    import torch

    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_stats().get("num_device_free", 0))


def _full_clone(state) -> dict:
    """A device clone of every tensor, assembled from its blocks."""
    return {k: state.get(k).full() for k in state.keys()}


def _check_clone(state, saved: dict, what: str, sharding=None) -> None:
    import torch

    if sorted(state.keys()) != sorted(saved):
        raise AssertionError(f"{what}: restored keys differ")
    for k, want in saved.items():
        got = state.get(k)
        if sharding is not None and got.sharding is not sharding[k]:
            raise AssertionError(f"{what}: {k} restored under {got.sharding}, not the target")
        if not torch.equal(got.full(), want):
            raise AssertionError(f"{what}: tensor {k} differs")


def run_shard_path(
    device,
    *,
    layers: int = QWEN3_14B_LAYERS,
    kv_heads: int = QWEN3_14B_KV_HEADS,
    head_dim: int = QWEN3_14B_HEAD_DIM,
    session_tokens: int = SESSION_TOKENS,
    prefix_tokens: int = PREFIX_TOKENS,
    tokens_per_turn: int = TOKENS_PER_TURN,
    heap_bytes: int = HEAP_BYTES,
    turns: int = TURNS,
    chunk_bytes: int = CHUNK_BYTES,
    mesh_shape=SHARD_MESH,
    other_shape=SHARD_MESH_OTHER,
    check_turns: int = SHARD_CHECK_TURNS,
    seed: int = 0,
) -> dict:
    """11a: phase 4's C/R cell as a ``ShardedTensorState`` on a logical
    ``mesh_shape`` mesh under ``DeltaCR(mode="delta")``: ``turns`` turns with
    a checkpoint after each, a fast rollback, a slow restore onto the same
    layout and one onto ``other_shape``, and one more turn and checkpoint on
    the state restored onto the first layout.  Gates: restores
    byte-identical to device clones; no gather; the per-rank fetched bytes
    sum to the pipeline's device→host bytes (on the card) and each rank's
    row bytes are its parts' dirty tiles; the first ``check_turns`` images
    equal the (1, 1) layout's; the last turn's digests equal blake2b over
    ``array_to_grid`` rows; on the card, one ``delta_apply`` per part with
    dirty tiles on each slow restore and one delta-kernel launch per part
    on the dump after it.  Returns the metrics."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.core.chunk_store import chunk_digest
    from repro_torch.dist import shard_dump as sd
    from repro_torch.dist.placement import NamedSharding
    from repro_torch.dist.shard_dump import ShardedTensorState
    from repro_torch.kernels import launch_counts, ops as kops
    from repro_torch.launch.mesh import make_logical_mesh

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    cell = CRCell(layers=layers, kv_heads=kv_heads, head_dim=head_dim,
                  session_tokens=session_tokens, prefix_tokens=prefix_tokens,
                  tokens_per_turn=tokens_per_turn, heap_bytes=heap_bytes, chunk_bytes=chunk_bytes)
    policy = DumpPolicy(mode="delta")

    # -- the (1, 1) layout: the yardstick of the first turns' images
    ref_state, _ = _shard_cell_state(cell, device, seed, (1, 1))
    ref_cr = DeltaCR(policy=policy, chunk_bytes=chunk_bytes)
    ref_cr.checkpoint(ref_state, 0, None)
    for i in range(check_turns):
        _shard_turn(cell, ref_state, i, device, seed)
        ref_cr.checkpoint(ref_state, i + 1, i)
    ref_cr.wait_dumps()
    want_images = {c: _image_chunk_digests(ref_cr.dump_future(c).result())
                   for c in range(check_turns + 1)}
    ref_cr.shutdown()
    del ref_state, ref_cr
    gc.collect()

    # -- the sharded layout
    state, shard_a = _shard_cell_state(cell, device, seed, mesh_shape)
    mesh_b = make_logical_mesh(other_shape, device=device)
    shard_b = {k: NamedSharding(mesh_b, s.spec) for k, s in shard_a.items()}
    target = dict(shard_a)
    cr = DeltaCR(policy=policy, chunk_bytes=chunk_bytes,
                 restore_fn=lambda p: ShardedTensorState.restore_from_payload(p, target))
    sd.reset_fetch_stats()
    sync()
    t = time.perf_counter()
    cr.checkpoint(state, 0, None)
    cr.wait_dumps()
    sync()
    first_ms = (time.perf_counter() - t) * 1e3
    if sd.fetch_stats()["gather_bytes"]:
        raise AssertionError(f"the first dump gathered: {sd.fetch_stats()}")
    if _image_chunk_digests(cr.dump_future(0).result()) != want_images[0]:
        raise AssertionError("checkpoint 0 differs from the (1, 1) layout's")
    rows_per_data = session_tokens // mesh_shape[0]

    def checked_dump(st, c, parent_c, what):
        """Checkpoint ``st`` as ``c`` over ``parent_c`` and hold its ledger."""
        sd.reset_fetch_stats()
        d2h0 = cr.pipeline.d2h_bytes
        evictions0 = cr.stats.evictions
        sync()
        frees0 = _device_frees()
        t0 = time.perf_counter()
        cr.checkpoint(st, c, parent_c)
        t1 = time.perf_counter()
        # a call that admits a template past the pool's size releases the
        # oldest one inside it: report that, and the allocator's cudaFree
        # calls, beside the call's time
        evicted = cr.stats.evictions - evictions0
        device_frees = _device_frees() - frees0
        cr.wait_dumps()
        sync()
        t2 = time.perf_counter()
        image = cr.dump_future(c).result()
        parent = cr.dump_future(parent_c).result()
        snap = sd.fetch_stats()
        d2h = cr.pipeline.d2h_bytes - d2h0
        if image.mode != "delta":
            raise AssertionError(f"{what}: a {image.mode} image")
        if snap["gather_bytes"] or snap["gathers"]:
            raise AssertionError(f"{what}: the dump gathered {snap['gather_bytes']} B")
        if sum(snap["by_rank"].values()) != snap["fetched_bytes"]:
            raise AssertionError(f"{what}: per-rank bytes do not sum to the fetched bytes")
        if on_card and d2h != snap["fetched_bytes"]:
            raise AssertionError(f"{what}: {d2h} B device->host, the ranks fetched "
                                 f"{snap['fetched_bytes']} B")
        plan = _part_plan(cr, image, parent, st)
        got_rows = {r: b for r, b in snap["rows_by_rank"].items() if b}
        if got_rows != plan["rows_by_rank"]:
            raise AssertionError(f"{what}: rows by rank {got_rows}, expected "
                                 f"{plan['rows_by_rank']}")
        return image, {"ckpt": c, "checkpoint_ms": (t1 - t0) * 1e3,
                       "templates_evicted": evicted, "device_frees": device_frees,
                       "dump_ms": (t2 - t0) * 1e3, "d2h_bytes": d2h,
                       "fetched_bytes": snap["fetched_bytes"], "row_bytes": snap["row_bytes"],
                       "rows_by_rank": got_rows, "dirtied_chunks": image.dirtied_chunks,
                       "shard_parts": image.shard_parts, **plan}

    turn_rows, saved = [], {}
    fast_c, slow_c = turns - 2, turns
    before_last = None
    for i in range(turns):
        if i == turns - 1:
            before_last = {k: state.get(k) for k in state.keys()}
        _shard_turn(cell, state, i, device, seed)
        image, row = checked_dump(state, i + 1, i, f"turn {i + 1}")
        pos = prefix_tokens + i * tokens_per_turn
        want_kv = sorted(int(r) for r in make_logical_mesh(mesh_shape, device=device)
                         .ranks[pos // rows_per_data])
        if row["kv_ranks"] != want_kv:
            raise AssertionError(f"turn {i + 1}: KV rows from ranks {row['kv_ranks']}, "
                                 f"expected {want_kv}")
        if i + 1 <= check_turns and _image_chunk_digests(image) != want_images[i + 1]:
            raise AssertionError(f"checkpoint {i + 1} differs from the (1, 1) layout's")
        turn_rows.append(row)
        if i + 1 in (fast_c, slow_c):
            saved[i + 1] = _full_clone(state)
    # -- the last image against blake2b over the port's array_to_grid rows
    #    (hashed on the host's cores: blake2b releases the GIL)
    t = time.perf_counter()
    last = cr.dump_future(slow_c).result()
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        for key, meta in last.entries.items():
            host = kops.shard_fetch_assemble(state.get(key))
            rows = sd.array_to_grid(host, sd.TilePlan.from_meta(meta))
            if tuple(pool.map(lambda r: chunk_digest(r, 0), rows)) != meta.digests:
                raise AssertionError(f"checkpoint {slow_c}: {key}'s digests differ from its rows")
    digest_check_s = time.perf_counter() - t

    # -- shard_block_encode on one KV part and one heap part, as the dumps ran it
    block_ms = {}
    if on_card:
        flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)
        for key in ("layer0/k", "heap"):
            plan = sd.TilePlan.from_meta(last.entries[key])
            old_view = sd.sharded_view(before_last[key], plan)
            new_view = sd.sharded_view(state.get(key), plan)
            part, old_part = new_view.parts[0], old_view.parts[0]
            cap = cr.pipeline._capacity(1 << (part.n_local - 1).bit_length())
            ob, nb = old_part.block_fn(), part.block_fn()
            # bound: both blocks read once, the capacity's rows, slots and
            # count written once
            block_ms[key] = {
                "block": list(nb.shape), "tiles": part.n_local, "cap": cap,
                "ms": time_ms(lambda: kops.shard_block_encode(
                    ob, nb, tuple(part.counts), tuple(plan.tile), cap), flush=flush),
                "bound_ms": bound_ms(2 * nb.nbytes + cap * (plan.tile_bytes + 4) + 4),
            }
        del flush
    del before_last

    # -- fast rollback (a template fork)
    fast = []
    for _ in range(5):
        sync()
        t = time.perf_counter()
        rolled, how = cr.restore(fast_c)
        sync()
        fast.append((time.perf_counter() - t) * 1e3)
        if how != "fast":
            raise AssertionError(f"rollback to {fast_c} took the {how} path")
    _check_clone(rolled, saved[fast_c], f"fast restore of {fast_c}")

    def slow_restore(layout, name):
        target.clear()
        target.update(layout)
        if not cr.evict_template(slow_c):
            raise AssertionError(f"no template to evict for {slow_c}")
        before = launch_counts()["delta_apply"]
        sync()
        t0 = time.perf_counter()
        got, how = cr.restore(slow_c)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        if how != "slow":
            raise AssertionError(f"{name}: restore of {slow_c} took the {how} path")
        _check_clone(got, saved[slow_c], name, sharding=layout)
        return got, ms, launch_counts()["delta_apply"] - before

    parent_of_slow = cr.dump_future(slow_c - 1).result()
    want_apply = _part_plan(cr, last, parent_of_slow, state)["dirty_parts"]
    restored_a, slow_a_ms, apply_a = slow_restore(shard_a, f"slow restore of {slow_c} onto {mesh_shape}")
    restored_b, slow_b_ms, apply_b = slow_restore(shard_b, f"slow restore of {slow_c} onto {other_shape}")
    target.clear()
    target.update(shard_a)
    if on_card and (apply_a != want_apply or apply_b != want_apply):
        raise AssertionError(f"slow restores launched delta_apply {apply_a} and {apply_b} "
                             f"times, expected {want_apply} (one per part with dirty tiles)")
    restored_b.release()

    # -- one more turn on the state restored onto the first layout: its base
    #    is the decoded generation's owned part grids, so every part takes
    #    the delta kernels (fused, or delta_diff past the fused budget)
    _shard_turn(cell, restored_a, turns, device, seed)
    before = launch_counts()
    _, post = checked_dump(restored_a, turns + 1, slow_c, "the dump after the restore")
    after = launch_counts()
    post["launches"] = {k: after[k] - before[k] for k in ("delta_fused", "delta_diff")}
    if on_card and (post["launches"]["delta_fused"] != post["fused_parts"]
                    or post["launches"]["delta_diff"] != post["unfused_parts"]):
        raise AssertionError(f"the dump after the restore launched {post['launches']}, "
                             f"expected {post['fused_parts']} fused and "
                             f"{post['unfused_parts']} delta_diff (one per part)")
    health = cr.health()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    restored_a.release()
    rolled.release()
    cr.shutdown()
    del state, saved
    gc.collect()
    kv_plan = sd.TilePlan.from_meta(last.entries["layer0/k"])
    heap_plan = sd.TilePlan.from_meta(last.entries["heap"])
    return {
        "mesh": list(mesh_shape),
        "kv_plan": {"grid": list(kv_plan.grid), "tile": list(kv_plan.tile),
                    "tile_bytes": kv_plan.tile_bytes},
        "heap_plan": {"grid": list(heap_plan.grid), "tile": list(heap_plan.tile),
                      "tile_bytes": heap_plan.tile_bytes},
        "first_dump_ms": first_ms,
        "checkpoint_call_ms_median": statistics.median(r["checkpoint_ms"] for r in turn_rows),
        "dump_complete_ms_median": statistics.median(r["dump_ms"] for r in turn_rows),
        "d2h_bytes_per_checkpoint_median": statistics.median(r["d2h_bytes"] for r in turn_rows),
        "row_bytes_per_checkpoint_median": statistics.median(r["row_bytes"] for r in turn_rows),
        "turns": [{k: v for k, v in r.items() if k != "rows_by_rank"} for r in turn_rows],
        "rows_by_rank_last_turn": turn_rows[-1]["rows_by_rank"],
        "digest_check_s": digest_check_s,
        "shard_block_encode": block_ms,
        "fast_restore_ms_median": statistics.median(fast),
        "slow_restore_ms": {"same_layout": slow_a_ms, "other_layout": slow_b_ms},
        "delta_apply_per_slow_restore": apply_a,
        "post_restore_dump": post,
        "sharded_dumps": health["sharded_dumps"],
        "shard_parts": health["shard_parts"],
        "max_memory_allocated": peak,
        "phase_s": time.perf_counter() - t_phase,
    }


def _pre_steps(prompt_len: int, page_size: int, steps: int, limit: int = 4096) -> int:
    """The fewest decode steps after the prompt from which ``steps`` more
    stay within the same power-of-two page count: the two checkpoints then
    share one tile plan, so the second diffs per part against the first."""
    for k in range(limit):
        s1 = prompt_len + k
        n1, n2 = -(-s1 // page_size), -(-(s1 + steps) // page_size)
        if n1 == n2 and n1 & (n1 - 1) == 0:
            return k
    raise ValueError(f"no pre-step count fits {steps} steps in {page_size}-token pages")


def run_sharded_serving_path(
    device,
    *,
    model=None,
    config: str = SERVE_CONFIG,
    num_pages: int = SERVE_PAGES,
    page_size: int = SERVE_PAGE_SIZE,
    max_pages: int = SERVE_MAX_PAGES,
    prompt_len: int = SERVE_PROMPT,
    steps: int = SHARD_SERVE_STEPS,
    forks: int = SERVE_FORKS,
    fork_steps: int = SHARD_FORK_STEPS,
    slow_steps: int = SERVE_SLOW_STEPS,
    mesh_shape=SHARD_MESH,
    chunk_bytes: int = CHUNK_BYTES,
    seed: int = 0,
) -> dict:
    """11b: serving from a pool laid over a logical mesh (KV heads over
    "model"): phase 6's prompt, prefill, decode to a power-of-two page
    count, a checkpoint, ``steps`` steps, a delta checkpoint, ``forks`` fast
    forks at B = ``forks``, and a slow restore that must decode exactly what
    a fast fork decodes; then the trunk decodes until it gains a page and
    checkpoints again (c3, whose plan differs from c2's, so it drains
    whole).  Gates: every KV image entry tiled, no gather, the ranks'
    fetched bytes equal to the device→host bytes of c1, c2 and c3, no page
    copied at a fork, and (on the card) one ``delta_apply`` per part with
    dirty tiles on the slow restore.  Returns the metrics, with
    ``slow_restore_parts`` (each such part's tiles, tile bytes and dirty
    tiles) for :func:`check_apply_parts`."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.dist import shard_dump as sd
    from repro_torch.dist.placement import NamedSharding, PartitionSpec as P
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.serve import Engine, PagePool, PagedSession

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(seed)
    if model is None:
        model = build_serving_model(device, config, seed)
    cfg = model.cfg
    mesh = make_logical_mesh(mesh_shape, device=device)
    pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device,
                    sharding=NamedSharding(mesh, P(None, None, None, "model", None)))
    eng = Engine(model, pool)
    prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
    pre = _pre_steps(prompt_len, page_size, steps)
    trunk = eng.new_session(prompt)
    for _ in range(pre):
        eng.step([trunk])
    cr = DeltaCR(async_warm=False, policy=DumpPolicy(mode="delta"), chunk_bytes=chunk_bytes,
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    sd.reset_fetch_stats()
    cr.checkpoint(trunk, 1, None)
    cr.wait_dumps()
    d2h_c1 = cr.pipeline.d2h_bytes
    snap1 = sd.fetch_stats()
    first_gather = snap1["gather_bytes"]
    if on_card and d2h_c1 != snap1["fetched_bytes"]:
        raise AssertionError(f"c1: {d2h_c1} B device->host, the ranks fetched "
                             f"{snap1['fetched_bytes']} B")
    for _ in range(steps):
        eng.step([trunk])
    sd.reset_fetch_stats()
    d2h0 = cr.pipeline.d2h_bytes
    sync()
    t = time.perf_counter()
    cr.checkpoint(trunk, 2, 1)
    ckpt_ms = (time.perf_counter() - t) * 1e3
    cr.wait_dumps()
    sync()
    dump_ms = (time.perf_counter() - t) * 1e3
    d2h = cr.pipeline.d2h_bytes - d2h0
    snap = sd.fetch_stats()
    img1, img2 = cr.dump_future(1).result(), cr.dump_future(2).result()
    kv_keys = [k for k in img2.entries if k.startswith("kv/")]
    if not kv_keys or not all(img.entries[k].tile_grid for img in (img1, img2) for k in kv_keys):
        raise AssertionError("a KV image entry is not tiled")
    if img2.mode != "delta" or first_gather or snap["gather_bytes"] or snap["gathers"]:
        raise AssertionError(f"c2: a {img2.mode} image, {first_gather} B and "
                             f"{snap['gather_bytes']} B gathered")
    if on_card and d2h != snap["fetched_bytes"]:
        raise AssertionError(f"c2: {d2h} B device->host, the ranks fetched "
                             f"{snap['fetched_bytes']} B")
    # the parts the slow restore scatters into: those of c1's anchored
    # generation with a dirty tile: [tiles, tile bytes, dirty tiles] each
    apply_parts = []
    dirty_tiles = 0
    rec = cr.pipeline.record_for(1)
    try:
        for k in kv_keys:
            dirty = np.asarray([a != b for a, b in zip(img2.entries[k].chunk_ids,
                                                        img1.entries[k].chunk_ids)])
            dirty_tiles += int(dirty.sum())
            view = rec.views[k]
            apply_parts += [[p.n_local, view.chunk_bytes, int(dirty[p.tile_ids].sum())]
                            for p in view.parts if dirty[p.tile_ids].any()]
    finally:
        cr.pipeline.release_record(rec)
    want_apply = len(apply_parts)

    # -- fast forks at B = forks: no page copied at a fork
    copied0 = pool.stats.copied_pages
    fork_ms, kids = [], []
    for _ in range(forks):
        t = time.perf_counter()
        kid, how = cr.restore(2)
        fork_ms.append((time.perf_counter() - t) * 1e3)
        if how != "fast":
            raise AssertionError(f"fork of c2 took the {how} path")
        kids.append(kid)
    if pool.stats.copied_pages != copied0:
        raise AssertionError("forking copied pages")
    for kid, a in zip(kids, rng.choice(cfg.vocab_size, size=forks, replace=False).tolist()):
        kid.tokens[-1] = int(a)
    for _ in range(fork_steps):
        eng.step(kids)

    # -- slow restore of c2 against a fast fork
    fast = cr.restore(2)[0]
    if not cr.evict_template(2):
        raise AssertionError("no template to evict for c2")
    before = launch_counts()["delta_apply"]
    sync()
    t = time.perf_counter()
    slow, how = cr.restore(2)
    sync()
    slow_ms = (time.perf_counter() - t) * 1e3
    applied = launch_counts()["delta_apply"] - before
    if how != "slow":
        raise AssertionError(f"restore of c2 after eviction took the {how} path")
    if on_card and applied != want_apply:
        raise AssertionError(f"the slow restore launched delta_apply {applied} times, "
                             f"expected {want_apply} (one per part with dirty tiles)")
    outs = {}
    for name, sess in (("slow", slow), ("fast", fast)):
        toks, logits = [], []
        for _ in range(slow_steps):
            toks += eng.step([sess])
            logits.append(torch.from_numpy(np.array(sess.extras["last_logits"])))
        outs[name] = (toks, logits)
    if outs["slow"][0] != outs["fast"][0] or not all(
        torch.equal(a, b) for a, b in zip(outs["slow"][1], outs["fast"][1])
    ):
        raise AssertionError("slow-restored and fast-forked sessions decode differently")

    # -- a delta checkpoint after the trunk gains a page: the grid's shape,
    # and so its tile plan, differs from c2's, so every part drains whole
    pages_c2 = trunk.n_pages
    while trunk.n_pages == pages_c2:
        eng.step([trunk])
    sd.reset_fetch_stats()
    d2h0 = cr.pipeline.d2h_bytes
    cr.checkpoint(trunk, 3, 2)
    cr.wait_dumps()
    d2h_c3 = cr.pipeline.d2h_bytes - d2h0
    snap3 = sd.fetch_stats()
    img3 = cr.dump_future(3).result()
    if snap3["gather_bytes"] or snap3["gathers"]:
        raise AssertionError(f"c3: {snap3['gather_bytes']} B gathered")
    if on_card and d2h_c3 != snap3["fetched_bytes"]:
        raise AssertionError(f"c3: {d2h_c3} B device->host, the ranks fetched "
                             f"{snap3['fetched_bytes']} B")
    kv_bytes_c3 = sum(int(np.prod(img3.entries[k].shape)) * 2 for k in kv_keys)
    health = cr.health()
    for sess in kids + [fast, slow, trunk]:
        sess.release()
    cr.shutdown()
    plan = sd.TilePlan.from_meta(img2.entries[kv_keys[0]])
    plan3 = sd.TilePlan.from_meta(img3.entries[kv_keys[0]])
    return {
        "config": cfg.name,
        "mesh": list(mesh_shape),
        "pages": plan.shape[0],
        "pre_steps": pre,
        "kv_plan": {"shape": list(plan.shape), "grid": list(plan.grid),
                    "tile_bytes": plan.tile_bytes},
        "checkpoint_call_ms": ckpt_ms,
        "dump_complete_ms": dump_ms,
        "d2h_bytes_c1": d2h_c1,
        "fetched_bytes_c1": snap1["fetched_bytes"],
        "d2h_bytes_c2": d2h,
        "fetched_bytes_c2": snap["fetched_bytes"],
        "dirty_tiles_c2": dirty_tiles,
        "slow_restore_parts": apply_parts,
        "c3_pages": plan3.shape[0],
        "c3_kv_plan_grid": list(plan3.grid),
        "d2h_bytes_c3_new_page": d2h_c3,
        "fetched_bytes_c3": snap3["fetched_bytes"],
        "kv_bytes_c3": kv_bytes_c3,
        "fork_ms_median": statistics.median(fork_ms),
        "slow_restore_ms": slow_ms,
        "delta_apply_slow_restore": applied,
        "shard_parts": health["shard_parts"],
        "decode_tokens_compared": len(outs["slow"][0]),
    }


def check_shard_kernels(device) -> dict:
    """``delta_fused``, ``delta_diff`` and ``delta_apply`` against their plain
    versions, bit for bit, at phase 11a's part grids: a KV part (32 tiles of
    64 KiB, capacity 16) and a heap part (16 tiles of 8 MiB)."""
    import torch

    from repro_torch.kernels import delta_apply, delta_diff, delta_fused, ref

    gen = torch.Generator(device=device).manual_seed(11)
    errs = {"delta_fused": 0.0, "delta_diff": 0.0, "delta_apply": 0.0}
    for N, C in ((32, 65536), (16, 8 << 20)):
        for n_dirty in (0, N // 3, N):
            dirty = torch.randperm(N, generator=gen, device=device)[:n_dirty].tolist()
            old, new = _dirty_pair(gen, N, C, dirty, device)
            if C == 65536:
                got = delta_fused(old, new, max_changed=N // 2)
                errs["delta_fused"] = max(errs["delta_fused"], max_abs_err(
                    got, ref.fused_encode_ref(old, new, N // 2)))
            else:
                errs["delta_diff"] = max(errs["delta_diff"], max_abs_err(
                    delta_diff(old, new), ref.delta_diff_ref(old, new)))
            M = 1 << max(n_dirty - 1, 0).bit_length()
            data = torch.randint(0, 256, (M, C), generator=gen, device=device, dtype=torch.uint8)
            idx = torch.full((M,), -1, dtype=torch.int32, device=device)
            idx[:n_dirty] = torch.as_tensor(dirty, dtype=torch.int32, device=device)
            want = ref.delta_apply_ref(old, data, idx)
            errs["delta_apply"] = max(errs["delta_apply"],
                                      max_abs_err(delta_apply(old.clone(), data, idx), want))
            del old, new, data
    torch.cuda.synchronize()
    return errs


def check_apply_parts(device, parts, seed: int = 12) -> float:
    """``delta_apply`` against its plain version, bit for bit, at each part
    grid of ``parts`` (``[tiles, tile bytes, dirty tiles]``: 11b's slow
    restore's, as :func:`run_sharded_serving_path` reports them), with the
    dirty rows padded to a power of two as the decode pads them."""
    import torch

    from repro_torch.kernels import delta_apply, ref

    gen = torch.Generator(device=device).manual_seed(seed)
    err = 0.0
    for N, C, n_dirty in parts:
        base = torch.randint(0, 256, (N, C), generator=gen, device=device, dtype=torch.uint8)
        M = 1 << max(n_dirty - 1, 0).bit_length()
        data = torch.randint(0, 256, (M, C), generator=gen, device=device, dtype=torch.uint8)
        idx = torch.full((M,), -1, dtype=torch.int32, device=device)
        idx[:n_dirty] = torch.randperm(N, generator=gen, device=device)[:n_dirty].to(torch.int32)
        want = ref.delta_apply_ref(base, data, idx)
        err = max(err, max_abs_err(delta_apply(base.clone(), data, idx), want))
        del base, data, want
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 9: the remaining model families
# ---------------------------------------------------------------------------
# 9a: the JAX package's src/repro/configs/qwen3_moe_30b_a3b.py, whole; 9b:
# xlstm_1_3b.py, whole; 9c: gemma3_27b.py cut to its first stage's one period
# 9a draws its embedding table at std 4, where the JAX package's init draws
# 1/sqrt(d_model): at that scale the attention layers' output, nearly the same
# for every token, swamps each token's own embedding a few layers deep, the
# hidden states align, most tokens route to the same few experts, the
# capacity rule drops most assignments and every fork decodes one token
FAMILY_EMBED_STD = 4.0
# (part, config, periods, embedding std or None for the reference's init)
FAMILY_PARTS = (("9a", "qwen3-moe-30b-a3b", None, FAMILY_EMBED_STD),
                ("9b", "xlstm-1.3b", None, None), ("9c", "gemma3-27b", 1, None))
FAMILY_STEPS = 16               # trunk steps; a delta checkpoint after 8 and after 16
FAMILY_FORKS = 4
FAMILY_FORK_STEPS = 8
FAMILY_MAX_PAGES = 136          # 2011 + 16 + 9 tokens fill 128 pages of 16
SERVE_VOCAB = 151936            # phase 6's vocabulary: its prompt is drawn over it
# 9d: (label, config, sublayer kind, prefill tokens); each then decodes 4 steps
SUBLAYER_CASES = (
    ("moe", "qwen3-moe-30b-a3b", "moe", 256),
    ("mamba", "jamba-1.5-large-398b", "mamba", 256),
    ("mlstm", "xlstm-1.3b", "mlstm", 256),
    ("slstm", "xlstm-1.3b", "slstm", 256),
    ("attn_local", "gemma3-27b", "attn_local", 1536),     # past its 1024-token window
    ("attn_mrope", "qwen2-vl-2b", "attn", 256),
)
SUBLAYER_DECODE_STEPS = 4
SUBLAYER_TOL = 2e-2             # card (bf16) against CPU (float32), relative


def family_config(name: str, periods=None):
    """``name``'s config from the port's registry, or, with ``periods``, cut
    to that many periods of its first stage (widths unchanged)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage

    cfg = get_config(name)
    if periods is None:
        return cfg
    return dataclasses.replace(cfg, name=f"{name}-{periods}p",
                               stages=(Stage(period=cfg.stages[0].period, n_periods=periods),))


@contextlib.contextmanager
def recording_moe_routes(sink: list):
    """While active, every MoE routing call appends its expert ids, capacity
    slots and keep mask (device tensors, no synchronization) and its
    capacity C to ``sink``."""
    from repro_torch.models import layers as L

    route = L._moe_route

    def recorded(params, spec, x):
        out = route(params, spec, x)
        sink.append((out[1], out[2], out[3], out[5]))
        return out

    L._moe_route = recorded
    try:
        yield
    finally:
        L._moe_route = route


def check_capacity_rule(sink: list):
    """Recompute every recorded routing call's capacity slots on the host:
    an assignment's slot counts the earlier assignments of its batch row, in
    token-major order, to the same expert, and slot C and past it drop.
    Fails where the device's slots or keep mask differ; returns the share of
    assignments dropped (None with no call recorded)."""
    import numpy as np

    if not sink:
        return None
    dropped = made = 0
    for flat_e, flat_p, keep, C in sink:
        e, p, k = flat_e.cpu().numpy(), flat_p.cpu().numpy(), keep.cpu().numpy()
        slot = np.empty_like(e)
        for b in range(e.shape[0]):
            order = np.argsort(e[b], kind="stable")
            ranked = e[b][order]
            slot[b, order] = np.arange(e.shape[1]) - np.searchsorted(ranked, ranked)
        if not (np.array_equal(k, slot < C) and np.array_equal(p, np.minimum(slot, C))):
            raise AssertionError(f"the capacity rule's slots differ from the host's (C = {C})")
        dropped += int((slot >= C).sum())
        made += e.size
    return dropped / made


def _state_snapshot(sess, keys) -> dict:
    return {(k, leaf): t.clone() for k in keys for leaf, t in sess.extras[k].items()}


def build_family_model(device, config: str, periods=None, embed_std=None, seed: int = 0):
    """``config`` (cut by ``family_config``) with seeded random weights on
    ``device``, the embedding table rescaled to ``embed_std`` when given."""
    import torch

    from repro_torch.models import Model

    model = Model(family_config(config, periods), device=device)
    model.init(torch.Generator(device=device).manual_seed(seed))
    if embed_std is not None:
        model.params["embed"].mul_(embed_std * model.cfg.d_model ** 0.5)
    return model


def run_family_path(
    device,
    *,
    config: str,
    model=None,
    periods=None,
    num_pages: int = SERVE_PAGES,
    page_size: int = SERVE_PAGE_SIZE,
    max_pages: int = FAMILY_MAX_PAGES,
    prompt_len: int = SERVE_PROMPT,
    steps: int = FAMILY_STEPS,
    forks: int = FAMILY_FORKS,
    fork_steps: int = FAMILY_FORK_STEPS,
    slow_steps: int = SERVE_SLOW_STEPS,
    embed_std=None,
    seed: int = 0,
) -> dict:
    """Phases 9a-9c (and 12b under an activation-sharding context):
    ``model``, or ``config`` built by ``build_family_model`` (seeded random
    weights, the embedding table rescaled to ``embed_std`` when it is
    given), served through ``Engine`` under
    ``StateManager(Sandbox(DeltaFS, trunk), DeltaCR)``: phase 6's prompt
    (taken modulo a smaller vocabulary) prefilled, ``steps`` greedy steps
    with a delta checkpoint halfway and at the end, ``forks`` fast restores
    of the last checkpoint decoding ``fork_steps`` batched steps from
    divergent pending tokens, and a slow restore after the template is
    evicted.  Gates: a fork copies no page and no state (its states alias
    the template's), stepping the parent leaves a fork's state bytes
    unchanged, the slow-restored states are back on the model's device and
    equal a fast fork's, and the slow restore decodes exactly the fast
    fork's tokens and logits; the forks decode pairwise different streams.
    An MoE config's routing at prefill and over the forks' steps is held
    against the host's capacity rule (``check_capacity_rule``), and one
    batched step is profiled on the card.  On a graphed engine the routing
    of a width is recorded at its first step (eager) and at its capture;
    the captured tensors hold the last replay's routing when it is checked.  Returns the metrics, with the
    trunk's greedy tokens and (not JSON) its prefill logits."""
    import numpy as np
    import torch

    from repro_torch.core import DeltaCR, DeltaFS, DumpPolicy, Sandbox, StateManager
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import Engine, PagePool, PagedSession

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.default_rng(seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = build_family_model(device, config, periods, embed_std, seed)
    cfg = model.cfg
    pool = PagePool(cfg, num_pages=num_pages, page_size=page_size,
                    max_pages_per_session=max_pages, device=device)
    eng = Engine(model, pool)
    sync()
    init_s = time.perf_counter() - t0
    is_moe = "moe" in cfg.sublayer_kinds()
    state_keys = sorted(pool.state_keys)

    def steps_(sessions, n):
        """n batched steps; per-step ms and the token streams."""
        ms, streams = [], [[] for _ in sessions]
        for _ in range(n):
            sync()
            t = time.perf_counter()
            toks = eng.step(sessions)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            for i, tok in enumerate(toks):
                streams[i].append(tok)
        return ms, streams

    launches0 = dict(launch_counts())
    steps0 = eng.decode_steps
    prompt = (rng.integers(0, SERVE_VOCAB, size=prompt_len) % cfg.vocab_size).tolist()
    # -- warm-up: one prefill of the prompt through the engine, released, so
    #    the timed prefill pays no first-use cost
    eng.new_session(prompt).release()
    # -- the trunk: prefill (its routing recorded), steps, a delta checkpoint
    #    halfway and at the end
    prefill_routes: list = []
    sync()
    t = time.perf_counter()
    with recording_moe_routes(prefill_routes):
        trunk = eng.new_session(prompt)
    sync()
    prefill_ms = (time.perf_counter() - t) * 1e3
    prefill_logits = np.array(trunk.extras["last_logits"])
    b1_ms, _ = steps_([trunk], steps // 2)
    fs = DeltaFS()
    cr = DeltaCR(
        store=fs.store, async_warm=False, policy=DumpPolicy(mode="delta"),
        restore_fn=lambda p: PagedSession.restore_from_payload(pool, p),
    )
    sm = StateManager(Sandbox(fs, trunk), cr)
    fs.write("task/prompt.txt", np.asarray(prompt, np.int32))
    sm.checkpoint()
    cr.wait_dumps()
    ms, _ = steps_([trunk], steps - steps // 2)
    b1_ms += ms
    trunk_tokens = [int(t) for t in trunk.tokens[prompt_len:]]
    state_bytes = sum(t.nbytes for k in state_keys for t in trunk.extras[k].values())
    d2h0 = cr.pipeline.d2h_bytes
    sync()
    t = time.perf_counter()
    c2 = sm.checkpoint()
    ckpt_call_ms = (time.perf_counter() - t) * 1e3
    cr.wait_dumps()
    sync()
    dump_ms = (time.perf_counter() - t) * 1e3
    d2h = cr.pipeline.d2h_bytes - d2h0
    img2 = cr.dump_future(c2).result()

    # -- forks: zero-copy, states aliased, isolated from the parent's steps
    copied0 = pool.stats.copied_pages
    mem0 = torch.cuda.memory_allocated() if on_card else None
    fast_ms, kids = [], []
    for _ in range(forks):
        sync()
        t = time.perf_counter()
        kid, path = cr.restore(c2)
        fast_ms.append((time.perf_counter() - t) * 1e3)
        if path != "fast":
            raise AssertionError(f"restore of c2 took the {path} path")
        kids.append(kid)
    fork_alloc = torch.cuda.memory_allocated() - mem0 if on_card else None
    if pool.stats.copied_pages != copied0:
        raise AssertionError("forking copied pages")
    for k in state_keys:
        for leaf in kids[0].extras[k]:
            if len({kid.extras[k][leaf].data_ptr() for kid in kids}) != 1:
                raise AssertionError(f"forks hold copies of {k}::{leaf}")
    if state_keys:
        before = _state_snapshot(kids[0], state_keys)
        steps_([trunk], 1)                          # the parent moves on
        after = _state_snapshot(kids[0], state_keys)
        if not all(torch.equal(before[key], after[key]) for key in before):
            raise AssertionError("stepping the parent changed a fork's state")
        del before, after
    actions = rng.choice(cfg.vocab_size, size=forks, replace=False).tolist()
    for kid, a in zip(kids, actions):
        kid.tokens[-1] = int(a)
    decode_routes: list = []
    with recording_moe_routes(decode_routes):
        b4_ms, streams = steps_(kids, fork_steps)
    if len({tuple(st) for st in streams}) != forks:
        raise AssertionError(f"fork streams did not diverge: {streams}")
    moe = {}
    if is_moe:
        moe = {
            "profiled_step_b4": _profile_step(eng, kids) if on_card else None,
            "drop_share_prefill": check_capacity_rule(prefill_routes),
            "drop_share_decode": check_capacity_rule(decode_routes),
        }
        del prefill_routes, decode_routes

    # -- slow restore of c2 against a fast fork taken before the eviction
    fast = cr.restore(c2)[0]
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
             for k, v in fast.dump_payload().items()}
    if not cr.evict_template(c2):
        raise AssertionError("no template to evict for c2")
    sync()
    t = time.perf_counter()
    slow, path = cr.restore(c2)
    sync()
    slow_ms = (time.perf_counter() - t) * 1e3
    if path != "slow":
        raise AssertionError(f"restore of c2 after eviction took the {path} path")
    for k in state_keys:
        for leaf, v in slow.extras[k].items():
            if not isinstance(v, torch.Tensor) or v.device.type != torch.device(device).type:
                raise AssertionError(f"slow restore left {k}::{leaf} off the model's device")
    got = slow.dump_payload()
    if sorted(got) != sorted(saved):
        raise AssertionError("slow restore: payload keys differ")
    for k, want in saved.items():
        same = (torch.equal(got[k], want) if isinstance(want, torch.Tensor)
                else np.array_equal(np.asarray(got[k]), want))
        if not same:
            raise AssertionError(f"slow restore: {k} differs from c2")
    outs = {}
    for name, sess in (("slow", slow), ("fast", fast)):
        toks, logits = [], []
        for _ in range(slow_steps):
            toks += eng.step([sess])
            logits.append(np.array(sess.extras["last_logits"]))
        outs[name] = (toks, logits)
    if outs["slow"][0] != outs["fast"][0] or not all(
        np.array_equal(a, b) for a, b in zip(outs["slow"][1], outs["fast"][1])
    ):
        raise AssertionError("slow-restored and fast-forked sessions decode differently")
    launches = {k: n - launches0.get(k, 0) for k, n in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() if on_card else None
    out = {
        "config": cfg.name,
        "layers": cfg.n_layers,
        "global_attn_layers": sum(layer.count("attn") * st.n_periods
                                  for st in cfg.stages for layer in st.period),
        "params": model.param_count(),
        "launches": launches,
        "decode_steps": eng.decode_steps - steps0,
        "fork_streams": streams,
        "init_s": init_s,
        "prefill_ms": prefill_ms,
        "prefill_tokens": prompt_len,
        "decode_ms_b1_median": statistics.median(b1_ms),
        "decode_ms_b4_median": statistics.median(b4_ms),
        "tokens_per_s_b4": forks * 1e3 / statistics.median(b4_ms),
        "checkpoint_call_ms": ckpt_call_ms,
        "dump_complete_ms": dump_ms,
        "c2_image_mode": img2.mode,
        "d2h_bytes_kernel_path_c2": d2h,
        "state_bytes_per_session": state_bytes,
        "d2h_bytes_c2": d2h + state_bytes,
        "fast_restore_ms_median": statistics.median(fast_ms),
        "fork_device_bytes_allocated": fork_alloc,
        "slow_restore_ms": slow_ms,
        "max_memory_allocated": peak,
        "trunk_tokens": trunk_tokens,
        "prefill_logits": prefill_logits,
        **moe,
    }
    for sess in kids + [fast, slow, sm.sandbox.proc]:
        sess.release()
    cr.shutdown()
    return out


def check_sublayer(device, config: str, kind: str, prompt_len: int, *,
                   steps: int = SUBLAYER_DECODE_STEPS, seed: int = 0) -> dict:
    """Phase 9d: one ``kind`` sublayer of ``config`` at full width, with
    seeded weights in the config's dtype (bf16), through a ``prompt_len``
    prefill and ``steps`` decode steps over its own cache (K/V, a ring
    buffer, or a recurrent state), on ``device`` in the config's dtype and
    on the CPU in float32 on the same weights and inputs (upcast).  Returns
    the largest error over every output and the final cache, relative to
    the CPU's largest magnitude in that tensor.

    The MoE is fed its body's input directly, without the pre-norm: both
    sides then route on the same values (the router is float32), where a
    bf16-rounded norm would move the near-boundary top-k choices and
    compare two different routings.  ``routing_mismatches`` counts the
    (token, choice) expert ids that still differ."""
    import torch

    from repro_torch.models import model as M

    cfg = family_config(config)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M._init_sublayer(kind, gen, cfg, device)
    x = torch.randn((1, prompt_len + steps, cfg.d_model), generator=gen,
                    device=device).to(getattr(torch, cfg.dtype))

    def to_cpu32(tree):
        if isinstance(tree, dict):
            return {k: to_cpu32(v) for k, v in tree.items()}
        return tree.float().cpu()

    routes = {}

    def run(p, c, xx, dev, side):
        if kind == "moe":
            spec = M._moe_spec(c)
            routes[side] = [M.L._moe_route(p["body"], spec, xx[:, :prompt_len])[1]] + [
                M.L._moe_route(p["body"], spec, xx[:, t:t + 1])[1]
                for t in range(prompt_len, prompt_len + steps)]
            return [M.L.moe_apply(p["body"], spec, xx[:, :prompt_len])[0]] + [
                M.L.moe_apply(p["body"], spec, xx[:, t:t + 1])[0]
                for t in range(prompt_len, prompt_len + steps)]
        cache = M.init_cache_entry(kind, c, 1, prompt_len + steps, dev)
        pos = torch.arange(prompt_len, dtype=torch.int32, device=dev)[None]
        delta, state, _ = M._apply_sublayer(kind, p, c, xx[:, :prompt_len], pos, "prefill",
                                            cache, None)
        outs = [delta]
        cache = state if state is not None else cache
        for t in range(steps):
            lens = torch.tensor([prompt_len + t], dtype=torch.int32, device=dev)
            delta, state, _ = M._apply_sublayer(kind, p, c, xx[:, prompt_len + t:][:, :1],
                                                lens[:, None], "decode", cache, lens)
            outs.append(delta)
            cache = state if state is not None else cache
        return outs + list((cache or {}).values())

    t = time.perf_counter()
    got = [g.float().cpu() for g in run(params, cfg, x, device, "card")]
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want = run(to_cpu32(params), cfg32, x.float().cpu(), "cpu", "cpu")
    cpu_s = time.perf_counter() - t
    errs = []
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{config} {kind}: non-finite output on {device}")
        errs.append(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    mismatches = None
    if kind == "moe":
        mismatches = sum(int((a.cpu() != b).sum()) for a, b in zip(routes["card"], routes["cpu"]))
    return {"config": config, "kind": kind, "prefill_tokens": prompt_len, "decode_steps": steps,
            "max_rel_err": max(errs), "rel_errs": errs, "tensors_compared": len(got),
            "routing_mismatches": mismatches, "card_s": card_s, "cpu_s": cpu_s}


def run_sublayer_checks(device) -> list:
    """Phase 9d: every case of ``SUBLAYER_CASES`` within ``SUBLAYER_TOL``."""
    import torch

    rows = []
    for label, config, kind, prompt_len in SUBLAYER_CASES:
        row = check_sublayer(device, config, kind, prompt_len)
        row["case"] = label
        if not row["max_rel_err"] <= SUBLAYER_TOL:
            raise AssertionError(f"9d {label}: card against CPU {row['max_rel_err']} "
                                 f"> {SUBLAYER_TOL}")
        rows.append(row)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 12: sharded compute on the card, on 9a's qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------
# 12a: ("data", "model") layouts and sequence parallelism of one MoE layer
EP_LAYOUTS = (((1, 4), False), ((2, 4), False), ((2, 4), True), ((4, 2), True),
              ((1, 8), True))
EP_INPUT = (4, 256)             # (B, S) of 12a's bf16 layer input
EP_TOL = 2e-2                   # of the largest magnitude: EP against moe_apply per shard
EP_AUX_TOL = 1e-5
EP_SERVE_MESH = (1, 4)          # 12b: 32 experts on each "model" rank
EP_MEMORY_SLACK = 2 << 30       # 12b: peak at most the unsharded run's plus 2 GiB
LAUNCHER_ARGV = ("--arch", "olmo-1b", "--tokens", "16", "--sessions", "2")   # 12c


def _moe_layer(model):
    """(spec, weights) of the first MoE sublayer of ``model``'s first
    period: views of the stacked weights, no copy."""
    from repro_torch.models.model import _moe_spec

    for li, layer in enumerate(model.cfg.stages[0].period):
        for si, kind in enumerate(layer):
            if kind == "moe":
                body = model.params["stage0"][f"l{li}_s{si}_moe"]["body"]
                return _moe_spec(model.cfg), {k: v[0] for k, v in body.items()}
    raise ValueError(f"{model.cfg.name} has no MoE sublayer")


def _a2a_bytes(spec, ep: int, C: int, itemsize: int) -> int:
    """Bytes one rank receives over both all_to_alls of one MoE layer:
    (ep - 1)/ep of its (E, C, D) buffer each way."""
    return 2 * (ep - 1) * (spec.n_experts // ep) * C * spec.d_model * itemsize


def run_ep_layer(device, model, *, layouts=EP_LAYOUTS, shape=EP_INPUT, seed: int = 0) -> list:
    """12a: one MoE layer of ``model`` (period 0's weights) on a seeded
    input of ``shape`` tokens, expert-parallel over each layout's logical
    mesh (``dp=("data",)``), against its plain version: ``moe_apply`` run
    on each shard's tokens as one group.  Gates: every rank's capacity
    slots and drops equal its shard's, the output within ``EP_TOL`` of the
    plain output's largest magnitude, ``aux`` within ``EP_AUX_TOL`` of the
    mean of the ranks' shard aux, and each rank's collective bytes equal to
    the formula (``_a2a_bytes``, and for the FSDP gather ``n_data - 1``
    times its three expert-weight blocks and its router block).  Returns a
    row per layout."""
    import torch

    from repro_torch.dist import collectives as col
    from repro_torch.dist.placement import NamedSharding, PartitionSpec as P
    from repro_torch.dist.sharding import activation_sharding
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models import layers as L

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spec, params = _moe_layer(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*shape, spec.d_model, generator=gen, device=device).to(model.dtype)

    def timed(fn):
        fn()                                     # warm
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    _, unsharded_ms = timed(lambda: L.moe_apply(params, spec, x))
    rows = []
    for mesh_shape, sp in layouts:
        mesh = make_logical_mesh(mesh_shape, device=device)
        ep, n_data = mesh.shape["model"], mesh.shape["data"]
        routes: list = []
        with activation_sharding(dp=("data",), mesh=mesh, seq_parallel=sp):
            _, ep_ms = timed(lambda: L.moe_apply(params, spec, x))
            col.reset_ledger()
            with recording_moe_routes(routes):
                out, aux = L.moe_apply(params, spec, x)
        led = col.ledger()["received"]
        if len(routes) != mesh.size:
            raise AssertionError(f"{mesh_shape}: {len(routes)} routing calls for "
                                 f"{mesh.size} ranks")
        imap = NamedSharding(mesh, P("data", "model" if sp else None, None)) \
            .addressable_devices_indices_map(x.shape)
        want = torch.empty_like(out)
        shards: dict = {}
        shard_aux, dropped = [], 0
        for rank, index in imap.items():
            key = tuple((s.start, s.stop) for s in index)
            if key not in shards:
                xl = x[index]
                Bl, Sl, D = xl.shape
                sink: list = []
                with recording_moe_routes(sink):
                    y, a = L.moe_apply(params, spec, xl.reshape(1, Bl * Sl, D))
                want[index] = y.reshape(Bl, Sl, D)
                shards[key] = (sink[0], float(a))
            (le, lp, lk, lC), a = shards[key]
            ge, gp, gk, gC = routes[rank]
            if gC != lC or not (torch.equal(ge, le) and torch.equal(gp, lp) and torch.equal(gk, lk)):
                raise AssertionError(f"{mesh_shape} sp={sp}: rank {rank}'s slots or drops "
                                     "differ from its shard's")
            shard_aux.append(a)
            dropped += int((~gk).sum())
            gather = (n_data - 1) * (
                sum(params[k].nbytes // (ep * n_data) for k in ("w_gate", "w_up", "w_down"))
                + params["router"].nbytes // n_data)
            got = (led.get("all_to_all", {}).get(rank, 0), led.get("all_gather", {}).get(rank, 0))
            if got != (_a2a_bytes(spec, ep, gC, x.element_size()), gather):
                raise AssertionError(f"{mesh_shape} sp={sp}: rank {rank} received {got} B, "
                                     f"expected {(_a2a_bytes(spec, ep, gC, x.element_size()), gather)}")
        err = float((out.float() - want.float()).abs().max() / want.float().abs().max())
        if not err <= EP_TOL:
            raise AssertionError(f"{mesh_shape} sp={sp}: {err} of the largest magnitude")
        aux_err = abs(float(aux) - statistics.fmean(shard_aux))
        if not aux_err <= EP_AUX_TOL:
            raise AssertionError(f"{mesh_shape} sp={sp}: aux off by {aux_err}")
        rows.append({
            "mesh": list(mesh_shape), "seq_parallel": sp, "capacity": routes[0][3],
            "drop_share": dropped / sum(r[2].numel() for r in routes),
            "max_rel_err": err, "aux": float(aux), "aux_err": aux_err,
            "a2a_bytes_per_rank": led.get("all_to_all", {}).get(0, 0),
            "gather_bytes_per_rank": led.get("all_gather", {}).get(0, 0),
            "ep_ms": ep_ms, "unsharded_ms": unsharded_ms,
        })
        del out, want, routes, shards
    return rows


def run_ep_serving_path(device, model, unsharded: dict, *, mesh_shape=EP_SERVE_MESH,
                        **kw) -> dict:
    """12b: 9a's serving run again (``run_family_path`` on the same model,
    with ``kw``), every call under ``activation_sharding`` over a logical
    mesh of ``mesh_shape`` (experts over "model", KV heads over "model"
    through the attention constraints, ``attn_shard`` "kv"), against
    ``unsharded`` (9a's result).  Gates, beyond 9a's own: every rank's
    all_to_all bytes equal the formula over the run's MoE calls (two
    prefills of the prompt and the decode steps, each at its capacity), the
    prefill logits within ``EP_TOL`` of the unsharded run's largest
    magnitude, and (on the card) the peak at most the unsharded run's plus
    ``EP_MEMORY_SLACK``.  Returns the metrics."""
    import numpy as np
    import torch

    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import activation_sharding
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models.model import _moe_spec

    cfg = model.cfg
    spec = _moe_spec(cfg)
    mesh = make_logical_mesh(mesh_shape, device=device)
    ep = mesh.shape["model"]
    col.reset_ledger()
    with activation_sharding(dp=("data",), model="model", attn_shard=cfg.attn_shard, mesh=mesh):
        out = run_family_path(device, config=cfg.name, model=model, **kw)
    led = col.ledger()
    moe_layers = sum(layer.count("moe") * st.n_periods for st in cfg.stages for layer in st.period)
    forks = kw.get("forks", FAMILY_FORKS)
    if spec.capacity(1) != spec.capacity(forks):
        raise AssertionError("decode steps of 1 and of the forks differ in capacity")
    itemsize = model.dtype.itemsize             # the dispatched slots hold activations
    prompt_len = kw.get("prompt_len", SERVE_PROMPT)
    want = moe_layers * (2 * _a2a_bytes(spec, ep, spec.capacity(prompt_len), itemsize)
                         + out["decode_steps"] * _a2a_bytes(spec, ep, spec.capacity(1), itemsize))
    got = led["received"].get("all_to_all", {})
    if any(got.get(r, 0) != want for r in range(mesh.size)):
        raise AssertionError(f"all_to_all bytes by rank {got}, expected {want} each")
    a, b = out.pop("prefill_logits"), unsharded["prefill_logits"]
    logits_err = float(np.abs(a - b).max() / np.abs(b).max())
    if not logits_err <= EP_TOL:
        raise AssertionError(f"prefill logits {logits_err} of the unsharded run's largest")
    peak, base = out["max_memory_allocated"], unsharded["max_memory_allocated"]
    if peak is not None and peak > base + EP_MEMORY_SLACK:
        raise AssertionError(f"peak {peak} B over the unsharded run's {base} B + 2 GiB")
    streams = [(x, y) for sa, sb in zip(out["fork_streams"], unsharded["fork_streams"])
               for x, y in zip(sa, sb)]
    return {
        **out,
        "mesh": list(mesh_shape),
        "prefill_logits_rel_err": logits_err,
        "trunk_tokens_equal": sum(x == y for x, y in zip(out["trunk_tokens"],
                                                          unsharded["trunk_tokens"])),
        "fork_tokens_equal": sum(x == y for x, y in streams),
        "tokens_compared": len(out["trunk_tokens"]) + len(streams),
        "a2a_bytes_per_rank": want,
        "a2a_bytes_per_decode_step": moe_layers * _a2a_bytes(spec, ep, spec.capacity(1), itemsize),
        "a2a_bytes_per_prefill": moe_layers * _a2a_bytes(spec, ep, spec.capacity(prompt_len),
                                                         itemsize),
        "collective_calls": led["calls"],
        "unsharded_decode_ms_b1_median": unsharded["decode_ms_b1_median"],
        "unsharded_decode_ms_b4_median": unsharded["decode_ms_b4_median"],
        "unsharded_prefill_ms": unsharded["prefill_ms"],
        "unsharded_max_memory_allocated": base,
    }


def run_serve_launcher(argv=LAUNCHER_ARGV) -> dict:
    """12c: ``repro_torch.launch.serve.main(argv)`` in this process; it
    must return 0 and print one line per session holding the prompt and
    ``--tokens`` generated tokens."""
    import io

    from repro_torch.launch import serve

    args = dict(zip(argv[::2], argv[1::2]))
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(list(argv))
    seconds = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"the launcher returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    n, tokens = int(args.get("--sessions", 2)), int(args.get("--tokens", 16))
    if [ln.split(":")[0] for ln in lines] != [f"session {i}" for i in range(n)]:
        raise AssertionError(f"printed {lines}")
    streams = [json.loads(ln.split(": ", 1)[1]) for ln in lines]
    if any(len(st) != 4 + tokens for st in streams):      # the launcher's 4-token prompt
        raise AssertionError(f"sessions of {[len(st) for st in streams]} tokens")
    return {"argv": list(argv), "rc": rc, "sessions": streams, "steps": tokens - 1,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 10: training at full olmo-1b width, with a crash and a restore
# ---------------------------------------------------------------------------
TRAIN_CONFIG = "olmo-1b"        # the JAX launcher's default training arch
TRAIN_SEQ = 4096                # train_4k's sequence length
TRAIN_BATCH = 8                 # train_4k's global batch 256, cut to 8
TRAIN_STEPS = 5                 # the launcher's 100 steps, cut to 5
TRAIN_CKPT_EVERY = 3
TRAIN_KEEP_CKPTS = 2
TRAIN_MICROBATCHES = 2
TRAIN_FAIL_AT = 4               # the trainer.step seam raises before step 4
TRAIN_PEAK_LR = 3e-4
TRAIN_WARMUP = 2
# Step 4 after the restore against the pre-crash params after step 3: equal
# unless the re-run's backward pass summed a gradient in another order
# (atomics), which moves a bf16 weight by at most an ulp where its AdamW
# step rounds near a half.
TRAIN_STEP4_RTOL = 1e-3
# bf16 dense peak of the card, by the name torch.cuda.get_device_name gives
# (NVIDIA's data sheet, SXM part, no sparsity, at a 700 W power limit)
BF16_DENSE_PEAK = {"NVIDIA H100 80GB HBM3": 989e12}


def _host_available_bytes():
    """MemAvailable of /proc/meminfo, in bytes (None where there is none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _bits(t):
    """An integer view of ``t``'s bytes, for a bit-for-bit comparison."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.dtype.is_floating_point else t


def run_train_path(device, *, config: str = TRAIN_CONFIG, seq_len: int = TRAIN_SEQ,
                   global_batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
                   ckpt_every: int = TRAIN_CKPT_EVERY, microbatches: int = TRAIN_MICROBATCHES,
                   fail_at: int = TRAIN_FAIL_AT, seed: int = 0) -> dict:
    """Phase 10: ``repro_torch.launch.train``'s path, ``Trainer.run``, on
    ``device`` at ``config``'s full width: ``loss_fn`` forward and backward,
    AdamW, a coupled DeltaFS checkpoint after step ``ckpt_every``, the
    ``trainer.step`` seam raising before step ``fail_at``, ``restore_latest``
    and the run resumed to ``steps``.

    Gates (AssertionError): every restored params and optimizer leaf equals,
    bit for bit, a device clone of the checkpointed snapshot kept here, and
    the stream state equals the checkpoint's; the re-run step ``ckpt_every``
    gives the pre-crash loss exactly (a forward pass over restored bytes and
    restored data); step ``fail_at`` after the restore within
    ``TRAIN_STEP4_RTOL`` of the loss of the pre-crash params after step
    ``fail_at - 1`` on the same batch; every loss finite, the first within
    [ln V - 1, ln V + 2]."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import faults
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, PackedStream, Trainer, TrainerConfig
    from repro_torch.train.optim import tree_map, tree_paths

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)          # initializes the card in a fresh process
        torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(config)
    model = Model(cfg, device=device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    trainer = Trainer(
        model,
        OptimizerConfig(peak_lr=TRAIN_PEAK_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps),
        data_cfg,
        TrainerConfig(steps=steps, ckpt_every=ckpt_every, keep_ckpts=TRAIN_KEEP_CKPTS,
                      microbatches=microbatches, log_every=1),
    )
    host_before = _host_available_bytes()
    params, opt, err = trainer.init_state(seed)
    n_params = model.param_count()

    # The phase's own witnesses: a device clone of the first checkpoint's
    # snapshot and stream state, the synchronized time of each checkpoint
    # call, and the params the last step returned.
    kept, last, snapshot_ms = {}, {}, []
    checkpoint, train_step = trainer.checkpoint, trainer.train_step

    def keep_checkpoint(step, p, o):
        sync()
        t0 = time.perf_counter()
        checkpoint(step, p, o)
        sync()
        snapshot_ms.append((time.perf_counter() - t0) * 1e3)
        if not kept:
            with torch.no_grad():
                kept.update(step=step, params=tree_map(torch.clone, p),
                            opt=tree_map(torch.clone, o), stream=trainer.stream.state())

    def keep_step(p, o, e, batch):
        out = train_step(p, o, e, batch)
        last["params"] = out[0]
        return out

    trainer.checkpoint, trainer.train_step = keep_checkpoint, keep_step
    try:
        trainer.run(params, opt, err, fail_at=fail_at)
    except faults.FaultError:
        pass
    else:
        raise AssertionError(f"the trainer.step seam did not raise before step {fail_at}")
    del params, opt, err
    pre = {m["step"]: m for m in trainer.metrics_log}
    if sorted(pre) != list(range(1, fail_at + 1)):
        raise AssertionError(f"the crashed run logged steps {sorted(pre)}")

    t0 = time.perf_counter()
    trainer.wait_checkpoints()          # the step-3 write, still running at the crash
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, opt, err, step = trainer.restore_latest()
    sync()
    restore_s = time.perf_counter() - t0
    if step != ckpt_every or kept.get("step") != ckpt_every:
        raise AssertionError(f"restore_latest gave step {step}, the checkpoint was {kept.get('step')}")
    compared = 0
    for name, got_tree, want_tree in (("params", params, kept["params"]), ("opt", opt, kept["opt"])):
        got, want = dict(tree_paths(got_tree)), dict(tree_paths(want_tree))
        if sorted(got) != sorted(want):
            raise AssertionError(f"restored {name} leaves differ from the snapshot's")
        for path, w in want.items():
            g = got[path]
            if (g.shape != w.shape or g.dtype != w.dtype or g.device != w.device
                    or not torch.equal(_bits(g), _bits(w))):
                raise AssertionError(f"restored {name}/{path} differs from the snapshot")
            compared += 1
    state = trainer.stream.state()
    for k, v in kept["stream"].items():
        if state[k].dtype != v.dtype or state[k].tobytes() != v.tobytes():
            raise AssertionError(f"restored stream {k} differs from the step-{step} state")
    kept_stream = kept.pop("stream")
    kept.clear()

    # the pre-crash params after step fail_at - 1, on step fail_at's batch
    stream = PackedStream(data_cfg)
    stream.restore(kept_stream)
    for _ in range(fail_at - ckpt_every):
        stream.next_batch()
    batch = {k: torch.from_numpy(v).to(device) for k, v in stream.next_batch().items()}
    with torch.no_grad():
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            lsum = lsum + model.loss_fn(last["params"], mb)[0]
        ref_loss = float(lsum / microbatches)
    del batch, mb, lsum
    last.clear()

    trainer.metrics_log = []
    params, opt, err, end = trainer.run(params, opt, err, start_step=step)
    post = {m["step"]: m for m in trainer.metrics_log}
    host_after = _host_available_bytes()
    if end != steps or sorted(post) != list(range(step + 1, steps + 1)):
        raise AssertionError(f"the resumed run logged steps {sorted(post)}, ended at {end}")
    if post[step + 1]["loss"] != pre[step + 1]["loss"]:
        raise AssertionError(f"step {step} re-run gave loss {post[step + 1]['loss']!r}, "
                             f"before the crash {pre[step + 1]['loss']!r}")
    loss4 = post[fail_at + 1]["loss"]
    if not abs(loss4 - ref_loss) <= TRAIN_STEP4_RTOL * abs(ref_loss):
        raise AssertionError(f"step {fail_at} after the restore gave {loss4!r}, the pre-crash "
                             f"params {ref_loss!r}")
    losses = [pre[k]["loss"] for k in sorted(pre)] + [post[k]["loss"] for k in sorted(post)]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    ln_v = math.log(cfg.vocab_size)
    if not ln_v - 1 <= losses[0] <= ln_v + 2:
        raise AssertionError(f"first loss {losses[0]} outside [ln V - 1, ln V + 2] = "
                             f"[{ln_v - 1:.3f}, {ln_v + 2:.3f}]")

    if trainer.graphs:
        # one program, captured at the first step and replayed by every
        # other, the resumed ones over the restored trees copied in
        (prog,) = trainer._steps.values()
        ran = fail_at + steps - ckpt_every
        if prog.graph is None or prog.replays != ran - 1:
            raise AssertionError(f"the step program replayed {prog.replays} times over "
                                 f"{ran} steps")
    dts = [pre[k]["dt"] for k in sorted(pre)] + [post[k]["dt"] for k in sorted(post)]
    step_s = statistics.median(dts[1:])
    tokens = global_batch * seq_len
    name = torch.cuda.get_device_name(device) if cuda else None
    peak = BF16_DENSE_PEAK.get(name)
    ckpt = trainer.ckpt_log[0]
    shape = cfg.shape("train_4k") if any(s.name == "train_4k" for s in cfg.shapes) else None
    out = {
        "config": cfg.name,
        "params": n_params,
        "params_leaves": sum(1 for _ in tree_paths(params)),
        "seq_len": seq_len,
        "global_batch": global_batch,
        "microbatches": microbatches,
        "steps": steps,
        "reduced": ({"global_batch": [shape.global_batch, global_batch],
                     "steps": [100, steps], "seq_len": [shape.seq_len, seq_len]}
                    if shape is not None else None),
        "losses_before_crash": [pre[k]["loss"] for k in sorted(pre)],
        "losses_after_restore": [post[k]["loss"] for k in sorted(post)],
        "step_after_restore_ref_loss": ref_loss,
        "step_after_restore_abs_diff": abs(loss4 - ref_loss),
        "step_ms": [dt * 1e3 for dt in dts],
        "step_ms_median": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "model_flops_per_step": 6 * n_params * tokens,
        "mfu": (6 * n_params * tokens / step_s / peak) if peak else None,
        "bf16_dense_peak_flops": peak,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "alloc_retries": (torch.cuda.memory_stats(device).get("num_alloc_retries")
                          if cuda else None),
        "snapshot_ms_synced": snapshot_ms[0],
        "snapshot_ms_host": ckpt["snapshot_ms"],
        "ckpt_write_s": ckpt["write_s"],
        "ckpt_write_bytes": ckpt["bytes"],
        "ckpt_wait_after_crash_s": wait_s,
        "restore_s": restore_s,
        "restored_leaves_bit_exact": compared,
        "graphs": trainer.graphs,
        "capture_ms": prog.capture_ms if trainer.graphs else None,
        "graph_pool_bytes": graph_pool_bytes(trainer._graph_pool) if cuda else None,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(device) if cuda else None,
        "host_available_before": host_before,
        "host_available_after": host_after,
        "phase_s": time.perf_counter() - t_phase,
    }
    del params, opt, err, trainer, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _write_stages(leaf, chunk_bytes: int) -> dict:
    """The host stages of one leaf's checkpoint write, each timed alone in
    MB/s: the device->host copy (``.to("cpu")``, as the writer thread does),
    the blake2b digest of every chunk, and the copy of every chunk into the
    bytes object the chunk store keeps."""
    from repro_torch.core.chunk_store import chunk_digest, iter_chunk_views
    from repro_torch.core.deltafs import host_bytes

    t = time.perf_counter()
    host = leaf.to("cpu")
    d2h = time.perf_counter() - t
    raw = host_bytes(host)
    t = time.perf_counter()
    for piece, pad in iter_chunk_views(raw, chunk_bytes):
        chunk_digest(piece, pad)
    digest = time.perf_counter() - t
    t = time.perf_counter()
    kept = [bytes(piece) for piece, _ in iter_chunk_views(raw, chunk_bytes)]
    copy = time.perf_counter() - t
    mb = raw.nbytes / 1e6
    del kept
    return {"bytes": raw.nbytes, "d2h_mb_s": mb / d2h, "digest_mb_s": mb / digest,
            "chunk_copy_mb_s": mb / copy}


def profile_train_step(device, *, graphs=None, write: bool = True, config: str = TRAIN_CONFIG,
                       seq_len: int = TRAIN_SEQ, global_batch: int = TRAIN_BATCH,
                       microbatches: int = TRAIN_MICROBATCHES, top: int = 10,
                       seed: int = 0) -> dict:
    """Phase 10b: where phase 10's step goes.  A fresh
    ``Trainer(graphs=graphs)`` at phase 10's shape takes one step to warm up
    (graphed: the capture), then one step under ``torch.profiler`` (device
    activity only; graphed: a replay): host wall time, the device's busy
    time (sum of its kernels, copies and memsets on the one stream), the
    idle share, the kernels apart from the copies and memsets (a graph runs
    its memcpy and memset nodes as kernels named ``memcpy*`` and
    ``memset*``, counted as copies too), each by name, the time of the
    matrix products (kernels named like cuBLAS's) and the kernels that take
    most of it.  With ``write``, then
    one coupled checkpoint of the state, its background write timed alone,
    with the training thread idle (in phase 10 it overlaps a step), and the
    host stages of that write for the largest moment leaf
    (``_write_stages``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig
    from repro_torch.train.optim import tree_leaves

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = get_config(config)
    trainer = Trainer(
        Model(cfg, device=device),
        OptimizerConfig(peak_lr=TRAIN_PEAK_LR, warmup_steps=TRAIN_WARMUP, total_steps=2),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch),
        TrainerConfig(steps=2, ckpt_every=0, microbatches=microbatches, log_every=1),
        graphs=graphs,
    )
    params, opt, err = trainer.init_state(seed)
    params, opt, err, _ = trainer.run(params, opt, err, steps=1)
    out = {"config": cfg.name, "graphs": trainer.graphs, "tokens": global_batch * seq_len}
    if cuda:
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            params, opt, err, _ = trainer.run(params, opt, err, start_step=1, steps=2)
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t) * 1e3
        if trainer.graphs and next(iter(trainer._steps.values())).replays != 1:
            raise AssertionError("the profiled step did not replay the captured graph")
        rows = _device_rows(prof)
        busy = sum(r[1] for r in rows)
        # copies and memsets: the profiler's rows, and inside a graph the
        # kernels that carry its memcpy and memset nodes
        copy = ("Memcpy", "Memset", "memcpy", "memset")
        kernels = [r for r in rows if not r[0].startswith(copy)]
        gemm = sum(r[1] for r in kernels
                   if any(k in r[0].lower() for k in ("gemm", "nvjet", "cutlass", "xmma")))
        out.update({
            "step_wall_ms": wall,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "device_events": sum(r[2] for r in rows),
            "kernels": sum(r[2] for r in kernels),
            "kernel_counts": {r[0]: r[2] for r in kernels},
            "copy_counts": {r[0]: r[2] for r in rows if r[0].startswith(copy)},
            "matmul_ms": gemm,
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:top]],
        })
    if write:
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        trainer.checkpoint(2, params, opt)
        trainer.wait_checkpoints()
        out["write_alone_s"] = time.perf_counter() - t
        out["write_alone_bytes"] = trainer.ckpt_log[-1]["bytes"]
        out["write_stages"] = _write_stages(max(tree_leaves(opt["m"]), key=lambda l: l.numel()),
                                            trainer.fs.store.chunk_bytes)
    trainer.close()
    del params, opt, err, trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


TRAIN_PROFILE_CHILD_TIMEOUT_S = 600


def profile_eager_train_step() -> dict:
    """``profile_train_step`` of the eager step on the card, without the
    write, in a fresh process whose first profile it is, with that
    process's launches of the port's kernels (``launches``).  In a process
    that has profiled before, the tracer drops some of an eager step's
    ~126,000 device events (1 to 20 seen on an H100, at the window's start
    and inside it), which a kernel count cannot have; a process's first
    profile dropped none, and neither did any profile of a graph's
    replay."""
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]; "
            "import chip_smoke, torch; from repro_torch.kernels import launch_counts; "
            "out = chip_smoke.profile_train_step(torch.device('cuda', 0), "
            "graphs=False, write=False); "
            "out['launches'] = launch_counts(); print(json.dumps(out))")
    try:
        child = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), text=True,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               timeout=TRAIN_PROFILE_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(f"the profiling process was killed after {exc.timeout} s") from exc
    if child.returncode != 0:
        raise AssertionError(f"the profiling process exited {child.returncode}:\n"
                             f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def kernel_count_diff(graphed: dict, eager: dict, key: str = "kernel_counts") -> dict:
    """{name: [graphed count, eager count]} where the two profiles of phase
    10b differ in ``key`` (``kernel_counts`` or ``copy_counts``)."""
    a, b = graphed[key], eager[key]
    return {k: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


# ---------------------------------------------------------------------------
# phase 15: the Trainer's step program as a CUDA graph, against the eager step
# ---------------------------------------------------------------------------
TRAIN_GRAPH_STEPS = 4
TRAIN_GRAPH_METRIC_RTOL = 1e-5    # loss, lr, grad_norm of a step against eager (equality expected)
TRAIN_GRAPH_LEAF_TOL = 1e-3       # a leaf after the last step, of the eager leaf's largest |value|
TRAIN_GRAPH_RUNS = (False, True)  # Trainer(graphs=...) of each run: eager, then graphed


def _train_graph_run(device, cfg, data_cfg, params, opt, err, *, graphs: bool, steps: int,
                     microbatches: int) -> tuple:
    """One run of phase 15: ``Trainer(graphs=graphs).run`` for ``steps``
    steps from the given trees (``donate=False``: never written).  Returns
    the final params and optimizer state and the run's record: each step's
    metrics and host ms, peak memory, and graphed, the capture ms, replays,
    graph-pool bytes and the reserved bytes before and after ``close()``."""
    import torch

    from repro_torch.models import Model
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cuda = torch.device(device).type == "cuda"
    trainer = Trainer(
        Model(cfg, device=device),
        OptimizerConfig(peak_lr=TRAIN_PEAK_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps),
        data_cfg,
        TrainerConfig(steps=steps, ckpt_every=0, microbatches=microbatches, log_every=1),
        graphs=graphs,
    )
    rec = {"graphs": trainer.graphs, "metrics": []}
    train_step = trainer.train_step

    def keep(p, o, e, batch):
        out = train_step(p, o, e, batch)
        rec["metrics"].append({k: float(v) for k, v in out[3].items()})
        return out

    trainer.train_step = keep
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        retries0 = torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
    params, opt, _, _ = trainer.run(params, opt, err)
    rec["step_ms"] = [m["dt"] * 1e3 for m in trainer.metrics_log]
    if trainer.graphs:
        (prog,) = trainer._steps.values()
        if prog.graph is None or prog.replays != steps - 1:
            raise AssertionError(f"the graphed run replayed {prog.replays} of {steps - 1} steps")
        rec.update(capture_ms=prog.capture_ms, replays=prog.replays)
        del prog
    if cuda:
        stats = torch.cuda.memory_stats(device)
        rec.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(device),
                   alloc_retries=stats.get("num_alloc_retries", 0) - retries0,
                   graph_pool_bytes=graph_pool_bytes(trainer._graph_pool),
                   reserved_before_close=torch.cuda.memory_reserved(device))
    trainer.close()
    del trainer, train_step, keep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        rec["reserved_after_close"] = torch.cuda.memory_reserved(device)
    return params, opt, rec


def run_train_graph_path(device, *, config: str = TRAIN_CONFIG, seq_len: int = TRAIN_SEQ,
                         global_batch: int = TRAIN_BATCH, microbatches: int = TRAIN_MICROBATCHES,
                         steps: int = TRAIN_GRAPH_STEPS, runs=TRAIN_GRAPH_RUNS,
                         seed: int = 0) -> dict:
    """Phase 15: phase 10's model and shape at full width, one seeded state
    (``Trainer.init_state``) trained for ``steps`` steps by each run of
    ``_train_graph_run``, with ``graphs`` as ``runs`` lists them (a CPU
    rehearsal runs eager only).  Every run takes that state itself:
    without ``donate`` no step writes it, and a step that did would change
    the next run's losses.  Gates, against the first eager run: every
    step's loss, lr and grad_norm within ``TRAIN_GRAPH_METRIC_RTOL``
    relative, and after the last step every params and moment leaf within
    ``TRAIN_GRAPH_LEAF_TOL`` of the eager leaf's largest magnitude, the
    step counters equal; a graphed run replays every step after its first.
    Returns the largest differences, each run's step ms (the first apart),
    capture ms, graph-pool bytes, peak memory and allocation retries."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig
    from repro_torch.train.optim import tree_paths

    cfg = get_config(config)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    seeded = Trainer(Model(cfg, device=device), OptimizerConfig(), data_cfg,
                     TrainerConfig(microbatches=microbatches), graphs=False)
    params, opt, err = seeded.init_state(seed)
    del seeded
    ends, recs = [], []
    for graphs in runs:
        p, o, rec = _train_graph_run(device, cfg, data_cfg, params, opt, err, graphs=graphs,
                                     steps=steps, microbatches=microbatches)
        recs.append(rec)
        ends.append((dict(tree_paths(p)), dict(tree_paths(o))))
        del p, o
    del params, opt, err
    ref = runs.index(False)
    metric_diff, leaf_diff, leaf_at = 0.0, 0.0, None
    for g, rec, (p, o) in zip(runs, recs, ends):
        for i, (got, want) in enumerate(zip(rec["metrics"], recs[ref]["metrics"])):
            for k, w in want.items():
                rel = abs(got[k] - w) / max(abs(w), 1e-30)
                metric_diff = max(metric_diff, rel)
                if not rel <= TRAIN_GRAPH_METRIC_RTOL:
                    raise AssertionError(f"graphs={g}: step {i + 1}'s {k} {got[k]!r} against "
                                         f"the eager run's {w!r}")
        for name, got, want in (("params", p, ends[ref][0]), ("opt", o, ends[ref][1])):
            if sorted(got) != sorted(want):
                raise AssertionError(f"graphs={g}: {name} leaves differ from the eager run's")
            for path, w in want.items():
                if path == "step":
                    if not torch.equal(got[path], w):
                        raise AssertionError(f"graphs={g}: step counter {got[path]} against {w}")
                    continue
                scale = max(float(w.float().abs().max()), 1e-30)
                d = float((got[path].float() - w.float()).abs().max()) / scale
                if d > leaf_diff:
                    leaf_diff, leaf_at = d, f"{name}/{path}"
                if not d <= TRAIN_GRAPH_LEAF_TOL:
                    raise AssertionError(f"graphs={g}: {name}/{path} differs from the eager "
                                         f"leaf by {d} of its largest magnitude")
    del ends

    def after_first(graphs: bool):
        ms = [m for g, rec in zip(runs, recs) if g == graphs for m in rec["step_ms"][1:]]
        return statistics.median(ms) if ms else None

    out = {
        "config": cfg.name,
        "seq_len": seq_len,
        "global_batch": global_batch,
        "microbatches": microbatches,
        "steps": steps,
        "runs": ["graph" if g else "eager" for g in runs],
        "losses": [[m["loss"] for m in rec["metrics"]] for rec in recs],
        "max_metric_rel_diff": metric_diff,
        "max_leaf_diff": leaf_diff,
        "max_leaf_diff_at": leaf_at,
        "step_ms_median": {m: after_first(g) for m, g in (("eager", False), ("graph", True))
                           if g in runs},
        "first_step_ms": [rec["step_ms"][0] for rec in recs],
        "step_ms": [rec["step_ms"] for rec in recs],
    }
    for k in ("capture_ms", "replays", "graph_pool_bytes", "peak_allocated_bytes",
              "peak_reserved_bytes", "alloc_retries", "reserved_before_close",
              "reserved_after_close"):
        out[k] = [rec.get(k) for rec in recs]
    return out


# ---------------------------------------------------------------------------
def checkpoint_profile(device) -> dict:
    """Phase 4b: the C/R cell again for a few turns, one checkpoint of it
    under ``torch.profiler``, for its device time by kernel.  It runs after
    every timed phase, since the profiler's tracing can slow the host's
    launches for the rest of the process."""
    metrics = run_main_path(device, turns=PROFILED_TURNS, profile_turn=PROFILED_TURN)
    return {"device_per_checkpoint": metrics["device_per_checkpoint"],
            "d2h_bytes_per_checkpoint_median": metrics["d2h_bytes_per_checkpoint_median"]}


def ep_compute_phase(device, model, unsharded: dict, launches: dict, card: str) -> None:
    """Phases 12a and 12b on ``model``, whose 9a run is ``unsharded``: their
    lines printed, their launches added to ``launches``; a failed gate
    fails the script."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    try:
        rows = run_ep_layer(device, model)
    except AssertionError as exc:
        fail(f"phase 12a: {exc}")
    for row in rows:
        say(f"[12a EP layer] {json.dumps(row)} (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    try:
        ep = run_ep_serving_path(device, model, unsharded)
    except AssertionError as exc:
        fail(f"phase 12b: {exc}")
    ep_launches = launch_counts()
    say(f"[12b EP serving] launches {json.dumps(ep_launches)}")
    want_pa = ep["global_attn_layers"] * ep["decode_steps"]
    if ep_launches["paged_attention"] != want_pa:
        fail(f"phase 12b: paged_attention launched {ep_launches['paged_attention']} times, "
             f"expected {want_pa}")
    for k in ("page_copy_stacked", "delta_apply"):
        if ep_launches[k] <= 0:
            fail(f"kernel {k} was not launched on phase 12b's path")
    if ep_launches["delta_diff"] + ep_launches["delta_fused"] <= 0:
        fail("no delta kernel was launched on phase 12b's path")
    say(f"[12b EP serving] {json.dumps(ep)} (card: {card})")
    say(f"[12b EP serving] step {ep['decode_ms_b1_median']:.1f} / {ep['decode_ms_b4_median']:.1f} "
        f"ms at B = 1 / 4 against {ep['unsharded_decode_ms_b1_median']:.1f} / "
        f"{ep['unsharded_decode_ms_b4_median']:.1f} unsharded; prefill {ep['prefill_ms']:.1f} "
        f"against {ep['unsharded_prefill_ms']:.1f} ms; {ep['a2a_bytes_per_decode_step']} B "
        f"all_to_all per rank a decode step; tokens equal {ep['trunk_tokens_equal']} + "
        f"{ep['fork_tokens_equal']} of {ep['tokens_compared']}; peak "
        f"{ep['max_memory_allocated']} B against {ep['unsharded_max_memory_allocated']} B "
        f"(card: {card})")
    for k, n in ep_launches.items():
        launches[k] += n


def launcher_phase(launches: dict, card: str) -> None:
    """Phase 12c, the serving launcher in this process: its lines printed,
    its launches added to ``launches``; a failed gate fails the script."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    try:
        served = run_serve_launcher()
    except AssertionError as exc:
        fail(f"phase 12c: {exc}")
    serve_launches = launch_counts()
    say(f"[12c launcher] launches {json.dumps(serve_launches)}")
    want_pa = 16 * served["steps"]              # olmo-1b: 16 global attention layers
    if serve_launches["paged_attention"] != want_pa:
        fail(f"phase 12c: paged_attention launched {serve_launches['paged_attention']} times, "
             f"expected {want_pa}")
    say(f"[12c launcher] {json.dumps(served)} (card: {card})")
    for k, n in serve_launches.items():
        launches[k] += n


# ---------------------------------------------------------------------------
# phase 13: the multi-pod dry run on meta tensors, checked against the card
# ---------------------------------------------------------------------------
# 13a: dense cells traced on logical meshes of 256 and 512 meta ranks (the
# MoE cells' expert-parallel trace over 256 ranks takes minutes: the CLI
# sweep runs them)
DRYRUN_CELLS = (("olmo-1b", "train_4k", False), ("qwen3-14b", "decode_32k", False),
                ("qwen3-14b", "decode_32k", True))
# 13b: cells cut in scale only, run for real on a (1, 1) mesh of the card:
# (arch, shape, global batches to try, largest first)
DRYRUN_CHECKS = (("olmo-1b", "train_4k", (8, 4, 2, 1)), ("qwen3-14b", "decode_32k", (4,)))
DRYRUN_STEPS = 3                # 13b: timed steps after one warm-up


def run_dryrun_cells(cells=DRYRUN_CELLS) -> list:
    """13a: ``repro_torch.launch.dryrun.run_cell`` for each (arch, shape,
    multi_pod) cell: records with the reference's keys, each with its wall
    seconds.  Gate: every record is ``ok``."""
    from repro_torch.launch import dryrun

    out = []
    for arch, shape_name, multi_pod in cells:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape_name, multi_pod=multi_pod)
        rec["wall_s"] = time.perf_counter() - t
        assert rec["status"] == "ok", f"{arch} {shape_name}: {rec}"
        out.append(rec)
    return out


def run_dryrun_check(device, *, arch: str, shape_name: str, global_batch: int,
                     config=None, seq_len=None, steps: int = DRYRUN_STEPS,
                     seed: int = 0) -> dict:
    """13b: one cell of ``arch``'s ``shape_name`` cut to ``global_batch``
    (and ``seq_len``), traced by the dry run on a (1, 1) mesh of a ``meta``
    rank, then built by ``build_step`` on a (1, 1) mesh of ``device`` and
    run on real arguments of exactly its example arguments' shapes
    (``dryrun.materialize``: seeded weights, fresh AdamW state, seeded
    tokens, a fresh cache).  ``config`` replaces the architecture's config
    (a ``-tiny`` one on the CPU).

    Gates (AssertionError): the device run's ``FlopCounterMode`` count
    equals the dry run's ``flops`` exactly, and the real arguments' bytes
    equal its ``memory.argument_bytes``.  Reports the step's median ms over
    ``steps`` runs after a warm-up, and on the card the step's temp bytes
    (``max_memory_allocated`` over the arguments and what was resident
    before them) and its FLOPs over the card's bf16 dense peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = get_config(config or arch)
    full = get_config(arch).shape(shape_name)
    cut = {"global_batch": global_batch, **({"seq_len": seq_len} if seq_len else {})}
    shape = dataclasses.replace(full, **cut)
    reduced = {k: [getattr(full, k), v] for k, v in cut.items() if getattr(full, k) != v}

    t = time.perf_counter()
    rec = dryrun.trace_cell(cfg, shape, dryrun.mesh_for(False, shape=(1, 1)))
    meta_s = time.perf_counter() - t

    resident = torch.cuda.memory_allocated(dev) if cuda else 0
    mesh = dryrun.mesh_for(False, shape=(1, 1), device=dev)
    fn, args, _, _ = dryrun.build_step(cfg, shape, mesh)
    t = time.perf_counter()
    real = dryrun.materialize(cfg, shape, args, dev, seed=seed)
    arg_bytes = sum(x.numel() * x.element_size() for x in dryrun.leaves(real))
    assert arg_bytes == rec["memory"]["argument_bytes"], (
        f"{arch}: the arguments hold {arg_bytes} B, the dry run says "
        f"{rec['memory']['argument_bytes']}")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sync()
    build_s = time.perf_counter() - t
    counter = FlopCounterMode(display=False)
    with dryrun.cell_context(cfg, shape, mesh), counter:
        out = fn(*real)
    del out
    flops = counter.get_total_flops()
    assert flops == rec["flops"], f"{arch}: {flops} FLOPs on {dev}, {rec['flops']} on meta"

    ms = []
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps + 1):            # the first is the warm-up
        sync()
        t = time.perf_counter()
        with dryrun.cell_context(cfg, shape, mesh):
            out = fn(*real)
        sync()
        del out
        if i:
            ms.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(ms)
    result = {
        "arch": arch, "config": cfg.name, "shape": shape_name, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len, "reduced": reduced,
        "device": str(dev), "argument_bytes": arg_bytes, "flops": flops,
        "meta_trace_s": meta_s, "build_s": build_s, "step_ms": ms, "step_ms_median": step_ms,
        "temp_bytes": None, "flops_fraction_of_bf16_peak": None,
    }
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        result["max_memory_allocated"] = peak
        result["resident_before_bytes"] = resident
        result["temp_bytes"] = peak - resident - arg_bytes
        bf16_peak = BF16_DENSE_PEAK.get(torch.cuda.get_device_name(dev))
        if bf16_peak:
            result["flops_fraction_of_bf16_peak"] = flops / (step_ms / 1e3) / bf16_peak
    return result


def run_dryrun_checks(device, checks=DRYRUN_CHECKS) -> list:
    """13b for each (arch, shape, batches) of ``checks``: the largest batch
    of ``batches`` whose step fits on the card (a batch that runs out of
    memory is noted and the next tried)."""
    import torch

    rows = []
    for arch, shape_name, batches in checks:
        too_big = []
        for b in batches:
            try:
                row = run_dryrun_check(device, arch=arch, shape_name=shape_name, global_batch=b)
            except torch.cuda.OutOfMemoryError:
                too_big.append(b)
                row = None
            gc.collect()
            torch.cuda.empty_cache()
            if row is not None:
                row["batches_out_of_memory"] = too_big
                rows.append(row)
                break
        else:
            raise AssertionError(f"{arch} {shape_name}: no batch of {batches} fits")
    return rows


def dryrun_phase(device, card: str) -> None:
    """Phase 13: 13a's records and 13b's checks printed; a failed gate or a
    kernel launched fails the script."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t13 = time.perf_counter()
    reset_launch_counts()
    try:
        recs = run_dryrun_cells()
    except AssertionError as exc:
        fail(f"phase 13a: {exc}")
    for rec in recs:
        say(f"[13a dry run] {json.dumps(rec)}")
        say(f"[13a dry run] {rec['arch']} {rec['shape']} on {rec['mesh']}: traced in "
            f"{rec['wall_s']:.1f} s on this host; {rec['flops']:.4e} FLOPs and "
            f"{rec['memory']['argument_bytes']} B of arguments a rank")
    try:
        rows = run_dryrun_checks(device)
    except AssertionError as exc:
        fail(f"phase 13b: {exc}")
    for row in rows:
        say(f"[13b dry run on the card] {json.dumps(row)} (card: {card})")
        say(f"[13b dry run on the card] {row['arch']} {row['shape']} at global batch "
            f"{row['global_batch']} (cut from {row['reduced'].get('global_batch', ['-'])[0]}): "
            f"FLOPs {row['flops']} and argument bytes {row['argument_bytes']} equal the dry "
            f"run's; step {row['step_ms_median']:.1f} ms (median of {len(row['step_ms'])}), "
            f"temp {row['temp_bytes']} B, {row['flops_fraction_of_bf16_peak']:.4f} of the "
            f"bf16 dense peak (card: {card})")
    if any(launch_counts().values()):
        fail(f"phase 13 launched a kernel: {json.dumps(launch_counts())}")
    say(f"[13 dry run] phase 13 ran {time.perf_counter() - t13:.1f} s (card: {card})")


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
    floor = time_launch_floor(device)
    say(f"[3 kernels] launch floor (an empty kernel in a graph, [cold, warm, clean] ms): "
        f"{json.dumps(floor)}")
    times = time_kernels(device)
    torch.cuda.empty_cache()

    # -- phase 3b: the serving kernels against their plain versions, then times
    errs.update(check_serving_kernels(device))
    say(f"[3b kernels] page copies bit-exact, paged_attention within "
        f"{PA_TOL['float32']} (fp32) / {PA_TOL['bfloat16']} (bf16): {json.dumps(errs)}")
    times.update(time_serving_kernels(device))
    torch.cuda.empty_cache()
    card = f"{smi_line}"

    # -- phase 4: the C/R main path (launch counts taken over exactly this run)
    reset_launch_counts()
    metrics = run_main_path(device)
    launches = launch_counts()
    say(f"[4 main path] launches {json.dumps(launches)}")
    for k in ("delta_fused", "delta_diff", "delta_apply"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    say(f"[4 main path] {json.dumps(metrics)} (card: {card})")
    say(f"[4 main path] auto mode, for information: {json.dumps(run_auto_turns(device))}")
    gc.collect()              # phase 4's DeltaCR holds its state in a reference cycle
    torch.cuda.empty_cache()
    say(f"[4 main path] device memory still allocated: {torch.cuda.memory_allocated()} B")

    # -- the whole qwen3-14b, built once for phases 6 and 7
    t0 = time.perf_counter()
    model = build_serving_model(device)
    torch.cuda.synchronize()
    say(f"[6 serving] {SERVE_CONFIG} built in {time.perf_counter() - t0:.2f} s: "
        f"{model.param_count()} parameters, {torch.cuda.memory_allocated()} B allocated")

    # -- phase 6: the serving path (launch counts taken over exactly this run)
    reset_launch_counts()
    serving = run_serving_path(device, model=model)
    serve_launches = launch_counts()
    say(f"[6 serving] launches {json.dumps(serve_launches)}")
    for k in ("paged_attention", "page_copy_stacked", "delta_diff", "delta_apply"):
        if serve_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serving path")
    if serve_launches["paged_attention"] != serving["layers"] * serving["decode_steps"]:
        fail(f"paged_attention launched {serve_launches['paged_attention']} times over "
             f"{serving['decode_steps']} decode steps of {serving['layers']} layers")
    say(f"[6 serving] {json.dumps(serving)} (card: {card})")
    for k in ("page_copy", "page_copy_stacked", "paged_attention"):
        launches[k] = serve_launches[k]
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 14: the decode programs as CUDA graphs against the eager step
    #    (launch counts taken over exactly this run)
    t14 = time.perf_counter()
    reset_launch_counts()
    try:
        graphed = run_graph_path(device, model)
    except AssertionError as exc:
        fail(f"phase 14: {exc}")
    graph_launches = launch_counts()
    say(f"[14 graphs] launches {json.dumps(graph_launches)}")
    for k in ("paged_attention", "page_copy_stacked"):
        if graph_launches[k] <= 0:
            fail(f"kernel {k} was not launched on phase 14's path")
    say(f"[14 graphs] {json.dumps(graphed)} (card: {card})")
    b4 = f"step_ms_b{SERVE_FORKS}"
    say(f"[14 graphs] {SERVE_CONFIG}: step B = 1 {graphed['step_ms_b1']['graph']:.2f} ms graphed "
        f"against {graphed['step_ms_b1']['eager']:.2f} ms eager, B = {SERVE_FORKS} "
        f"{graphed[b4]['graph']:.2f} ms against {graphed[b4]['eager']:.2f} ms; capture ms "
        f"{json.dumps(graphed['capture_ms'])}, graph pool {graphed['graph_pool_bytes']} B, "
        f"largest logit difference {graphed['max_abs_logit_diff']}; phase 14 ran "
        f"{time.perf_counter() - t14:.1f} s (card: {card})")
    for k, n in graph_launches.items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 7: agent search (launch counts taken over exactly this run)
    reset_launch_counts()
    search = run_search_path(device, model=model)
    search_launches = launch_counts()
    say(f"[7 search] launches {json.dumps(search_launches)}")
    for k in ("paged_attention", "page_copy_stacked", "delta_diff", "delta_apply"):
        if search_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the search path")
    steps = search["decode_search"]["decode_steps"]
    if search_launches["paged_attention"] != model.cfg.n_layers * steps:
        fail(f"paged_attention launched {search_launches['paged_attention']} times over "
             f"{steps} decode steps of {model.cfg.n_layers} layers")
    for part in ("decode_search", "rl_fanout"):
        say(f"[7 search] {part}: {json.dumps(search[part])} (card: {card})")
    say(f"[7 search] peak device memory {search['max_memory_allocated']} B (card: {card})")
    for k, n in search_launches.items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 8: persistence on the card (launch counts reset before each part)
    t8 = time.perf_counter()
    reset_launch_counts()
    try:
        persist = run_persist_path(device)
    except AssertionError as exc:
        fail(f"phase 8a: {exc}")
    writer = launch_counts()
    child = persist["recovered"]["launches"]
    say(f"[8a persist] launches: writer {json.dumps(writer)}; "
        f"recovering process {json.dumps(child)}")
    for k in ("delta_fused", "delta_diff"):
        if writer[k] <= 0:
            fail(f"kernel {k} was not launched by 8a's turns")
    for k in ("delta_apply", "delta_fused"):
        if child[k] <= 0:
            fail(f"kernel {k} was not launched by 8a's recovering process")
    say(f"[8a persist] {json.dumps(persist)} (card: {card})")
    for k in launches:
        launches[k] += writer[k] + child[k]
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    try:
        warm = run_warm_pool_path(device, model=model)
    except AssertionError as exc:
        fail(f"phase 8b: {exc}")
    warm_launches = launch_counts()
    say(f"[8b warm pool] launches {json.dumps(warm_launches)}")
    if warm_launches["paged_attention"] != warm["layers"] * warm["decode_steps"]:
        fail(f"paged_attention launched {warm_launches['paged_attention']} times over "
             f"{warm['decode_steps']} decode steps of {warm['layers']} layers")
    say(f"[8b warm pool] {json.dumps(warm)} (card: {card})")
    for k, n in warm_launches.items():
        launches[k] += n
    say(f"[8 persist] phase 8 ran {time.perf_counter() - t8:.1f} s (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 11: shard-native dumps over a logical mesh (launch counts over each part)
    t11 = time.perf_counter()
    shard_errs = check_shard_kernels(device)
    say(f"[11 kernels] bit-exact at 11a's part grids: {json.dumps(shard_errs)}")
    for k, e in shard_errs.items():
        errs[k] = max(errs[k], e)
    torch.cuda.empty_cache()
    reset_launch_counts()
    try:
        shard = run_shard_path(device)
    except AssertionError as exc:
        fail(f"phase 11a: {exc}")
    shard_launches = launch_counts()
    say(f"[11a sharded C/R] launches {json.dumps(shard_launches)}")
    for k in ("delta_fused", "delta_diff", "delta_apply"):
        if shard_launches[k] <= 0:
            fail(f"kernel {k} was not launched on phase 11a's path")
    say(f"[11a sharded C/R] {json.dumps(shard)} (card: {card})")
    for k, n in shard_launches.items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    try:
        shard_serve = run_sharded_serving_path(device, model=model)
    except AssertionError as exc:
        fail(f"phase 11b: {exc}")
    serve11_launches = launch_counts()
    say(f"[11b sharded pool] launches {json.dumps(serve11_launches)}")
    for k in ("paged_attention", "page_copy_stacked", "delta_apply"):
        if serve11_launches[k] <= 0:
            fail(f"kernel {k} was not launched on phase 11b's path")
    say(f"[11b sharded pool] {json.dumps(shard_serve)} (card: {card})")
    for k, n in serve11_launches.items():
        launches[k] += n
    apply_err = check_apply_parts(device, shard_serve["slow_restore_parts"])
    errs["delta_apply"] = max(errs["delta_apply"], apply_err)
    say(f"[11 kernels] delta_apply bit-exact at 11b's slow-restore part grids "
        f"{json.dumps(shard_serve['slow_restore_parts'])}: {apply_err}")
    say(f"[11 sharded] phase 11 ran {time.perf_counter() - t11:.1f} s (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[6 serving] B = {SERVE_FORKS} decode step profiled after phases 7, 8 and 11, graphed "
        f"(a replay): {json.dumps(profile_decode_step(device, model))} (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[6 serving] the same step eager: "
        f"{json.dumps(profile_decode_step(device, model, graphs=False))} (card: {card})")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 4b: one checkpoint's device time, after every timed phase
    say(f"[4b checkpoint profile] {json.dumps(checkpoint_profile(device))} (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 9: the remaining model families (launch counts reset before each part)
    t9 = time.perf_counter()
    say(f"[9 families] device memory allocated before phase 9: "
        f"{torch.cuda.memory_allocated()} B")
    for part, config, periods, embed_std in FAMILY_PARTS:
        t = time.perf_counter()
        fam_model = build_family_model(device, config, periods, embed_std)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        reset_launch_counts()
        try:
            fam = run_family_path(device, config=config, model=fam_model)
        except AssertionError as exc:
            fail(f"phase {part}: {exc}")
        fam_launches = launch_counts()
        prefill_logits = fam.pop("prefill_logits")
        fam["build_s"] = build_s
        tag = f"[{part} {fam['config']}]"
        say(f"{tag} launches {json.dumps(fam_launches)}")
        want_pa = fam["global_attn_layers"] * fam["decode_steps"]
        if fam_launches["paged_attention"] != want_pa:
            fail(f"phase {part}: paged_attention launched {fam_launches['paged_attention']} "
                 f"times, expected {want_pa}")
        if part == "9a":
            for k in ("paged_attention", "page_copy_stacked", "delta_apply"):
                if fam_launches[k] <= 0:
                    fail(f"kernel {k} was not launched on phase 9a's path")
            if fam_launches["delta_diff"] + fam_launches["delta_fused"] <= 0:
                fail("no delta kernel was launched on phase 9a's path")
        say(f"{tag} {json.dumps(fam)} ({time.perf_counter() - t:.1f} s; card: {card})")
        for k, n in fam_launches.items():
            launches[k] += n
        if part == "9a":
            # -- phase 12: sharded compute on 9a's model, then the launcher
            #    (launch counts over each part)
            t12 = time.perf_counter()
            fam["prefill_logits"] = prefill_logits
            ep_compute_phase(device, fam_model, fam, launches, card)
        del fam, fam_model, prefill_logits
        gc.collect()
        torch.cuda.empty_cache()
        if part == "9a":
            launcher_phase(launches, card)
            say(f"[12 sharded compute] phase 12 ran {time.perf_counter() - t12:.1f} s "
                f"(card: {card})")
    t = time.perf_counter()
    reset_launch_counts()
    try:
        rows = run_sublayer_checks(device)
    except AssertionError as exc:
        fail(f"phase 9d: {exc}")
    for k, n in launch_counts().items():
        launches[k] += n
    for row in rows:
        say(f"[9d sublayers] {json.dumps(row)}")
    say(f"[9d sublayers] every sublayer within {SUBLAYER_TOL} of the CPU "
        f"({time.perf_counter() - t:.1f} s; card: {card})")
    say(f"[9 families] phase 9 ran {time.perf_counter() - t9:.1f} s (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 10: training at full olmo-1b width (launch counts over exactly this run)
    say(f"[10 train] device memory allocated before phase 10: "
        f"{torch.cuda.memory_allocated()} B")
    reset_launch_counts()
    try:
        train = run_train_path(device)
    except AssertionError as exc:
        fail(f"phase 10: {exc}")
    train_launches = launch_counts()
    say(f"[10 train] launches {json.dumps(train_launches)}: the training path checkpoints "
        f"into the host DeltaFS and runs none of the port's kernels")
    if any(train_launches.values()):
        fail(f"phase 10 launched a kernel: {json.dumps(train_launches)}")
    say(f"[10 train] {train['config']}: {train['params']} parameters; cut from train_4k: "
        f"global batch {train['reduced']['global_batch'][0]} -> {train['global_batch']}, "
        f"steps {train['reduced']['steps'][0]} -> {train['steps']} "
        f"(sequence {train['seq_len']}, {train['microbatches']} microbatches)")
    say(f"[10 train] {json.dumps(train)} (card: {card})")
    say(f"[10 train] step {train['step_ms_median']:.1f} ms (median after the first), "
        f"{train['tokens_per_s']:.0f} tokens/s, MFU {train['mfu']}, peak "
        f"{train['peak_memory_bytes']} B; snapshot {train['snapshot_ms_synced']:.1f} ms, "
        f"background write {train['ckpt_write_s']:.1f} s for {train['ckpt_write_bytes']} B, "
        f"restore {train['restore_s']:.1f} s; graphed {train['graphs']}, capture "
        f"{train['capture_ms']} ms, graph pool {train['graph_pool_bytes']} B; phase 10 ran "
        f"{train['phase_s']:.1f} s (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 15: the train step program as a CUDA graph against the eager step
    t15 = time.perf_counter()
    reset_launch_counts()
    try:
        tgraph = run_train_graph_path(device)
    except AssertionError as exc:
        fail(f"phase 15: {exc}")
    if any(launch_counts().values()):
        fail(f"phase 15 launched a kernel: {json.dumps(launch_counts())}")
    say(f"[15 train graphs] {json.dumps(tgraph)} (card: {card})")
    say(f"[15 train graphs] {tgraph['config']}: step {tgraph['step_ms_median']['graph']:.1f} ms "
        f"graphed against {tgraph['step_ms_median']['eager']:.1f} ms eager (medians after the "
        f"first step; first steps {json.dumps(tgraph['first_step_ms'])} ms); capture "
        f"{tgraph['capture_ms'][1]:.1f} ms, graph pool {tgraph['graph_pool_bytes'][1]} B, peak "
        f"allocated {json.dumps(tgraph['peak_allocated_bytes'])} B; largest metric difference "
        f"{tgraph['max_metric_rel_diff']} (relative), largest leaf difference "
        f"{tgraph['max_leaf_diff']} at {tgraph['max_leaf_diff_at']}; phase 15 ran "
        f"{time.perf_counter() - t15:.1f} s (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 10b: one profiled training step graphed and eager (in a fresh
    #    process), and a checkpoint write alone
    t = time.perf_counter()
    reset_launch_counts()
    try:
        train_profile = profile_train_step(device)
        eager_profile = profile_eager_train_step()
    except AssertionError as exc:
        fail(f"phase 10b: {exc}")
    for prof_launches in (launch_counts(), eager_profile.pop("launches")):
        if any(prof_launches.values()):
            fail(f"phase 10b launched a kernel: {json.dumps(prof_launches)}")
    say(f"[10b train profile] graphed (a replay): {json.dumps(train_profile)} (card: {card})")
    say(f"[10b train profile] eager: {json.dumps(eager_profile)} (card: {card})")
    diff = kernel_count_diff(train_profile, eager_profile)
    say(f"[10b train profile] kernels a step: {train_profile['kernels']} graphed, "
        f"{eager_profile['kernels']} eager; idle {train_profile['idle_share']:.4f} graphed, "
        f"{eager_profile['idle_share']:.4f} eager; kernel counts that differ by name: "
        f"{json.dumps(diff)}; copies and memsets by name, graphed against eager: "
        f"{json.dumps(kernel_count_diff(train_profile, eager_profile, 'copy_counts'))} "
        f"({time.perf_counter() - t:.1f} s; card: {card})")
    if train_profile["kernels"] != eager_profile["kernels"]:
        fail(f"phase 10b: the graphed step ran {train_profile['kernels']} kernels, the eager "
             f"step {eager_profile['kernels']}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 13: the multi-pod dry run on meta tensors, checked against the card
    dryrun_phase(device, card)

    # -- phase 5: report
    kernels = []
    meta = {
        "delta_fused": ("src/repro_torch/kernels/csrc/delta_fused.cu",
                        "src/repro/kernels/delta_fused.py:71"),
        "delta_diff": ("src/repro_torch/kernels/csrc/delta_diff.cu",
                       "src/repro/kernels/delta_diff.py:26"),
        "delta_apply": ("src/repro_torch/kernels/csrc/delta_apply.cu",
                        "src/repro/kernels/delta_apply.py:28"),
        "page_copy_stacked": ("src/repro_torch/kernels/csrc/page_copy.cu",
                              "src/repro/kernels/page_copy.py:58"),
        "page_copy": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:29"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:101"),
    }
    for key, t in times.items():
        kname = next(k for k in meta if key == k or key.startswith(k + "_"))
        extra = {k: t[k] for k in ("library_note", "bound_unique_ms", "clusters") if k in t}
        say(json.dumps({"name": key, "shape": t["shape"], "launches": launches[kname],
                        "kernel_ms": t["kernel_ms"], "kernel_warm_ms": t["kernel_warm_ms"],
                        "kernel_cold_clean_ms": t["kernel_cold_clean_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "library_ms": t["library_ms"], **extra,
                        "launch_floor_ms": floor, "card": card}))
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
