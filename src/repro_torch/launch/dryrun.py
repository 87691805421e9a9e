"""Multi-pod dry run: trace every (arch × shape × mesh) cell on ``meta`` tensors.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's step
under GSPMD on 256 or 512 fake host devices and reads the compiled
artifact.  The port cannot compile a program for a mesh it does not have,
so it **traces the same step on ``meta`` tensors** under
``activation_sharding`` over a *logical* mesh of 256 (16, 16) or 512
(2, 16, 16) ``meta`` ranks, and counts what can be counted exactly.
Nothing is allocated and nothing is launched: the dry run needs no card,
in either package.

What each record key holds (the reference's keys, ``dryrun.py:382``–``:443``):

=============================  =============================================
``memory.argument_bytes``      exact: per rank, the sum over the example
                               arguments of ``numel(shard_shape) × itemsize``
``memory.output_bytes``        exact: the outputs' per-rank bytes (params,
                               optimizer state and the loss for train; the
                               logits, sharded as the reference pins them,
                               and the cache otherwise).  XLA's figure adds
                               its output tuple, one 8-byte pointer per leaf
``memory.alias_bytes``         exact: the donated arguments that come back
                               as outputs (a donated buffer pairs with an
                               output of the same per-rank shape and dtype,
                               each at most once, as XLA pairs donations)
``memory.temp_bytes``,         ``None``: torch has no buffer assignment on
``memory.generated_code_bytes`` ``meta`` (the card measures temp bytes)
``flops``                      ``FlopCounterMode``'s global count ÷
                               ``n_devices``: matmul, convolution and
                               attention ops only, every loop iteration
                               counted.  XLA's ``cost_analysis`` counts a
                               ``while`` body once and includes elementwise
                               ops, so the two differ by definition
``bytes_accessed``             ``None``
``collectives``                ``bytes_by_op`` and ``counts_by_op`` from
                               ``dist.collectives.LEDGER`` under the
                               reference's op names (bytes each rank receives
                               from other ranks, summed over ranks ÷ ranks;
                               calls), and ``total_bytes``.  Only the
                               expert-parallel MoE's explicit collectives
                               are counted; those GSPMD would insert (FSDP
                               gathers, gradient reduce-scatters,
                               tensor-parallel all-reduces) are absent, so
                               this is a lower bound (``scope`` says so)
``lower_s``                    the build and trace seconds
``compile_s``                  ``None``
``n_devices``, ``param_count``, as in the reference
``active_param_count``
``microbatches``               the reference's uncapped ``MICROBATCH`` entry
                               (``:442``), though the step runs the capped
                               count (a quirk kept)
=============================  =============================================

``parse_collectives`` (``:287``) is not ported: it parses XLA's partitioned
HLO text, which the port does not have.  The sweep writes its records
incrementally to ``--out`` and ``--resume`` skips cells already there.
Unlike the reference, importing this module sets no ``XLA_FLAGS``.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun.json --resume
    python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import arch_names, get_config
from ..configs.base import ModelConfig, ShapeCfg
from ..dist import collectives
from ..dist.placement import Mesh, NamedSharding
from ..dist.placement import PartitionSpec as P
from ..dist.sharding import (activation_sharding, batch_spec, cache_specs, data_axes,
                             enforce_divisible, param_specs)
from ..models.model import Model
from ..train.optim import OptimizerConfig, adamw_init, adamw_update, tree_map, tree_paths
from .mesh import make_logical_mesh

__all__ = [
    "Arg",
    "MICROBATCH",
    "build_step",
    "cell_context",
    "input_specs",
    "leaves",
    "main",
    "materialize",
    "mesh_for",
    "run_cell",
    "shard_bytes",
    "trace_cell",
]

# ---------------------------------------------------------------------------
# input specs (meta stand-ins; no allocation)
# ---------------------------------------------------------------------------


class Arg(NamedTuple):
    """A step argument's stand-in: a ``meta`` tensor of its global shape and
    dtype, and its sharding over the cell's mesh."""

    tensor: torch.Tensor
    sharding: NamedSharding

    @property
    def shard_bytes(self) -> int:
        return shard_bytes(self.tensor, self.sharding)


def _block(t: torch.Tensor, sharding: NamedSharding) -> tuple:
    """One rank's block shape of ``t``: a dimension its axes do not divide
    is padded to equal shards, as XLA pads one."""
    return tuple(-(-int(d) // c) for d, c in zip(t.shape, sharding.split_counts(t.dim())))


def shard_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """One rank's bytes of ``t`` under ``sharding``."""
    return int(np.prod(_block(t, sharding), dtype=np.int64)) * t.element_size()


def leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples (an :class:`Arg` is a
    leaf), in insertion order."""
    if isinstance(tree, Arg) or not isinstance(tree, (dict, list, tuple)):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in leaves(item)]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, Arg) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def _sds(shape, dtype, mesh: Mesh, spec: P) -> Arg:
    return Arg(torch.empty(shape, dtype=dtype, device="meta"), NamedSharding(mesh, spec))


def _tree_sds(shapes: Any, specs: Any, mesh: Mesh) -> Any:
    return tree_map(lambda t, spec: Arg(t, NamedSharding(mesh, spec)), shapes, specs)


def _cache_sds(model: Model, batch: int, max_seq: int, mesh: Mesh, *, long_context: bool):
    """The cache of ``model.init_cache`` (on ``meta``), each leaf with its
    name's spec truncated to the leaf's rank and guarded by divisibility."""
    cspecs = cache_specs(model.cfg, mesh, long_context=long_context)

    def walk(node: Any, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        spec = P(*tuple(cspecs.get(name, P()))[: node.dim()])
        spec = enforce_divisible(spec, node.shape, mesh)
        return Arg(node, NamedSharding(mesh, spec))

    return walk(model.init_cache(batch, max_seq), "")


def input_specs(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh) -> Dict[str, Any]:
    """``meta`` stand-ins, each with its sharding, for every model input of
    this cell."""
    model = Model(cfg, device="meta")
    dp = batch_spec(shape.kind, mesh, long_context=(shape.name == "long_500k"))
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            out["batch"] = {
                "embeds": _sds((B, S, cfg.d_model), torch.bfloat16, mesh, P(dp[0], None, None)),
                "labels": _sds((B, S), torch.int32, mesh, P(dp[0], None)),
            }
        else:
            out["batch"] = {
                "tokens": _sds((B, S), torch.int32, mesh, dp),
                "labels": _sds((B, S), torch.int32, mesh, dp),
            }
    elif shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            out["tokens"] = _sds((B, S, cfg.d_model), torch.bfloat16, mesh, P(dp[0], None, None))
        else:
            out["tokens"] = _sds((B, S), torch.int32, mesh, dp)
        out["cache"] = _cache_sds(model, B, S, mesh, long_context=False)
    else:  # decode: one new token against a seq_len-deep cache
        long = shape.name == "long_500k"
        dpa = data_axes(mesh)
        if cfg.input_mode == "embeddings":
            out["tokens"] = _sds((B, 1, cfg.d_model), torch.bfloat16, mesh,
                                 P(None if long else dpa, None, None))
        else:
            out["tokens"] = _sds((B,), torch.int32, mesh, P(None if long else dpa))
        out["cache"] = _cache_sds(model, B, S, mesh, long_context=long)
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

# Gradient-accumulation / batch-split factors per (arch, kind): the memory
# lever for cells whose activations exceed HBM at the full global batch.
# The reference's table (``dryrun.py:124``), copied.
MICROBATCH = {
    ("jamba-1.5-large-398b", "train"): 16,
    ("jamba-1.5-large-398b", "prefill"): 2,
    ("jamba-1.5-large-398b", "decode"): 4,
    ("gemma3-27b", "train"): 8,
    ("gemma3-27b", "prefill"): 2,
    ("dbrx-132b", "train"): 8,
    ("xlstm-1.3b", "train"): 8,
    ("qwen3-14b", "train"): 4,
    ("qwen3-moe-30b-a3b", "train"): 2,
    ("musicgen-large", "train"): 2,
}


def _cap_micro(n_micro: int, global_batch: int, mesh: Mesh) -> int:
    """Each microbatch must still cover the data-parallel axes evenly."""
    sizes = mesh.shape
    dp = int(np.prod([sizes[a] for a in data_axes(mesh)]))
    cap = max(global_batch // dp, 1)
    while cap > 1 and global_batch % cap:
        cap -= 1
    return max(1, min(n_micro, cap))


def _value_and_grad(model: Model, params: Any, batch: Dict[str, torch.Tensor]):
    """(loss, grads) of ``model.loss_fn`` at ``params``; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = [leaf for _, leaf in tree_paths(live)]
    with torch.enable_grad():
        loss, _ = model.loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(leaf): g for leaf, g in zip(flat, grads)}
    grads = tree_map(lambda t: by_leaf[id(t)] if by_leaf[id(t)] is not None
                     else torch.zeros_like(t), live)
    return loss.detach(), grads


def build_step(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh):
    """Returns ``(fn, example_args, donate, out_specs)`` for this cell.

    ``example_args`` is a tuple of trees of :class:`Arg` (``meta`` tensors);
    ``fn`` takes the same trees of real tensors, on the device of the
    mesh's ranks (``meta`` in a dry run).  ``donate`` names the arguments
    the step may overwrite: the train step updates params and moments in
    place (``adamw_update(..., inplace=True)``), prefill and decode write
    the cache in place.  ``out_specs`` pins the outputs of prefill and
    decode (logits, cache) as the reference pins them; None for train."""
    model = Model(cfg, device=mesh.device_of(0))
    pspecs = param_specs(cfg, mesh)
    pshapes = model.param_shapes()
    params_sds = _tree_sds(pshapes, pspecs, mesh)
    specs = input_specs(cfg, shape, mesh)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(
            moment_dtype="bfloat16" if cfg.opt_state_dtype == "bf16" else "float32",
            total_steps=10_000,
        )
        opt_shapes = adamw_init(pshapes, opt_cfg)
        opt_sds = {
            "m": _tree_sds(opt_shapes["m"], pspecs, mesh),
            "v": _tree_sds(opt_shapes["v"], pspecs, mesh),
            "step": Arg(opt_shapes["step"], NamedSharding(mesh, P())),
        }
        n_micro = _cap_micro(MICROBATCH.get((cfg.name, "train"), 1), shape.global_batch, mesh)
        acc_dtype = torch.bfloat16 if cfg.opt_state_dtype == "bf16" else torch.float32

        def train_step(params, opt_state, batch):
            if n_micro == 1:
                loss, grads = _value_and_grad(model, params, batch)
            else:
                # the reference's lax.scan over microbatches, as a loop
                gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                      device=p.device), params)
                lsum = torch.zeros((), dtype=torch.float32, device=model.device)
                for i in range(n_micro):
                    mb = {k: v.reshape((n_micro, -1) + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    loss, g = _value_and_grad(model, params, mb)
                    tree_map(lambda a, gg: a.add_(gg.to(acc_dtype)), gsum, g)
                    del g
                    lsum = lsum + loss
                grads = tree_map(lambda g: g / n_micro, gsum)
                loss = lsum / n_micro
            params, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg, inplace=True)
            return params, opt_state, loss

        return train_step, (params_sds, opt_sds, specs["batch"]), (0, 1), None

    long = shape.name == "long_500k"
    logits_sh = NamedSharding(mesh, P(None if long else data_axes(mesh), "model"))
    cache_sh = _map(lambda a: a.sharding, specs["cache"])
    out_specs = (logits_sh, cache_sh)   # cache out = in, so donation aliases

    if shape.kind == "prefill":
        n_micro = _cap_micro(MICROBATCH.get((cfg.name, "prefill"), 1), shape.global_batch, mesh)

        def prefill_step(params, tokens, cache):
            model.params = params
            if n_micro == 1:
                return model.prefill(tokens, cache)
            # One microbatch at a time over the (N_periods, B, ...) cache:
            # each microbatch's cache is a view of its rows, which the model
            # writes in place, as the reference's dynamic_update_slice does.
            bsz = tokens.shape[0] // n_micro
            logits = []
            for i in range(n_micro):
                rows = slice(i * bsz, (i + 1) * bsz)
                sub = {k: (v[rows] if k == "lens" else tree_map(lambda c: c[:, rows], v))
                       for k, v in cache.items()}
                out, new_sub = model.prefill(tokens[rows], sub)
                cache["lens"][rows] = new_sub["lens"]
                logits.append(out)
            return torch.cat(logits), cache

        return prefill_step, (params_sds, specs["tokens"], specs["cache"]), (2,), out_specs

    def serve_step(params, tokens, cache):
        model.params = params
        return model.decode_step(tokens, cache)

    return serve_step, (params_sds, specs["tokens"], specs["cache"]), (2,), out_specs


def materialize(cfg: ModelConfig, shape: ShapeCfg, args: tuple, device: Any, *,
                seed: int = 0) -> tuple:
    """Real tensors on ``device`` of exactly ``args``' shapes and dtypes (a
    cell's step run for real, to check the dry run's counts): params from
    ``Model.draw`` with a generator seeded with ``seed``, fresh AdamW state,
    seeded token ids and labels (embeddings at std 1), a fresh
    ``init_cache``.  Raises if a leaf differs from its stand-in."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Model(cfg, device=dev)
    params = model.draw(gen)
    B, S = shape.global_batch, shape.seq_len

    def ids(shp):
        return torch.randint(0, cfg.vocab_size, shp, generator=gen, device=dev,
                             dtype=torch.int32)

    def embeds(shp):
        return torch.randn(shp, generator=gen, device=dev).to(torch.bfloat16)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(
            moment_dtype="bfloat16" if cfg.opt_state_dtype == "bf16" else "float32")
        inputs = {"embeds": embeds((B, S, cfg.d_model))} if cfg.input_mode == "embeddings" \
            else {"tokens": ids((B, S))}
        real = (params, adamw_init(params, opt_cfg), {**inputs, "labels": ids((B, S))})
    else:
        S_in = S if shape.kind == "prefill" else 1
        if cfg.input_mode == "embeddings":
            tokens = embeds((B, S_in, cfg.d_model))
        else:
            tokens = ids((B, S_in) if shape.kind == "prefill" else (B,))
        real = (params, tokens, model.init_cache(B, S))
    got, want = leaves(real), leaves(args)
    if len(got) != len(want) or any(
            tuple(t.shape) != tuple(a.tensor.shape) or t.dtype != a.tensor.dtype
            for t, a in zip(got, want)):
        raise ValueError("the real arguments do not match the dry run's stand-ins")
    return real


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

# the reference's collective op names, and the port's ledger ops under them
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_LEDGER_OPS = {"all_gather": "all-gather", "pmean": "all-reduce", "all_to_all": "all-to-all"}
COLLECTIVES_SCOPE = ("explicit expert-parallel collectives only; the collectives GSPMD would "
                     "insert are absent, so this is a lower bound")


def mesh_for(multi_pod: bool = False, *, shape=None, device: Any = "meta") -> Mesh:
    """The production layout as a logical mesh, every rank on ``device``:
    (16, 16) over ("data", "model") or (2, 16, 16) over ("pod", "data",
    "model"); ``shape`` overrides the axis sizes."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_logical_mesh(shape, axes, device=device)


def cell_context(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh):
    """The reference's ``activation_sharding`` for this cell
    (``dryrun.py:397``–``:405``)."""
    long = shape.name == "long_500k"
    dp = data_axes(mesh)
    return activation_sharding(
        dp=() if long else dp,
        # decode caches are seq-sharded over "model" (long: over dp)
        seq=dp if long else (("model",) if shape.kind == "decode" else ()),
        model="model",
        attn_shard=cfg.attn_shard,
        seq_parallel=(shape.kind in ("train", "prefill")) and not os.environ.get("REPRO_NO_SP"),
        mesh=mesh,
    )


def _memory(args: tuple, out: Any, donate: tuple, out_specs: Any, mesh: Mesh) -> Dict[str, Any]:
    arg_leaves = leaves(args)
    if out_specs is None:
        # train: params and moments keep their argument's sharding; the loss
        # is replicated
        out_sh = (_map(lambda a: a.sharding, args[0]), _map(lambda a: a.sharding, args[1]),
                  NamedSharding(mesh, P()))
    else:
        out_sh = out_specs
    outs = list(zip(leaves(out), leaves(out_sh)))
    # a donated buffer pairs with an output of the same per-rank shape and
    # dtype, each at most once
    free: Dict[tuple, int] = {}
    for i in donate:
        for a in leaves(args[i]):
            key = (_block(a.tensor, a.sharding), a.tensor.dtype)
            free[key] = free.get(key, 0) + 1
    alias = 0
    for t, sh in outs:
        key = (_block(t, sh), t.dtype)
        if free.get(key, 0) > 0:
            free[key] -= 1
            alias += shard_bytes(t, sh)
    return {
        "argument_bytes": sum(a.shard_bytes for a in arg_leaves),
        "output_bytes": sum(shard_bytes(t, sh) for t, sh in outs),
        "temp_bytes": None,
        "generated_code_bytes": None,
        "alias_bytes": alias,
    }


def _per_rank(total: int, n: int):
    q, r = divmod(int(total), n)
    return q if r == 0 else total / n


def _collectives(n: int) -> Dict[str, Any]:
    snap = collectives.ledger()
    by_op = {c: 0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}
    for op, by_rank in snap["received"].items():
        by_op[_LEDGER_OPS[op]] = _per_rank(sum(by_rank.values()), n)
    for op, calls in snap["calls"].items():
        counts[_LEDGER_OPS[op]] = calls
    return {"bytes_by_op": by_op, "counts_by_op": counts,
            "total_bytes": sum(by_op.values()), "scope": COLLECTIVES_SCOPE}


def _meta_args(args: Any) -> Any:
    return _map(lambda a: a.tensor, args)


def trace_cell(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh) -> Dict[str, Any]:
    """Build the cell's step on ``mesh`` (of ``meta`` ranks) and trace it
    once under ``FlopCounterMode`` with the collective ledger reset: the
    record's measured keys (``status``, ``lower_s``, ``flops``,
    ``collectives``, ``memory``, ...)."""
    t0 = time.time()
    fn, args, donate, out_specs = build_step(cfg, shape, mesh)
    collectives.reset_ledger()
    counter = FlopCounterMode(display=False)
    with cell_context(cfg, shape, mesh), counter:
        out = fn(*_meta_args(args))
    lower_s = time.time() - t0
    n = mesh.size
    return {
        "status": "ok",
        "lower_s": round(lower_s, 2),
        "compile_s": None,
        "flops": counter.get_total_flops() / n,
        "bytes_accessed": None,
        "collectives": _collectives(n),
        "n_devices": n,
        "memory": _memory(args, out, donate, out_specs, mesh),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False) -> Dict[str, Any]:
    """One cell's record, with the reference's keys: a skip record for a
    skipped shape, else the trace of its step on the logical production
    mesh of ``meta`` ranks."""
    cfg = get_config(arch)
    shape = cfg.shape(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if shape.skip:
        rec["status"] = "skip"
        rec["reason"] = shape.skip_reason
        return rec
    rec.update(trace_cell(cfg, shape, mesh_for(multi_pod)))
    rec["param_count"] = cfg.param_count()
    rec["active_param_count"] = cfg.active_param_count()
    rec["microbatches"] = MICROBATCH.get((cfg.name, shape.kind), 1)
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = arch_names() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        for shape in cfg.shapes:
            if args.shape and shape.name != args.shape:
                continue
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                cells.append((arch, shape.name, mp))

    done: Dict[str, Any] = {}
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for rec in json.load(f):
                done[f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"] = rec

    results = list(done.values())
    for arch, shape_name, mp in cells:
        key = f"{arch}|{shape_name}|{'2x16x16' if mp else '16x16'}"
        if key in done:
            print(f"[skip-done] {key}")
            continue
        print(f"[run] {key}", flush=True)
        try:
            rec = run_cell(arch, shape_name, multi_pod=mp)
        except Exception as exc:
            rec = {
                "arch": arch,
                "shape": shape_name,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "error",
                "error": f"{type(exc).__name__}: {exc}",
                "traceback": traceback.format_exc()[-2000:],
            }
        if rec.get("status") == "ok":
            print(
                f"  ok: trace={rec['lower_s']}s flops={rec['flops']:.3e} "
                f"coll={rec['collectives']['total_bytes']:.3e}B",
                flush=True,
            )
            print(f"  memory: {rec['memory']}")
        else:
            print(f"  {rec['status']}: {rec.get('reason', rec.get('error', ''))[:300]}", flush=True)
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skip")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"\n=== dry-run summary: {n_ok} ok, {n_skip} skip, {n_err} error ===")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
