"""Fault-tolerant trainer: DeltaFS-backed coupled checkpoints and restart.

The JAX package's ``train/trainer.py`` on the port: the paper's
change-based C/R, retargeted at the training control plane.

* **The step.**  ``Model.loss_fn`` over an explicit params tree, its
  gradients by ``torch.autograd.grad``; with microbatches, the gradients
  are summed in float32 buffers and divided (as the reference's scan does);
  optional int8 compression with error feedback; then ``adamw_update``.
* **The step program.**  The reference compiles that step once
  (``Trainer._build_step``: one ``jax.jit`` with the params, moments and
  error buffer donated).  Here ``_get_step(batch)`` gives a
  :class:`TrainProgram`, keyed by the batch's shapes and dtypes,
  ``microbatches``, ``compress_grads`` and ``donate``: static buffers (the
  params, the moments and step counter, the error buffer, and the batch,
  staged from one pinned host buffer by one copy) and, on a CUDA device,
  one CUDA graph of the whole step over them (forward and backward of
  every microbatch, the float32 accumulation, compression, and AdamW in
  place).  The first step runs eagerly on a side stream and is the real
  step, then the capture follows; every later step replays.  A failed
  capture or replay raises: nothing falls back to the eager step.
  ``Trainer(graphs=None)`` takes the graph on a CUDA device and today's
  eager step on the CPU; ``graphs=False`` is the eager step on the card.
* **Coupled checkpoints.**  Every K steps the trainer snapshots the
  *(model+optimizer state, data-pipeline cursor)* pair: a device clone of
  every leaf, dispatched inline on the current stream (so the next step,
  donated or not, can never change the snapshot), then a background thread
  copies each clone to the host on a side stream and delta-encodes it into
  ``DeltaFS`` under the reference's paths (``ckpt/params/...``,
  ``ckpt/opt/...``, ``ckpt/data/{cursor,buf}``, ``ckpt/meta/step``).
  Unchanged chunks are shared with the previous generation.
* **Restart.**  ``restore_latest`` rebuilds params / optimizer state / data
  cursor from the last *complete* generation onto the trainer's device,
  taking the tree's shapes and dtypes from ``Model.param_shapes()`` (meta
  tensors: nothing is drawn or allocated to learn them).
  ``save_checkpoints`` / ``load_checkpoints`` carry the generations across
  processes in the reference's archive format, so each package restores
  the other's.
* **Straggler mitigation.**  A step-time watchdog flags outliers
  (> factor × rolling median) and fires a mitigation callback.
* **Gradient compression.**  Optional int8 + error feedback.

The port's ``Trainer`` trains on one device: ``restore_latest`` takes a
device and ``reshard`` moves each leaf to the device given for it.  The
reference's ``mesh=`` and ``param_shardings=`` arguments, which it stores
and never reads, have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import faults
from ..core.deltacr import resolve_device
from ..core.deltafs import DeltaFS
from ..kernels import accounting
from ..models.model import Model
from .data import DataConfig, PackedStream
from .optim import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    decompress_grads,
    error_feedback_init,
    tree_map,
    tree_paths,
)

__all__ = ["TrainerConfig", "Trainer", "TrainProgram", "StragglerWatchdog"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    microbatches: int = 1               # gradient accumulation
    compress_grads: bool = False        # int8 + error feedback
    donate: bool = False                # update params and moments in place
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 16


class StragglerWatchdog:
    """Flags steps slower than factor × rolling median; fires mitigation."""

    def __init__(self, factor: float, window: int,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.factor = factor
        self.times: deque = deque(maxlen=window)
        self.flagged: List[int] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 4:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                is_straggler = True
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt / med)
        self.times.append(dt)
        return is_straggler


def _loss_and_grads(model: Model, params, batch):
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = [leaf for _, leaf in tree_paths(leaves)]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    # a leaf the loss does not reach gets a zero gradient, as in JAX
    by_leaf = {id(leaf): g for leaf, g in zip(flat, grads)}
    grads = tree_map(
        lambda t: by_leaf[id(t)] if by_leaf[id(t)] is not None else torch.zeros_like(t),
        leaves,
    )
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _step(model: Model, opt_cfg: OptimizerConfig, tcfg: TrainerConfig,
          params, opt_state, err_buf, batch, *, inplace: bool):
    """One optimizer step on device tensors: (params, opt_state, err_buf,
    {"loss", "lr", "grad_norm"}); ``inplace`` writes the new params and
    moments into the given ones."""
    if tcfg.microbatches > 1:
        mb = tcfg.microbatches
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(mb):
            mbatch = {k: v.reshape((mb, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
            loss, _, g = _loss_and_grads(model, params, mbatch)
            tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
            del g             # free this microbatch's gradients before the next backward
            lsum = lsum + loss
        grads = tree_map(lambda g: g.div_(mb), gsum)
        loss = lsum / mb
    else:
        loss, _, grads = _loss_and_grads(model, params, batch)

    if tcfg.compress_grads:
        comp, err_buf = compress_grads(grads, err_buf)
        grads = decompress_grads(comp)

    params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg,
                                                  inplace=inplace)
    return params, opt_state, err_buf, {"loss": loss, **opt_metrics}


class TrainProgram:
    """The trainer's step over static buffers, run eagerly or replayed from
    a CUDA graph (see the module docstring).

    The static params, moments and step counter (and, with
    ``compress_grads``, the error buffer) are made from the first step's
    trees: adopted with ``donate``, cloned without.  Each step copies in
    every leaf that is not the program's own (by address: the first step
    without ``donate``, a tree ``restore_latest`` returned) and updates the
    static leaves in place.  So a step returns the program's own trees,
    which the next step of this program overwrites; passing them back
    costs nothing, and without ``donate`` the caller's other trees are
    never written.  The metrics come back as copies."""

    def __init__(self, trainer: "Trainer", batch, *, graph: bool):
        self.model, self.opt_cfg, self.cfg = trainer.model, trainer.opt_cfg, trainer.cfg
        dev = trainer.device
        self.use_graph = graph
        # the graph pool and the side stream, taken now so that the program
        # holds no reference to its trainer
        self.resources = trainer._capture_resources() if graph else None
        self.keys = sorted(batch)
        shapes = {(tuple(np.shape(batch[k])), torch.as_tensor(batch[k]).dtype) for k in self.keys}
        if len(shapes) != 1:
            raise ValueError(f"batch entries of different shapes or dtypes: {shapes}")
        ((shape, dtype),) = shapes
        # every entry of the batch, one host buffer and one copy
        self.host = torch.empty((len(self.keys),) + shape, dtype=dtype,
                                pin_memory=dev.type == "cuda")
        self.staged = torch.empty_like(self.host, device=dev)
        self.batch = dict(zip(self.keys, self.staged.unbind(0)))
        self.params = self.opt_state = self.err_buf = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None   # the graph's outputs
        self.notes: List[accounting.Note] = []                   # what the capture counted
        self.capture_ms: Optional[float] = None
        self.replays = 0

    def body(self) -> Dict[str, torch.Tensor]:
        """One step over the static buffers, in place: the metrics."""
        _, _, err_buf, metrics = _step(self.model, self.opt_cfg, self.cfg, self.params,
                                       self.opt_state, self.err_buf, self.batch, inplace=True)
        if self.cfg.compress_grads:
            tree_map(lambda static, new: static.copy_(new), self.err_buf, err_buf)
        return metrics

    @torch.no_grad()
    def stage(self, params, opt_state, err_buf, batch) -> None:
        """Copy the batch into the static batch buffer, and every leaf of
        the given trees that is not the program's own into its static
        leaf (the first step makes the static trees)."""
        trees = {"params": params, "opt_state": opt_state}
        if self.cfg.compress_grads:
            trees["err_buf"] = err_buf
        if self.params is None:
            own = (lambda t: t) if self.cfg.donate else torch.clone
            for name, tree in trees.items():
                setattr(self, name, tree_map(own, tree))
        else:
            for name, tree in trees.items():
                tree_map(_copy_in, getattr(self, name), tree)
        # the host buffer is rewritten only after the previous step's copy
        # out of it ended: ``Trainer.run`` waits for each step's loss
        for i, k in enumerate(self.keys):
            self.host[i].copy_(torch.as_tensor(batch[k]))
        self.staged.copy_(self.host, non_blocking=True)

    def run(self) -> Dict[str, torch.Tensor]:
        """The step's metrics (the graph's static outputs on a replay: read
        them before the next run)."""
        if not self.use_graph:
            return self.body()
        if self.graph is None:
            # the warm-up is this step, its update the real one
            metrics, self.graph, self.metrics, self.notes, self.capture_ms = (
                accounting.warm_up_and_capture(self.body, *self.resources))
            return metrics
        self.graph.replay()
        accounting.replay(self.notes)
        self.replays += 1
        return self.metrics

    def step(self, params, opt_state, err_buf, batch):
        """Stage, run, and return (params, opt_state, err_buf, metrics):
        the program's own trees and copies of the metrics."""
        self.stage(params, opt_state, err_buf, batch)
        metrics = {k: v.clone() for k, v in self.run().items()}
        if self.cfg.compress_grads:
            err_buf = self.err_buf
        return self.params, self.opt_state, err_buf, metrics


def _copy_in(static: torch.Tensor, given: torch.Tensor) -> None:
    if given.shape != static.shape or given.dtype != static.dtype:
        raise ValueError(f"a {given.dtype} leaf of shape {tuple(given.shape)} where the "
                         f"program holds {static.dtype} {tuple(static.shape)}")
    if given.data_ptr() != static.data_ptr():
        static.copy_(given)


class Trainer:
    """Trains ``model`` on the model's device.  ``ckpt_log`` records, per
    checkpoint, the inline snapshot's host time (``snapshot_ms``), and once
    its background write has finished, the write's seconds and the bytes
    it encoded.

    ``graphs=None`` replays the step from a CUDA graph on a CUDA device
    and runs the eager step on the CPU; ``graphs=False`` runs the eager
    step on the card too; ``graphs=True`` on the CPU raises.  ``close()``
    drops the step programs, their graphs and their memory pool."""

    def __init__(
        self,
        model: Model,
        opt_cfg: OptimizerConfig,
        data_cfg: DataConfig,
        trainer_cfg: TrainerConfig = TrainerConfig(),
        *,
        ckpt_fs: Optional[DeltaFS] = None,
        graphs: Optional[bool] = None,
    ):
        on_card = model.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True needs a CUDA device, the model is on {model.device}")
        self.model = model
        self.device = model.device
        self.graphs = on_card if graphs is None else bool(graphs)
        self.opt_cfg = dataclasses.replace(
            opt_cfg,
            moment_dtype="bfloat16" if model.cfg.opt_state_dtype == "bf16" else "float32",
        )
        self.data_cfg = data_cfg
        self.cfg = trainer_cfg
        self.fs = ckpt_fs or DeltaFS(chunk_bytes=1 << 20)
        self.stream = PackedStream(data_cfg)
        self.ckpt_index: Dict[int, Any] = {}      # step -> DeltaFS layer config
        self.ckpt_log: List[Dict[str, float]] = []
        self._ckpt_threads: List[threading.Thread] = []
        self._ckpt_errors: List[BaseException] = []
        self._ckpt_lock = threading.Lock()
        self.watchdog = StragglerWatchdog(trainer_cfg.straggler_factor,
                                          trainer_cfg.straggler_window)
        self.metrics_log: List[Dict[str, float]] = []
        self._steps: Dict[Tuple[Any, ...], TrainProgram] = {}
        self._graph_pool: Any = None
        self._side: Optional[torch.cuda.Stream] = None

    # ------------------------------------------------------------- step fn
    def train_step(self, params, opt_state, err_buf, batch):
        """One optimizer step on ``batch`` (host arrays or tensors).
        Returns (params, opt_state, err_buf, {"loss", "lr", "grad_norm"}).

        Graphed, the returned trees are the step program's buffers, which
        the next step of this trainer overwrites (``TrainProgram``).
        Eager, ``donate`` updates the given params and moments in place and
        without it the step returns new tensors."""
        if self.graphs:
            return self._get_step(batch).step(params, opt_state, err_buf, batch)
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return _step(self.model, self.opt_cfg, self.cfg, params, opt_state, err_buf, batch,
                     inplace=self.cfg.donate)

    def _get_step(self, batch) -> TrainProgram:
        """The step program of ``batch``'s shapes and dtypes and this
        trainer's step options, made on first use."""
        tcfg = self.cfg
        key = (tuple((k, tuple(np.shape(v)), str(v.dtype)) for k, v in sorted(batch.items())),
               tcfg.microbatches, tcfg.compress_grads, tcfg.donate)
        prog = self._steps.get(key)
        if prog is None:
            prog = self._steps[key] = TrainProgram(self, batch, graph=True)
        return prog

    def _capture_resources(self) -> Tuple[Any, torch.cuda.Stream]:
        """The graph memory pool of this trainer's programs and the side
        stream of their warm-ups and captures."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        return self._graph_pool, self._side

    def close(self) -> None:
        """Drop the step programs, their graphs and their memory pool (the
        pool's memory goes back to the caching allocator; tensors a step
        returned stay the caller's)."""
        self._steps.clear()
        self._graph_pool = self._side = None

    # ----------------------------------------------------------------- init
    def init_state(self, seed: int = 0):
        """(params, opt_state, err_buf) on the trainer's device: params drawn
        by ``Model.draw`` from a generator seeded with ``seed`` (the numbers
        differ from the JAX package's), fresh moments."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.draw(gen)
        opt_state = adamw_init(params, self.opt_cfg)
        return params, opt_state, self._fresh_err_buf(params)

    def _fresh_err_buf(self, params):
        if self.cfg.compress_grads:
            return error_feedback_init(params)
        return torch.zeros((), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ run
    def run(
        self,
        params,
        opt_state,
        err_buf,
        *,
        start_step: int = 0,
        steps: Optional[int] = None,
        fail_at: Optional[int] = None,       # legacy shim over core.faults
    ):
        n = steps if steps is not None else self.cfg.steps
        # The crash hook goes through the shared fault registry
        # (``trainer.step`` fires once per loop iteration); ``fail_at`` arms
        # a one-shot FaultError (a RuntimeError) on this run's fail_at-th
        # step seam hit, as in the reference.
        plan = faults.active_plan()
        local_plan = None
        if fail_at is not None and fail_at >= start_step:
            local_plan = plan if plan is not None else faults.FaultPlan()
            local_plan.add(
                "trainer.step", after=local_plan.hits("trainer.step") + (fail_at - start_step) + 1
            )
            if plan is None:
                faults.install(local_plan)
        try:
            return self._run_loop(params, opt_state, err_buf, start_step=start_step, n=n)
        finally:
            if local_plan is not None and plan is None:
                faults.clear()

    def _run_loop(self, params, opt_state, err_buf, *, start_step: int, n: int):
        step = start_step
        while step < n:
            t0 = time.perf_counter()
            batch = self.stream.next_batch()
            faults.fire("trainer.step")
            params, opt_state, err_buf, metrics = self.train_step(
                params, opt_state, err_buf, batch
            )
            # waits for the step, so that the next one may rewrite the step
            # program's host staging buffer
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == n:
                self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if self.cfg.ckpt_every and step % self.cfg.ckpt_every == 0:
                self.checkpoint(step, params, opt_state)
        self.wait_checkpoints()
        return params, opt_state, err_buf, step

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self, step: int, params, opt_state) -> None:
        """Coupled async checkpoint of (model, optimizer, data cursor).

        A device clone of every leaf is dispatched inline on the current
        stream; the background thread copies the clones to the host on a
        side stream that waits for them, and encodes them into DeltaFS.
        The closure keeps the clones alive until their writes finish."""
        t0 = time.perf_counter()
        with torch.no_grad():
            snap_params = tree_map(torch.clone, params)
            snap_opt = tree_map(torch.clone, opt_state)
        stream_state = self.stream.state()
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        record = {"step": step, "snapshot_ms": (time.perf_counter() - t0) * 1e3}

        def serialize():
            t1 = time.perf_counter()
            side = torch.cuda.Stream(device=self.device) if ready is not None else None
            nbytes = 0

            def host(leaf: torch.Tensor) -> torch.Tensor:
                if side is None:
                    return leaf
                with torch.cuda.stream(side):
                    side.wait_event(ready)
                    leaf.record_stream(side)
                    return leaf.to("cpu")

            try:
                with self._ckpt_lock:  # DeltaFS upper-layer writes must serialize
                    for prefix, tree in (("ckpt/params/", snap_params), ("ckpt/opt/", snap_opt)):
                        for path, leaf in tree_paths(tree):
                            nbytes += leaf.numel() * leaf.element_size()
                            self.fs.write(prefix + path, host(leaf))
                    for name, arr in stream_state.items():
                        nbytes += arr.nbytes
                        self.fs.write(f"ckpt/data/{name}", arr)
                    self.fs.write("ckpt/meta/step", np.asarray([step], np.int64))
                    config = self.fs.checkpoint()      # freeze: generation complete
                    self.ckpt_index[step] = config
                    self._prune()
            except Exception as exc:  # surfaced by wait_checkpoints
                self._ckpt_errors.append(exc)
                return
            record.update(write_s=time.perf_counter() - t1, bytes=nbytes)
            self.ckpt_log.append(record)

        th = threading.Thread(target=serialize, name=f"ckpt-{step}", daemon=True)
        th.start()
        self._ckpt_threads.append(th)

    def _prune(self) -> None:
        while len(self.ckpt_index) > self.cfg.keep_ckpts:
            oldest = min(self.ckpt_index)
            cfg = self.ckpt_index.pop(oldest)
            self.fs.release_config(cfg)

    def wait_checkpoints(self) -> None:
        """Wait for every background write; re-raise the first that failed."""
        for th in self._ckpt_threads:
            th.join()
        self._ckpt_threads.clear()
        if self._ckpt_errors:
            exc, self._ckpt_errors = self._ckpt_errors[0], []
            raise exc

    # --------------------------------------------------------------- restore
    def restore_latest(self, *, device: Any = None):
        """Rebuild (params, opt_state, stream) from the newest complete
        generation onto ``device`` (the trainer's by default); returns
        (params, opt_state, err_buf, step)."""
        self.wait_checkpoints()
        if not self.ckpt_index:
            raise FileNotFoundError("no checkpoints")
        step = max(self.ckpt_index)
        self.fs.switch(self.ckpt_index[step])
        dev = self.device if device is None else resolve_device(device)
        ref_params = self.model.param_shapes()
        params = self._read_tree("ckpt/params/", ref_params, dev)
        opt_state = self._read_tree("ckpt/opt/", adamw_init(ref_params, self.opt_cfg), dev)
        self.stream.restore(
            {
                "cursor": self.fs.read("ckpt/data/cursor"),
                "buf": self.fs.read("ckpt/data/buf"),
            }
        )
        err_buf = (error_feedback_init(params) if self.cfg.compress_grads
                   else torch.zeros((), dtype=torch.float32, device=dev))
        return params, opt_state, err_buf, int(self.fs.read("ckpt/meta/step")[0])

    def _read_tree(self, prefix: str, ref_tree, dev: torch.device):
        def read(path: str, ref: torch.Tensor) -> torch.Tensor:
            host = self.fs.read(prefix + path)
            if not isinstance(host, torch.Tensor):
                host = torch.from_numpy(host)
            return host.to(ref.dtype).reshape(ref.shape).to(dev)

        def walk(node, path: str):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
            return read(path[:-1], node)

        return walk(ref_tree, "")

    # ------------------------------------------------------- disk persistence
    def save_checkpoints(self, path: str) -> int:
        """Persist all retained checkpoint generations to one file (chunks
        deduplicated across generations), in the reference's format."""
        from ..core.persist import save_store

        self.wait_checkpoints()
        return save_store(self.fs, {str(s): c for s, c in self.ckpt_index.items()}, path)

    def load_checkpoints(self, path: str) -> None:
        from ..core.persist import load_store

        fs, configs = load_store(path)
        self.fs = fs
        self.ckpt_index = {int(s): c for s, c in configs.items()}

    # ---------------------------------------------------------------- elastic
    def reshard(self, tree, new_devices):
        """Move each leaf to the device given for it in ``new_devices`` (a
        tree of devices, or None to keep a leaf where it is): new tensors,
        as the reference's host-roundtrip reshard returns new arrays."""
        return tree_map(lambda leaf, d: leaf.to(d, copy=True) if d is not None else leaf,
                        tree, new_devices)
