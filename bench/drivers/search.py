"""The ``search`` driver: agent tree search with checkpoint/rollback.

Set-up prefills the trunk session, captures the decode graphs of every
batch width the scheduler can form, checkpoints the trunk (its first,
whole dump) and runs a short warm-up search, whose nodes are then
reclaimed.  The window is one ``MCTS.run`` with the parallel driver under
a time budget: every node forks a selected checkpoint through the
``SandboxTree`` (a fast template fork or a slow restore from its dump
image), decodes an action through the ``Scheduler``'s shared batch, and
checkpoints with a delta dump.  Each call is timed from outside by
wrappers on the instances, which also keep each checkpoint's tokens.  The
measured time runs on after the search until the last dump of the window
has committed: a node counts once it is durable.  For the check every
leaf's served tokens are judged, and a sample of the nodes, drawn from the
seed with the deepest among them, is restored fast and slow and its keys
and values read back.

A driver module exports ``Driver(cell, cfg, family, weights, model, seed,
device, rec)`` with ``setup()``, ``window(seconds, trace) -> record``,
``collect()``, ``close()`` and ``check(reference, control) -> verdict``;
``bench/harness/main.py`` says what each returns.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, List

import numpy as np
import torch

from bench.harness.probes import Recorder, percentile, span_ms, wrap

TRACE_SECONDS = 10.0     # a traced run profiles the window's last seconds


def make_prompt(cell: Dict[str, Any], cfg: Dict[str, Any], seed: int) -> List[int]:
    """The trunk's tokens: ``trunk_tokens`` ids drawn uniformly over the
    vocabulary from ``seed``."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return rng.integers(0, cfg["vocab_size"], size=cell["traffic"]["trunk_tokens"]).tolist()


def _quartiles(values):
    """The 25th, 50th, 75th and 90th percentiles and the count."""
    return [percentile(values, q) for q in (25, 50, 75, 90)] + [len(values)]


class SearchDriver:
    def __init__(self, cell: Dict[str, Any], cfg: Dict[str, Any], family, weights,
                 model, seed: int, device: torch.device, rec: Recorder):
        self.t = cell["traffic"]
        self.sample = cell["check"]
        self.cfg = cfg
        self.family = family
        self.weights = weights
        self.model = model
        self.prompt = make_prompt(cell, cfg, seed)
        self.seed = int(seed)
        self.device = device
        self.rec = rec
        self.undo: List[Any] = []
        self.futures: List[Any] = []          # the window's dump futures
        self.cancelled = 0
        self.failed = 0
        self._tls = threading.local()

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from repro_torch.core import (DeltaCR, DeltaFS, DumpPolicy, Sandbox, SandboxTree,
                                      StateManager)
        from repro_torch.search import MCTS, DecodeSearchTask
        from repro_torch.serve import (Engine, PagedSession, PagePool, Scheduler,
                                       SchedulerConfig)

        t = self.t
        if len(self.prompt) != t["trunk_tokens"]:
            raise ValueError(f"prompt of {len(self.prompt)} tokens, the cell wants {t['trunk_tokens']}")
        self.pool = pool = PagePool(self.model.cfg, num_pages=t["pool_pages"],
                                    page_size=t["page_size"],
                                    max_pages_per_session=t["max_pages"], device=self.device)
        self.eng = eng = Engine(self.model, pool)
        self.trunk = eng.new_session(self.prompt)
        # the decode program of every width the scheduler can form: the
        # first step of a width captures its graph, the second replays it
        for width in range(1, t["max_batch"] + 1):
            forks = [self.trunk.fork() for _ in range(width)]
            eng.step(forks)
            eng.step(forks)
            for f in forks:
                f.release()
        fs = DeltaFS()
        self.cr = cr = DeltaCR(store=fs.store, policy=DumpPolicy(mode=t["dump_mode"]),
                               template_pool_size=t["templates"],
                               async_warm=t["async_warm"],
                               restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
        self.sm = sm = StateManager(Sandbox(fs, self.trunk.fork()), cr)
        fs.write("task/prompt.txt", np.asarray(self.prompt, np.int32))
        self.sched = Scheduler(eng, cr, SchedulerConfig(max_batch=t["max_batch"],
                                                        batch_window_ms=t["batch_window_ms"]))
        self.tree = SandboxTree(sm)
        self.task = DecodeSearchTask(eng, scheduler=self.sched, k_tokens=t["k_tokens"],
                                     width=t["width"])
        self._MCTS = MCTS
        # the trunk's checkpoint (its whole first dump), then a short search
        # from it, one node of which is restored from its image: every
        # kernel of the window has run once.  The search's nodes are then
        # reclaimed.
        warm = MCTS(sm, self.task, self._config(t["warmup_iterations"], None),
                    tree=self.tree, scheduler=self.sched)
        warm.run()
        cr.wait_dumps()
        root = next(c for c, d in warm.depth.items() if d == 0)
        kids = [n.ckpt_id for n in sm.live_nodes() if n.ckpt_id != root]
        if kids:
            cr.evict_template(kids[-1])
            state, _ = cr.restore(kids[-1])
            state.release()
        for ckpt in kids:
            sm.reclaim(ckpt)
        cr.wait_dumps()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _config(self, iterations, budget):
        from repro_torch.search import MCTSConfig

        t = self.t
        return MCTSConfig(iterations=iterations, parallel_leaves=t["parallel_leaves"],
                          expand_width=t["expand_width"], max_depth=t["max_depth"],
                          gc_every=t["gc_every"], seed=self.seed, dump=t["dump"],
                          time_budget_s=budget)

    # -------------------------------------------------------------- probes
    def _probe(self, traced: bool) -> None:
        rec, cr, tls = self.rec, self.cr, self._tls
        psz = self.t["page_size"]
        if traced:
            def step_info(args, kwargs, out):
                # after the step: each row attended to seq_len positions, read
                # through its table; a page that rows share counts once, with
                # the most positions any row reads of it
                lens = [s.seq_len for s in args[0]]
                valid: Dict[int, int] = {}
                for s, n in zip(args[0], lens):
                    pages = s.table[: -(-n // psz)]
                    for i, p in enumerate(pages.tolist()):
                        valid[p] = max(valid.get(p, 0), min(psz, n - i * psz))
                return lens, sum(valid.values())
        else:
            def step_info(args, kwargs, out):
                return [s.seq_len for s in args[0]], None
        pool = self.pool
        self.undo.append(wrap(self.eng, "step", rec, "engine.step", info=step_info,
                              before=lambda a, k: rec.sample("free_pages", pool.free_pages())))
        # the search's rollback and checkpoint: the tree's fork of a
        # selected node and its checkpoint of a leaf
        tree = self.tree
        self.undo.append(wrap(tree, "fork", rec, "rollback"))
        checkpoint = tree.checkpoint

        def timed_checkpoint(*args, **kwargs):
            tls.t0 = time.perf_counter_ns()
            try:
                out = checkpoint(*args, **kwargs)
            finally:
                t0, tls.t0 = tls.t0, None
            rec.span("checkpoint", t0, time.perf_counter_ns())
            return out

        tree.checkpoint = timed_checkpoint
        self.undo.append(lambda: setattr(tree, "checkpoint", checkpoint))

        cr_checkpoint = cr.checkpoint

        plen = len(self.prompt)

        def cr_ckpt(state, ckpt_id, *args, **kwargs):
            t0 = time.perf_counter_ns()
            cr_checkpoint(state, ckpt_id, *args, **kwargs)
            rec.span("cr.checkpoint", t0, time.perf_counter_ns())
            # the node's served tokens as the template holds them
            rec.sample("served", (ckpt_id, state.tokens[plen:], state.seq_len))
            fut = cr.dump_future(ckpt_id) if kwargs.get("dump", True) else None
            if fut is not None:
                start = getattr(tls, "t0", None) or t0
                self.futures.append(fut)
                fut.add_done_callback(lambda f, s=start: self._landed(f, s))

        cr.checkpoint = cr_ckpt
        self.undo.append(lambda: setattr(cr, "checkpoint", cr_checkpoint))
        self.undo.append(wrap(cr, "restore", rec, "cr.restore",
                              info=lambda a, k, out: out[0][1]))

    def _landed(self, fut, start_ns: int) -> None:
        """Dump-future callback: the image committed (or the dump failed)."""
        done = time.perf_counter_ns()
        if fut.cancelled():
            return
        exc = fut.exception()
        if exc is None:
            self.rec.sample("durable_ms", (done - start_ns) / 1e6)
            self.rec.sample("dump_image", fut.result())

    # -------------------------------------------------------------- window
    def window(self, seconds: float, trace) -> Dict[str, Any]:
        """One timed search of ``seconds``; ``trace`` (a DeviceTrace or None)
        profiles its last seconds."""
        pool, cr = self.pool, self.cr
        self._probe(traced=trace is not None)
        cow0 = pool.stats.cow_copies
        d2h0 = cr.pipeline.d2h_bytes
        mcts = self._MCTS(self.sm, self.task, self._config(10 ** 9, seconds),
                          tree=self.tree, scheduler=self.sched)
        self.rec.active = True
        if trace is None:
            st = mcts.run()
        else:
            out: Dict[str, Any] = {}

            def search():
                try:
                    out["st"] = mcts.run()
                except BaseException as exc:      # re-raised on the caller's thread
                    out["error"] = exc

            worker = threading.Thread(target=search, name="bench-search")
            worker.start()
            time.sleep(max(0.0, seconds - TRACE_SECONDS))
            with pool.lock:                  # no decode step in flight
                trace.start()
            worker.join()
            with pool.lock:
                trace.stop()
            if "error" in out:
                raise out["error"]
            st = out["st"]
        window_spans = list(self.rec.spans)
        t_drain = time.perf_counter()
        late = self._drain(self.sample["drain_timeout_s"])
        drain_s = time.perf_counter() - t_drain
        self.rec.active = False
        for undo in reversed(self.undo):
            undo()
        images = self.rec.samples.get("dump_image", [])
        paths = self.rec.infos("cr.restore")
        self.mcts = mcts
        self.record = {
            "window_s": st.wall_s,
            "drain_s": drain_s,
            "nodes": st.nodes,
            "batches": st.parallel_batches,
            "spans": window_spans,
            "durable_ms": list(self.rec.samples.get("durable_ms", [])),
            "drain_ms": [im.drain_ms for im in images],
            "d2h_bytes": cr.pipeline.d2h_bytes - d2h0,
            "cow_pages": pool.stats.cow_copies - cow0,
            "restores": {"fast": paths.count("fast"), "slow": paths.count("slow")},
            "checkpoints_dumped": len(self.futures),
            "dumps_cancelled": self.cancelled,
            "dumps_failed": self.failed,
            "dumps_late": late,
            "min_free_pages": min(self.rec.samples.get("free_pages", [self.pool.free_pages()])),
            "costs": self.family.decode_costs(self.cfg),
        }
        return self.record

    def _drain(self, timeout_s: float) -> int:
        """Wait for every dump of the window, ``timeout_s`` at most past the
        close.  Counts failures and cancellations (a dump of a node dropped
        before it landed); returns how many had not landed by then."""
        from repro_torch.core.stream import StreamCancelled

        deadline = time.monotonic() + timeout_s
        late = 0
        for fut in self.futures:
            try:
                fut.result(timeout=max(0.0, deadline - time.monotonic()))
            except FutureTimeout:
                late += 1
            except (CancelledError, StreamCancelled):
                self.cancelled += 1
            except Exception:               # a dump that failed: the node is not durable
                self.failed += 1
        return late

    # ---------------------------------------------------------- the check
    def collect(self) -> None:
        """Copy what the check compares to the host.  Every node the window
        checkpointed is judged by its served tokens; leaves suffice, since a
        node's tokens begin with its parent's.  A sample of the nodes drawn from
        the seed, with the deepest, is restored and its keys and values
        read back: restored fast where a template holds them, and a few
        restored slow from their dump images, each template evicted just
        after a fast fork of it was read, which the slow restore has to
        match bit for bit.  A restored node's tokens have to be those its
        checkpoint held."""
        cr, sm = self.cr, self.sm
        rng = np.random.default_rng(self.seed % (1 << 63))
        depth = self.mcts.depth
        served = {c: (list(tail), n) for c, tail, n in self.rec.samples.get("served", [])
                  if c in depth}
        live = [c for c in served if not sm.node(c).reclaimed]
        parents = {sm.node(c).parent_id for c in served}
        deepest = max(live, key=lambda c: (depth[c], -c))
        with_template = [c for c in live if cr.has_template(c)]
        # the slow few first from nodes whose template still holds them
        slow = [int(c) for c in rng.permutation(with_template)[: self.sample["slow_nodes"]]]
        rest = [c for c in with_template if c not in slow]
        fast = [deepest] if deepest in rest else []
        rest = [c for c in rest if c not in fast]
        fast += [int(c) for c in rng.permutation(rest)[: max(0, self.sample["fast_nodes"] - len(fast))]]
        if deepest not in fast and deepest not in slow:
            slow.append(deepest)
        plen = len(self.prompt)
        nodes, not_equal, differ = [], 0, 0
        for kind, ids in (("fast", fast), ("slow", slow)):
            for c in ids:
                twin = None
                if kind == "slow" and cr.has_template(c):
                    state, _ = cr.restore(c)
                    twin = self._kv(state, 0)
                    state.release()
                    cr.evict_template(c)
                state, path = cr.restore(c)
                try:
                    tail, seq_len = state.tokens[plen:], state.seq_len
                    kv = self._kv(state, plen if path == "fast" else 0)
                finally:
                    state.release()
                if twin is not None:
                    not_equal += not all(torch.equal(twin[k], kv[k]) for k in ("k", "v"))
                differ += (tail, seq_len) != served[c]
                nodes.append({"ckpt": c, "depth": depth[c], "path": path, "tail": tail,
                              "seq_len": seq_len, "kv": kv})
        picked = {n["ckpt"] for n in nodes}
        for c in sorted(served):
            if c not in parents and c not in picked:
                tail, seq_len = served[c]
                nodes.append({"ckpt": c, "depth": depth[c], "tail": tail, "seq_len": seq_len})
        self.outputs = {"prompt_len": plen, "trunk": self._kv(self.trunk, 0), "nodes": nodes,
                        "slow_not_bit_equal": not_equal, "restored_tokens_differ": differ}

    def check(self, reference, control: bool) -> Dict[str, Any]:
        """The reference's numbers, the exact checks of the restores and of
        the dumps, and what a run attempted and failed: the window's dumps,
        and those that failed or had not committed ``drain_timeout_s``
        after the close."""
        t, w, out = self.t, self.record, self.outputs
        numbers = reference.check(self.cfg, self.weights, self.prompt, out,
                                  k_tokens=t["k_tokens"], width=t["width"],
                                  device=self.device, control=control)
        late = w["dumps_late"] + w["dumps_failed"]
        checks = {"slow_not_bit_equal": {"value": out["slow_not_bit_equal"], "limit": 0},
                  "restored_tokens_differ": {"value": out["restored_tokens_differ"], "limit": 0},
                  "dumps_not_durable": {"value": late, "limit": 0}}
        info = {"drain_s": w["drain_s"], "nodes": w["nodes"], "numbers": numbers,
                "restores": w["restores"], "dumps_cancelled": w["dumps_cancelled"],
                "min_free_pages": w["min_free_pages"],
                "quartiles_ms": {name: _quartiles(span_ms(w, name))
                                 for name in ("checkpoint", "rollback", "engine.step")}}
        info["quartiles_ms"]["durable"] = _quartiles(w["durable_ms"])
        self.weights = self.outputs = None
        return {"numbers": numbers, "checks": checks, "attempted": w["checkpoints_dumped"],
                "failed": late, "info": info}

    def _kv(self, sess, lo: int) -> Dict[str, Any]:
        """K and V of positions [lo, seq_len) of ``sess``: {"k", "v"} host
        tensors (layers, positions, KVH, Hd) in the pool's dtype."""
        pool = self.pool
        psz = pool.page_size
        hi = sess.seq_len
        p0, p1 = lo // psz, -(-hi // psz)
        pages = torch.as_tensor(np.asarray(sess.table[p0:p1], np.int64), device=pool.device)
        out = {"lo": lo}
        (skey, tag), = pool.attn_tags          # one stack of attention layers
        for kv, pools in (("k", pool.pools_k), ("v", pool.pools_v)):
            t = pools[skey][tag].index_select(1, pages)                # (L, n, psz, KVH, Hd)
            t = t.reshape(t.shape[0], -1, t.shape[3], t.shape[4])
            out[kv] = t[:, lo - p0 * psz: hi - p0 * psz].cpu()
        return out

    # --------------------------------------------------------------- close
    def close(self) -> None:
        """Stop the workers and free the program's state on the device."""
        if getattr(self, "tree", None) is not None:
            self.tree.release_all()
        if getattr(self, "cr", None) is not None:
            self.cr.shutdown()
        for name in ("task", "sched", "tree", "sm", "cr", "trunk", "eng", "pool", "mcts",
                     "model"):
            setattr(self, name, None)


Driver = SearchDriver
