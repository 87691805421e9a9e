"""SWE-bench MCTS workload archetypes (paper §6.1, Table 2).

Ported from the JAX package's ``search/archetypes.py``.  The process heap
is a :class:`~repro_torch.core.deltacr.CowTensorState` on the card (or on
the CPU when asked), holding the same bytes as the reference's numpy heap:
every value is drawn from the same numpy ``Generator`` in the same order.

Four trajectory archetypes parameterize the synthetic agent task used by the
benchmarks; sizes follow the paper's characterization:

* **Django** — fat process: large in-memory heap, moderate repo, moderate edits
* **SymPy** — read-heavy exploration: big repo, many reads, few small writes
* **Scientific** — NumPy-heavy, process-dominated: large arrays mutated per step
* **Tools/small** — lightweight repos and heaps

Each action mutates a dirty fraction of the repo ("files" = fs tensors) and
of the process heap, mirrors a tool invocation (read-only actions are
LW-eligible), and optionally generates tokens through the serving engine.
All mutations are deterministic in the action seed — required for the
rollback-determinism tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.deltacr import CowTensorState, resolve_device
from ..core.deltafs import dtype_str
from ..core.state_manager import Sandbox

__all__ = ["ArchetypeSpec", "ARCHETYPES", "SyntheticAgentTask", "build_sandbox_state"]

@dataclasses.dataclass(frozen=True)
class ArchetypeSpec:
    name: str
    n_files: int                  # repo tensors
    file_kb: int                  # size of each repo tensor (KiB)
    heap_mb: float                # process heap (CowTensorState tensors)
    heap_arrays: int
    write_files_per_step: int     # files dirtied by a mutating action
    edit_fraction: float          # fraction of a touched file rewritten
    heap_dirty_fraction: float    # heap bytes dirtied per step
    readonly_prob: float          # probability an action is read-only
    tokens_per_step: int          # LLM tokens generated per action (engine mode)


ARCHETYPES: Dict[str, ArchetypeSpec] = {
    "django": ArchetypeSpec(
        "django", n_files=48, file_kb=64, heap_mb=24.0, heap_arrays=6,
        write_files_per_step=4, edit_fraction=0.05, heap_dirty_fraction=0.15,
        readonly_prob=0.45, tokens_per_step=24,
    ),
    "sympy": ArchetypeSpec(
        "sympy", n_files=96, file_kb=64, heap_mb=8.0, heap_arrays=4,
        write_files_per_step=1, edit_fraction=0.02, heap_dirty_fraction=0.05,
        readonly_prob=0.75, tokens_per_step=24,
    ),
    "scientific": ArchetypeSpec(
        "scientific", n_files=24, file_kb=128, heap_mb=32.0, heap_arrays=8,
        write_files_per_step=2, edit_fraction=0.08, heap_dirty_fraction=0.30,
        readonly_prob=0.50, tokens_per_step=24,
    ),
    "tools": ArchetypeSpec(
        "tools", n_files=12, file_kb=16, heap_mb=2.0, heap_arrays=2,
        write_files_per_step=1, edit_fraction=0.10, heap_dirty_fraction=0.10,
        readonly_prob=0.60, tokens_per_step=12,
    ),
}


def build_sandbox_state(
    spec: ArchetypeSpec, fs, *, seed: int = 0, device: Any = None
) -> CowTensorState:
    """Populate the DeltaFS repo and return the initial process state, a
    :class:`CowTensorState` on ``device`` (the card unless the caller passes
    ``device="cpu"``; raises without a card before touching ``fs``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    file_elems = spec.file_kb * 1024 // 4
    for i in range(spec.n_files):
        fs.write(f"repo/file_{i:04d}", rng.standard_normal(file_elems).astype(np.float32))
    heap_elems = int(spec.heap_mb * (1 << 20)) // 4
    per = max(heap_elems // spec.heap_arrays, 1)
    arrays = {
        f"heap_{j}": rng.standard_normal(per).astype(np.float32)
        for j in range(spec.heap_arrays)
    }
    arrays["cursor"] = np.zeros(4, np.int64)
    return CowTensorState(
        arrays,
        hot_keys=tuple(f"heap_{j}" for j in range(min(2, spec.heap_arrays))),
        device=dev,
    )


def last_writes(
    idx: np.ndarray, vals: np.ndarray, size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The (index, value) pairs that numpy's ``arr[idx] = vals`` leaves
    behind in an array of ``size`` elements: where an index repeats, its
    last occurrence wins.  A scatter of the result writes each element
    once, so its bytes do not depend on the order in which the device
    applies the writes."""
    pos = np.arange(len(idx))
    last = np.full(size, -1, np.int64)
    np.maximum.at(last, idx, pos)          # the last position writing each element
    keep = np.flatnonzero(last[idx] == pos)
    return idx[keep], vals[keep]


def _scatter(arr: torch.Tensor, idx: np.ndarray, vals: np.ndarray) -> None:
    """``arr[idx] = vals`` in place, on any device; ``idx`` holds no
    duplicates."""
    arr[torch.from_numpy(idx).to(arr.device)] = torch.from_numpy(vals).to(arr.device)


@dataclasses.dataclass(frozen=True)
class Action:
    seed: int
    readonly: bool


class SyntheticAgentTask:
    """AgentTask over (DeltaFS repo, heap state) with deterministic
    seed-driven mutations.  ``action_time_s`` models tool-execution latency;
    the LLM round-trip is modeled by the InferenceProxy in engine mode."""

    def __init__(
        self,
        spec: ArchetypeSpec,
        *,
        action_time_s: float = 0.0,
        proxy=None,
        terminal_depth: int = 10_000,
    ):
        self.spec = spec
        self.action_time_s = action_time_s
        self.proxy = proxy
        self.terminal_depth = terminal_depth

    # ------------------------------------------------------------ AgentTask
    def propose_actions(self, sandbox: Sandbox, rng_seed: int) -> Sequence[Action]:
        rng = np.random.default_rng(rng_seed)
        return [
            Action(
                seed=int(rng.integers(1 << 31)),
                readonly=bool(rng.random() < self.spec.readonly_prob),
            )
            for _ in range(4)
        ]

    def apply_action(self, sandbox: Sandbox, action: Action) -> None:
        if self.proxy is not None:
            # The LLM round-trip: checkpoint work overlaps this window.
            self.proxy.infer(sandbox.sandbox_id, {"tokens": self.spec.tokens_per_step})
        self._execute(sandbox, action)

    def replay_action(self, sandbox: Sandbox, action: Action) -> None:
        """LW-restore replay: re-execute the recorded tool action with the
        *cached* completion — no LLM round-trip (paper §6.3.3)."""
        self._execute(sandbox, action)

    def _execute(self, sandbox: Sandbox, action: Action) -> None:
        if self.action_time_s:
            import time as _t

            _t.sleep(self.action_time_s)
        rng = np.random.default_rng(action.seed)
        # heap mutation (process dimension) — happens for all actions
        state = sandbox.proc
        if isinstance(state, CowTensorState):
            frac = self.spec.heap_dirty_fraction
            for key in list(state.keys()):
                if key.startswith("heap_") and rng.random() < frac * 2:
                    arr = state.get(key)
                    size = arr.numel()
                    n = max(1, int(size * frac))
                    idx = rng.integers(0, size, size=n)
                    vals = rng.standard_normal(n).astype(dtype_str(arr.dtype))
                    # one write per element, through mutate (the CoW fault)
                    idx, vals = last_writes(idx, vals, size)
                    state.mutate(key, lambda a, i=idx, v=vals: _scatter(a, i, v))
            state.mutate("cursor", lambda c: c.__setitem__(0, c[0] + 1))
        if action.readonly:
            # read-only tool (grep/cat/ls): touch fs reads only
            keys = sandbox.fs.keys()
            for k in keys[: min(4, len(keys))]:
                sandbox.fs.read(k)
            return
        # mutating tool (edit/pip install/sed): dirty a few files partially
        file_ids = rng.integers(0, self.spec.n_files, size=self.spec.write_files_per_step)
        for fid in file_ids:
            key = f"repo/file_{int(fid):04d}"
            arr = sandbox.fs.read(key)
            n = max(1, int(arr.size * self.spec.edit_fraction))
            pos = int(rng.integers(0, max(arr.size - n, 1)))
            arr[pos : pos + n] = rng.standard_normal(n).astype(arr.dtype)
            sandbox.fs.write(key, arr)

    def evaluate(self, sandbox: Sandbox) -> float:
        """Value model: deterministic hash of the cursor + a test side effect
        (writes __pycache__-style junk that value-time isolation must undo)."""
        state = sandbox.proc
        cursor = int(state.get("cursor")[0]) if isinstance(state, CowTensorState) else 0
        # side effect: tests leave artifacts
        sandbox.fs.write("repo/__pycache__", np.full(256, cursor, np.int32))
        rng = np.random.default_rng(cursor + 17)
        return float(rng.random())

    def is_terminal(self, sandbox: Sandbox) -> bool:
        state = sandbox.proc
        if isinstance(state, CowTensorState):
            return int(state.get("cursor")[0]) >= self.terminal_depth
        return False

    def is_readonly(self, action: Action) -> bool:
        return action.readonly
