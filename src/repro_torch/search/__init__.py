"""Search strategies over DeltaState: MCTS (UCT) + Best-of-N / RL fan-out,
ported from the JAX package's ``search`` over this package's core and
serving runtime."""
from .archetypes import ARCHETYPES, ArchetypeSpec, SyntheticAgentTask, build_sandbox_state
from .decode_task import DecodeSearchTask
from .fanout import (
    FanoutResult,
    checkpoint_burst,
    decode_fanout,
    fork_n,
    fork_sandboxes,
    rollout_fanout,
    staleness,
    sync_gpu_occupation,
)
from .mcts import MCTS, AgentTask, MCTSConfig, MCTSStats

__all__ = [
    "ARCHETYPES", "ArchetypeSpec", "SyntheticAgentTask", "build_sandbox_state",
    "DecodeSearchTask",
    "FanoutResult", "checkpoint_burst", "decode_fanout", "fork_n", "fork_sandboxes",
    "rollout_fanout", "staleness", "sync_gpu_occupation",
    "MCTS", "AgentTask", "MCTSConfig", "MCTSStats",
]
