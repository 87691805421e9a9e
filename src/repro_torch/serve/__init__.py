"""Serving runtime of the port: the paged copy-on-write KV pool, forkable
sessions, the prefill/decode engine and the continuous-batching scheduler
with its persistence plane (``SchedulerConfig.persist_path``: suspended
sessions saved through ``core.persist``, ``Scheduler.recover`` restarting
the warm pool from them)."""
from .engine import Engine, SamplingParams
from .kvcache import (
    CowCorruptionError,
    CowFaultError,
    PagePool,
    PagedSession,
    PoolStats,
    WritePlan,
)
from .scheduler import Scheduler, SchedulerConfig

__all__ = [
    "CowCorruptionError",
    "CowFaultError",
    "Engine",
    "PagePool",
    "PagedSession",
    "PoolStats",
    "SamplingParams",
    "Scheduler",
    "SchedulerConfig",
    "WritePlan",
]
