"""Serving runtime of the port: the paged copy-on-write KV pool, forkable
sessions, the prefill/decode engine and the continuous-batching scheduler
(without its persistence plane, which waits for ``core.persist``)."""
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
