"""Serving runtime of the port: the paged copy-on-write KV pool, forkable
sessions and the prefill/decode engine.  The scheduler waits for the
persistence plane (``core.persist``) to be ported."""
from .engine import Engine, SamplingParams
from .kvcache import (
    CowCorruptionError,
    CowFaultError,
    PagePool,
    PagedSession,
    PoolStats,
    WritePlan,
)

__all__ = [
    "CowCorruptionError",
    "CowFaultError",
    "Engine",
    "PagePool",
    "PagedSession",
    "PoolStats",
    "SamplingParams",
    "WritePlan",
]
