"""DumpPolicy — one validated configuration surface for the DeltaCR dump path.

One frozen dataclass with validation and named presets holds every knob of
the dump path: the mode, retry/backoff, deadline, degraded-mode thresholds,
the stream and generation-cache configuration, and the fused kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

from .stream import StreamConfig

__all__ = ["DumpPolicy"]


_MODES = ("delta", "digest", "legacy")


@dataclass(frozen=True)
class DumpPolicy:
    """Frozen, validated dump-path configuration for one DeltaCR.

    Mode semantics (``mode``):

    * ``"delta"``  — the kernel pipeline for delta-capable states (the
      default), digest otherwise.
    * ``"digest"`` — per-chunk digest delta (hash once, 16-byte compare).
    * ``"legacy"`` — full serialize + byte compare (benchmark baseline).
    """

    mode: str = "delta"
    # -- self-healing dump knobs ---------------------------------------
    retries: int = 2
    retry_backoff_s: float = 0.005
    deadline_s: Optional[float] = None
    delta_fail_threshold: int = 3
    degraded_probe_every: int = 4
    # -- pipeline / streaming knobs ------------------------------------
    stream: bool = True
    stream_config: Optional[StreamConfig] = None
    capacity_frac: float = 0.5
    max_generations: int = 4
    # -- fused kernel (diff+compact+checksum in one kernel pass) -------
    fused_kernel: bool = True
    fused_verify: bool = True         # re-checksum fetched rows on host

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"unknown dump mode {self.mode!r}; expected one of {_MODES}")
        if self.retries < 0:
            raise ValueError("retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        if self.delta_fail_threshold < 1:
            raise ValueError("delta_fail_threshold must be >= 1")
        if self.degraded_probe_every < 1:
            raise ValueError("degraded_probe_every must be >= 1")
        if not (0.0 < self.capacity_frac <= 1.0):
            raise ValueError("capacity_frac must be in (0, 1]")
        if self.max_generations < 1:
            raise ValueError("max_generations must be >= 1")
        if self.stream_config is not None and not isinstance(self.stream_config, StreamConfig):
            raise TypeError("stream_config must be a StreamConfig or None")

    # ------------------------------------------------------------ presets
    @classmethod
    def latency(cls, **overrides: Any) -> "DumpPolicy":
        """Optimize dump wall time: one retry, a tight deadline so a stuck
        dump degrades fast, and host re-verification off (the fused
        kernel's checksums are still computed for parity tooling)."""
        base = cls(
            retries=1,
            retry_backoff_s=0.001,
            deadline_s=2.0,
            delta_fail_threshold=2,
            fused_verify=False,
        )
        return replace(base, **overrides) if overrides else base

    @classmethod
    def durability(cls, **overrides: Any) -> "DumpPolicy":
        """Optimize for landing: generous retries, no deadline, quick
        degradation to the minimum-moving-parts legacy path, and host
        checksum verification of every fused-kernel row."""
        base = cls(
            retries=4,
            retry_backoff_s=0.01,
            deadline_s=None,
            delta_fail_threshold=2,
            degraded_probe_every=6,
            fused_verify=True,
        )
        return replace(base, **overrides) if overrides else base

    def describe(self) -> Dict[str, Any]:
        """Plain-dict snapshot (health endpoints, persistence debug)."""
        d = dataclasses.asdict(self)
        if self.stream_config is not None:
            d["stream_config"] = dataclasses.asdict(self.stream_config)
        return d
