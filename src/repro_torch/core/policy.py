"""DumpPolicy — one validated configuration surface for the DeltaCR dump path.

Across PRs 1-7 the dump path grew ~10 loose ``DeltaCR`` constructor knobs
(mode, retry/backoff, deadline, degraded-mode thresholds, stream config...).
This module consolidates them into a single frozen dataclass with validation
and named presets, plus the *adaptive mode selection* machinery the policy
tunes: a per-lineage dirty-fraction predictor and a measured per-mode cost
model that picks ``delta`` / ``copy`` / ``digest`` / ``legacy`` per dump.

Selection model (the "auto" tentpole):

* **Hint** — states expose ``dirty_fraction_hint()`` (byte-weighted dirty
  keys for :class:`CowArrayState`, dirty page positions for
  ``PagedSession``).  The hint is an upper bound: a key counts as fully
  dirty after one element write.
* **Calibration** — an EWMA of measured ``actual/hint`` ratios per DeltaCR
  (one DeltaCR per sandbox lineage; the same pattern as PR 4's adaptive
  stream windowing) scales the hint into a prediction.  Without a hint the
  EWMA of recent measured fractions stands in.
* **Conservatism** — an *uncalibrated* prediction never overrides the
  default path: the first dumps of a lineage behave exactly like the
  pre-adaptive engine, and only observed evidence can flip later dumps to
  the copy path.
* **Cost model** — once both candidate modes have enough observed
  (dirty_frac, wall_ms) samples, a forgetting linear fit replaces the
  static crossover; predictions outside a fit's observed range fall back
  to the static rule rather than extrapolate.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

from .stream import StreamConfig

__all__ = [
    "DumpPolicy",
    "ModeSelector",
    "LEGACY_KNOB_MAP",
    "dirty_fraction_hint",
]


#: DeltaCR's pre-policy constructor keywords → DumpPolicy field names.
#: The deprecation shim folds these into a policy; the mapping doubles as
#: the acceptance-criteria checklist that every legacy knob is covered.
LEGACY_KNOB_MAP: Dict[str, str] = {
    "dump_mode": "mode",
    "capacity_frac": "capacity_frac",
    "max_generations": "max_generations",
    "stream": "stream",
    "stream_config": "stream_config",
    "dump_retries": "retries",
    "retry_backoff_s": "retry_backoff_s",
    "dump_deadline_s": "deadline_s",
    "delta_fail_threshold": "delta_fail_threshold",
    "degraded_probe_every": "degraded_probe_every",
}

_MODES = ("auto", "delta", "digest", "legacy")


@dataclass(frozen=True)
class DumpPolicy:
    """Frozen, validated dump-path configuration for one DeltaCR.

    Mode semantics (``mode``):

    * ``"auto"``   — adaptive per-dump selection (the default): predict the
      dirty fraction, pick the delta kernel path below the crossover and
      the straight-copy path above it; digest/legacy for states without
      ``delta_generation``.
    * ``"delta"``  — force the kernel pipeline for delta-capable states
      (digest otherwise); no adaptive switching.
    * ``"digest"`` — per-chunk digest delta (hash once, 16-byte compare).
    * ``"legacy"`` — full serialize + byte compare (benchmark baseline).
    """

    mode: str = "auto"
    # -- self-healing dump knobs (PR 6) --------------------------------
    retries: int = 2
    retry_backoff_s: float = 0.005
    deadline_s: Optional[float] = None
    delta_fail_threshold: int = 3
    degraded_probe_every: int = 4
    # -- pipeline / streaming knobs (PRs 1+3) --------------------------
    stream: bool = True
    stream_config: Optional[StreamConfig] = None
    capacity_frac: float = 0.5
    max_generations: int = 4
    # -- adaptive selection tunables (this PR's tentpole) --------------
    predictor: bool = True            # enable per-dump mode selection
    legacy_crossover: float = 0.45    # static crossover: pred >= this → copy
    frac_ewma_alpha: float = 0.3      # EWMA over measured dirty fractions
    hint_calibration_alpha: float = 0.5   # EWMA over actual/hint ratios
    cost_forget: float = 0.9          # forgetting factor of the cost fits
    min_cost_samples: int = 3         # samples per mode before fits engage
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
        if not (0.0 < self.legacy_crossover < 1.0):
            raise ValueError("legacy_crossover must be in (0, 1)")
        for name in ("frac_ewma_alpha", "hint_calibration_alpha"):
            a = getattr(self, name)
            if not (0.0 < a <= 1.0):
                raise ValueError(f"{name} must be in (0, 1]")
        if not (0.0 < self.cost_forget <= 1.0):
            raise ValueError("cost_forget must be in (0, 1]")
        if self.min_cost_samples < 1:
            raise ValueError("min_cost_samples must be >= 1")
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

    # ----------------------------------------------------- legacy shim
    @classmethod
    def from_legacy_kwargs(
        cls,
        legacy: Dict[str, Any],
        *,
        base: Optional["DumpPolicy"] = None,
        warn: bool = True,
        stacklevel: int = 3,
    ) -> "DumpPolicy":
        """Fold pre-policy DeltaCR keywords into a DumpPolicy.

        Unknown keywords raise ``TypeError`` (exactly like a misspelled
        constructor argument used to); known ones emit one
        ``DeprecationWarning`` naming the replacement fields."""
        unknown = sorted(set(legacy) - set(LEGACY_KNOB_MAP))
        if unknown:
            raise TypeError(
                f"DeltaCR() got unexpected keyword argument(s) {unknown}; "
                f"policy fields go through DeltaCR(policy=DumpPolicy(...))"
            )
        fields = {LEGACY_KNOB_MAP[k]: v for k, v in legacy.items()}
        if warn and legacy:
            renames = ", ".join(
                f"{k}→policy.{LEGACY_KNOB_MAP[k]}" for k in sorted(legacy)
            )
            warnings.warn(
                f"DeltaCR keyword(s) {sorted(legacy)} are deprecated; pass "
                f"DeltaCR(policy=DumpPolicy(...)) instead ({renames})",
                DeprecationWarning,
                stacklevel=stacklevel,
            )
        return replace(base, **fields) if base is not None else cls(**fields)

    def describe(self) -> Dict[str, Any]:
        """Plain-dict snapshot (health endpoints, persistence debug)."""
        d = dataclasses.asdict(self)
        if self.stream_config is not None:
            d["stream_config"] = dataclasses.asdict(self.stream_config)
        return d


# --------------------------------------------------------------------------
# Mode selection: dirty-fraction predictor + measured cost model
# --------------------------------------------------------------------------
class _LinFit:
    """wall_ms ≈ a + b·dirty_frac with exponential forgetting.

    A recursive least-squares fit over (x, y) samples where old samples
    decay by ``forget`` per new sample, so the model tracks the *current*
    state size and hardware rather than averaging over a lifetime."""

    __slots__ = ("n", "w", "sx", "sy", "sxx", "sxy", "xmin", "xmax")

    def __init__(self) -> None:
        self.n = 0
        self.w = self.sx = self.sy = self.sxx = self.sxy = 0.0
        self.xmin = float("inf")
        self.xmax = float("-inf")

    def add(self, x: float, y: float, forget: float) -> None:
        self.w *= forget
        self.sx *= forget
        self.sy *= forget
        self.sxx *= forget
        self.sxy *= forget
        self.w += 1.0
        self.sx += x
        self.sy += y
        self.sxx += x * x
        self.sxy += x * y
        self.n += 1
        self.xmin = min(self.xmin, x)
        self.xmax = max(self.xmax, x)

    def estimate(self, x: float) -> Optional[float]:
        if self.n == 0:
            return None
        denom = self.w * self.sxx - self.sx * self.sx
        if abs(denom) < 1e-12:          # degenerate: all samples at one x
            return self.sy / self.w
        b = (self.w * self.sxy - self.sx * self.sy) / denom
        a = (self.sy - b * self.sx) / self.w
        return a + b * x

    def covers(self, x: float, *, margin: float = 0.15) -> bool:
        """Is ``x`` within (a margin of) the observed sample range?  Linear
        fits extrapolate badly; outside the range the static rule wins."""
        return self.n > 0 and (self.xmin - margin) <= x <= (self.xmax + margin)


class ModeSelector:
    """Per-DeltaCR adaptive dump-mode selection (one instance per sandbox
    lineage; all methods run on the single dump-worker thread, so no lock —
    ``snapshot()`` reads from other threads are benign torn floats)."""

    def __init__(self, policy: DumpPolicy):
        self.policy = policy
        self._frac_ewma: Optional[float] = None     # measured dirty fractions
        self._ratio_ewma: Optional[float] = None    # measured actual/hint
        self._fits: Dict[str, _LinFit] = {}
        self.selections: Dict[str, int] = {}

    # ------------------------------------------------------------ predict
    def predict(self, hint: Optional[float]) -> Optional[float]:
        """Predicted dirty fraction in [0, 1], or None (no evidence)."""
        if hint is not None:
            hint = min(max(float(hint), 0.0), 1.0)
            if self._ratio_ewma is not None:
                return min(max(hint * self._ratio_ewma, 0.0), 1.0)
            return hint
        return self._frac_ewma

    def calibrated(self, hint: Optional[float]) -> bool:
        """A prediction is actionable only once real observations back it:
        a hint needs at least one actual/hint ratio sample, and a
        hint-less prediction needs the measured-fraction EWMA."""
        if hint is not None:
            return self._ratio_ewma is not None
        return self._frac_ewma is not None

    # ------------------------------------------------------------- choose
    def choose(
        self, *, delta_capable: bool, hint: Optional[float], pred: Optional[float]
    ) -> str:
        """Pick the dump mode for one dump: the O(delta) default below the
        crossover, the straight-copy path above it."""
        fast = "delta" if delta_capable else "digest"
        slow = "copy" if delta_capable else "legacy"
        if pred is None or not self.calibrated(hint):
            choice = fast
        else:
            choice = self._choose_measured(fast, slow, pred)
            if choice is None:
                choice = fast if pred < self.policy.legacy_crossover else slow
        self.selections[choice] = self.selections.get(choice, 0) + 1
        return choice

    def _choose_measured(self, fast: str, slow: str, pred: float) -> Optional[str]:
        """Measured crossover: compare fitted wall-time estimates when both
        modes have enough in-range samples; None defers to the static rule."""
        ff = self._fits.get(fast)
        fs = self._fits.get(slow)
        need = self.policy.min_cost_samples
        if (
            ff is None or fs is None
            or ff.n < need or fs.n < need
            or not ff.covers(pred) or not fs.covers(pred)
        ):
            return None
        ef, es = ff.estimate(pred), fs.estimate(pred)
        if ef is None or es is None:
            return None
        return fast if ef <= es else slow

    # ------------------------------------------------------------ observe
    def observe(
        self,
        *,
        mode: str,
        hint: Optional[float],
        actual: Optional[float],
        wall_ms: float,
        fell_back: bool = False,
    ) -> None:
        """Feed one completed dump back: update the lineage EWMAs and (for
        clean runs) the per-mode cost fit.  ``fell_back`` dumps paid for
        failed attempts, so their wall time would poison the cost model."""
        if actual is None:
            return
        actual = min(max(float(actual), 0.0), 1.0)
        a = self.policy.frac_ewma_alpha
        self._frac_ewma = (
            actual if self._frac_ewma is None else (1 - a) * self._frac_ewma + a * actual
        )
        if hint is not None and hint > 1e-9:
            ratio = min(actual / float(hint), 4.0)
            ca = self.policy.hint_calibration_alpha
            self._ratio_ewma = (
                ratio if self._ratio_ewma is None else (1 - ca) * self._ratio_ewma + ca * ratio
            )
        if not fell_back and wall_ms > 0:
            fit = self._fits.get(mode)
            if fit is None:
                fit = self._fits[mode] = _LinFit()
            fit.add(actual, float(wall_ms), self.policy.cost_forget)

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        return {
            "frac_ewma": self._frac_ewma,
            "hint_ratio_ewma": self._ratio_ewma,
            "static_crossover": self.policy.legacy_crossover,
            "selections": dict(self.selections),
            "cost_samples": {m: f.n for m, f in self._fits.items()},
        }


def dirty_fraction_hint(state: Any) -> Optional[float]:
    """Duck-typed dirty-fraction hint: states opt in by implementing
    ``dirty_fraction_hint() -> Optional[float]`` (None = unknown)."""
    fn = getattr(state, "dirty_fraction_hint", None)
    if fn is None:
        return None
    try:
        val = fn()
    except Exception:
        return None
    if val is None:
        return None
    return min(max(float(val), 0.0), 1.0)
