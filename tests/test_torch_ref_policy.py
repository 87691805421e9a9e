"""DumpPolicy: validation, presets, the legacy-keyword deprecation shim, and
policy plumbing through DeltaCR / apply_policy."""
import pytest

pytest.importorskip("torch")

import dataclasses
import inspect
import warnings

import numpy as np

from repro_torch.core import CowArrayState, DeltaCR, DumpPolicy
from repro_torch.core.policy import LEGACY_KNOB_MAP, ModeSelector, _LinFit
from repro_torch.core.stream import StreamConfig


# ---------------------------------------------------------------------------
# validation + immutability
# ---------------------------------------------------------------------------


def test_defaults_valid_and_frozen():
    p = DumpPolicy()
    assert p.mode == "auto" and p.predictor and p.fused_kernel
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.mode = "legacy"


@pytest.mark.parametrize(
    "kw",
    [
        {"mode": "turbo"},
        {"retries": -1},
        {"retry_backoff_s": -0.1},
        {"deadline_s": 0.0},
        {"delta_fail_threshold": 0},
        {"degraded_probe_every": 0},
        {"capacity_frac": 0.0},
        {"capacity_frac": 1.5},
        {"max_generations": 0},
        {"legacy_crossover": 0.0},
        {"legacy_crossover": 1.0},
        {"frac_ewma_alpha": 0.0},
        {"hint_calibration_alpha": 2.0},
        {"cost_forget": 0.0},
        {"min_cost_samples": 0},
    ],
)
def test_invalid_fields_raise(kw):
    with pytest.raises((ValueError, TypeError)):
        DumpPolicy(**kw)


def test_stream_config_type_checked():
    with pytest.raises(TypeError):
        DumpPolicy(stream_config={"window_bytes": 1})
    p = DumpPolicy(stream_config=StreamConfig(window_bytes=1 << 20))
    assert p.stream_config.window_bytes == 1 << 20


def test_presets_and_overrides():
    lat = DumpPolicy.latency()
    assert lat.retries == 1 and lat.deadline_s == 2.0 and not lat.fused_verify
    dur = DumpPolicy.durability()
    assert dur.retries == 4 and dur.deadline_s is None and dur.fused_verify
    custom = DumpPolicy.latency(mode="digest", retries=0)
    assert custom.mode == "digest" and custom.retries == 0
    assert custom.deadline_s == 2.0          # preset base retained
    with pytest.raises(ValueError):
        DumpPolicy.latency(mode="bogus")     # overrides still validate


def test_describe_expands_stream_config():
    d = DumpPolicy(stream_config=StreamConfig()).describe()
    assert d["mode"] == "auto"
    assert isinstance(d["stream_config"], dict)
    assert "window_bytes" in d["stream_config"]


# ---------------------------------------------------------------------------
# legacy-keyword shim
# ---------------------------------------------------------------------------


def test_legacy_map_covers_every_pre_policy_knob():
    """Acceptance criterion: every knob the pre-policy DeltaCR constructor
    took is representable through DumpPolicy."""
    expected = {
        "dump_mode", "capacity_frac", "max_generations", "stream",
        "stream_config", "dump_retries", "retry_backoff_s",
        "dump_deadline_s", "delta_fail_threshold", "degraded_probe_every",
    }
    assert set(LEGACY_KNOB_MAP) == expected
    fields = {f.name for f in dataclasses.fields(DumpPolicy)}
    assert set(LEGACY_KNOB_MAP.values()) <= fields
    # and DeltaCR no longer declares them as real parameters
    params = set(inspect.signature(DeltaCR.__init__).parameters)
    assert not (expected & params)


def test_from_legacy_kwargs_maps_and_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p = DumpPolicy.from_legacy_kwargs(
            {"dump_mode": "digest", "dump_retries": 5, "dump_deadline_s": 1.5}
        )
    assert p.mode == "digest" and p.retries == 5 and p.deadline_s == 1.5
    assert len(w) == 1 and issubclass(w[0].category, DeprecationWarning)
    assert "dump_mode" in str(w[0].message)


def test_from_legacy_kwargs_unknown_raises():
    with pytest.raises(TypeError, match="bogus"):
        DumpPolicy.from_legacy_kwargs({"bogus": 1})


def test_deltacr_legacy_keywords_warn_but_work():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cr = DeltaCR(dump_mode="legacy", dump_retries=1, retry_backoff_s=0.001)
    assert any(issubclass(wi.category, DeprecationWarning) for wi in w)
    assert cr.dump_mode == "legacy" and cr.dump_retries == 1
    assert cr.policy.mode == "legacy" and cr.pipeline is None
    # the shimmed constructor still dumps correctly
    s = CowArrayState({"a": np.arange(256, dtype=np.float32)})
    cr.checkpoint(s, 1, None)
    cr.wait_dumps()
    assert cr.dump_future(1).result().mode == "legacy"
    cr.shutdown()


def test_deltacr_rejects_policy_plus_legacy():
    with pytest.raises(TypeError, match="not both"):
        DeltaCR(policy=DumpPolicy(), dump_mode="auto")


def test_deltacr_rejects_unknown_keyword():
    with pytest.raises(TypeError, match="bogus_knob"):
        DeltaCR(bogus_knob=1)


def test_deltacr_policy_primary_constructor():
    cr = DeltaCR(policy=DumpPolicy.latency())
    try:
        assert cr.dump_retries == 1 and cr.dump_deadline_s == 2.0
        assert cr.pipeline is not None
        assert cr.pipeline.fused and not cr.pipeline.fused_verify
    finally:
        cr.shutdown()


def test_apply_policy_rebinds_knobs_and_selector():
    cr = DeltaCR()
    try:
        old_selector = cr.selector
        cr.apply_policy(DumpPolicy.durability(fused_kernel=False))
        assert cr.dump_retries == 4 and cr.delta_fail_threshold == 2
        assert cr.selector is not old_selector
        assert cr.pipeline is not None and not cr.pipeline.fused
        with pytest.raises(TypeError):
            cr.apply_policy({"mode": "auto"})
    finally:
        cr.shutdown()


# ---------------------------------------------------------------------------
# ModeSelector units
# ---------------------------------------------------------------------------


def test_selector_uncalibrated_never_overrides_default():
    sel = ModeSelector(DumpPolicy())
    # hint says 100% dirty, but no observation has backed the hint yet
    assert not sel.calibrated(1.0)
    assert sel.choose(delta_capable=True, hint=1.0, pred=sel.predict(1.0)) == "delta"
    assert sel.choose(delta_capable=False, hint=None, pred=sel.predict(None)) == "digest"


def test_selector_calibrates_and_flips_to_copy():
    sel = ModeSelector(DumpPolicy())
    sel.observe(mode="delta", hint=1.0, actual=0.9, wall_ms=5.0)
    assert sel.calibrated(1.0)
    pred = sel.predict(1.0)
    assert pred == pytest.approx(0.9)
    assert sel.choose(delta_capable=True, hint=1.0, pred=pred) == "copy"
    # a low hint scaled by the same ratio stays on the delta side
    low = sel.predict(0.1)
    assert sel.choose(delta_capable=True, hint=0.1, pred=low) == "delta"
    assert sel.snapshot()["selections"] == {"copy": 1, "delta": 1}


def test_selector_hint_ratio_scales_down():
    """Hints are upper bounds: observed actual/hint < 1 pulls predictions
    below the raw hint (whole-key dirty hints vs slice writes)."""
    sel = ModeSelector(DumpPolicy())
    for _ in range(4):
        sel.observe(mode="delta", hint=1.0, actual=0.15, wall_ms=3.0)
    pred = sel.predict(1.0)
    assert pred == pytest.approx(0.15, abs=0.02)
    assert sel.choose(delta_capable=True, hint=1.0, pred=pred) == "delta"


def test_selector_fell_back_skips_cost_fit():
    sel = ModeSelector(DumpPolicy())
    sel.observe(mode="legacy", hint=0.5, actual=0.5, wall_ms=500.0, fell_back=True)
    assert sel.snapshot()["cost_samples"] == {}
    assert sel.snapshot()["frac_ewma"] == pytest.approx(0.5)  # EWMA still fed


def test_selector_measured_crossover_beats_static():
    """With enough in-range cost samples, fitted wall times replace the
    static crossover — even when the static rule would pick the other mode."""
    sel = ModeSelector(DumpPolicy(min_cost_samples=3))
    # copy is *slower* than delta everywhere (e.g. huge clean-key savings):
    # at pred=0.6 the static rule says copy, the measurements say delta
    for f in (0.5, 0.6, 0.7):
        sel.observe(mode="delta", hint=f, actual=f, wall_ms=10.0 + 5.0 * f)
        sel.observe(mode="copy", hint=f, actual=f, wall_ms=40.0 + 5.0 * f)
    assert sel.choose(delta_capable=True, hint=0.6, pred=0.6) == "delta"
    # outside the fits' observed range the static rule still wins
    assert sel.choose(delta_capable=True, hint=0.05, pred=0.05) == "delta"


def test_linfit_forgetting_tracks_regime_change():
    fit = _LinFit()
    for _ in range(20):
        fit.add(0.5, 100.0, forget=0.5)   # old regime: 100ms
    for _ in range(20):
        fit.add(0.5, 10.0, forget=0.5)    # new regime: 10ms
    est = fit.estimate(0.5)
    assert est == pytest.approx(10.0, rel=0.01)
    assert fit.covers(0.5) and not fit.covers(0.9)
