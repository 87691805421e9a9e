"""DumpPolicy: validation, presets, the modes the port keeps, and policy
plumbing through DeltaCR / apply_policy."""
import pytest

pytest.importorskip("torch")

import dataclasses
import inspect

from repro_torch.core import DeltaCR, DumpPolicy
from repro_torch.core.stream import StreamConfig


# ---------------------------------------------------------------------------
# validation + immutability
# ---------------------------------------------------------------------------


def test_defaults_valid_and_frozen():
    p = DumpPolicy()
    assert p.mode == "delta" and p.fused_kernel
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
    assert d["mode"] == "delta"
    assert isinstance(d["stream_config"], dict)
    assert "window_bytes" in d["stream_config"]


# ---------------------------------------------------------------------------
# the port's modes: no adaptive selection, no straight copy, no loose keywords
# ---------------------------------------------------------------------------


def test_default_policy_is_delta():
    assert DumpPolicy() == DumpPolicy(mode="delta")
    cr = DeltaCR()
    try:
        assert cr.policy == DumpPolicy(mode="delta")
        assert cr.pipeline is not None
    finally:
        cr.shutdown()


@pytest.mark.parametrize("mode", ["auto", "copy"])
def test_removed_modes_rejected(mode):
    """The port has neither the reference's adaptive ``auto`` nor its
    straight-copy mode."""
    with pytest.raises(ValueError, match="unknown dump mode"):
        DumpPolicy(mode=mode)


#: the ten DeltaCR keywords the reference still folds into a policy
FORMER_KEYWORDS = {
    "dump_mode": "legacy", "capacity_frac": 0.5, "max_generations": 4,
    "stream": True, "stream_config": None, "dump_retries": 1,
    "retry_backoff_s": 0.0, "dump_deadline_s": 1.0, "delta_fail_threshold": 1,
    "degraded_probe_every": 2,
}


@pytest.mark.parametrize("keyword", sorted(FORMER_KEYWORDS))
def test_deltacr_rejects_unknown_keyword(keyword):
    """A loose dump keyword is Python's own TypeError: policy fields go
    through ``DeltaCR(policy=DumpPolicy(...))``."""
    assert keyword not in inspect.signature(DeltaCR.__init__).parameters
    with pytest.raises(TypeError, match=keyword):
        DeltaCR(**{keyword: FORMER_KEYWORDS[keyword]})


def test_deltacr_policy_primary_constructor():
    cr = DeltaCR(policy=DumpPolicy.latency())
    try:
        assert cr.policy.retries == 1 and cr.policy.deadline_s == 2.0
        assert cr.pipeline is not None
        assert cr.pipeline.fused and not cr.pipeline.fused_verify
    finally:
        cr.shutdown()


def test_apply_policy_rebinds_knobs():
    cr = DeltaCR()
    try:
        cr.apply_policy(DumpPolicy.durability(fused_kernel=False))
        assert cr.policy.retries == 4 and cr.policy.delta_fail_threshold == 2
        assert cr.pipeline is not None and not cr.pipeline.fused
        with pytest.raises(TypeError):
            cr.apply_policy({"mode": "delta"})
    finally:
        cr.shutdown()
