"""A run with the timed path broken underneath comes out not correct, once
for each fault the search cell can have: a decode step that leaves the
state unchanged, half of a batch left out, a token altered where it is
produced, a dump image altered, and only a node's last page of its image
altered.  (The cell runs on one card: there is no exchange between cards
to leave out.)  The control, the reference put in the program's place in
fp8, comes out not correct too."""
import json

import numpy as np
import pytest
import torch

from conftest import run_tiny


def _stale_state(monkeypatch):
    from repro_torch.models import model as M

    real = M._apply_attn_paged

    def unchanged(body, spec, q, k, v, mode, cache, lens, scale):
        if mode == "decode":          # the step's K/V writes land in copies
            cache = dict(cache, pk=cache["pk"].clone(), pv=cache["pv"].clone())
        return real(body, spec, q, k, v, mode, cache, lens, scale)

    monkeypatch.setattr(M, "_apply_attn_paged", unchanged)


def _half_batch(monkeypatch):
    from repro_torch.serve.engine import Engine

    real = Engine.step

    def half(self, sessions):
        keep = (len(sessions) + 1) // 2
        toks = real(self, sessions[:keep])
        for s in sessions[keep:]:       # left out: advanced without a step
            s.seq_len += 1
            s.tokens.append(toks[0])
        return toks + [toks[0]] * (len(sessions) - keep)

    monkeypatch.setattr(Engine, "step", half)


def _altered_token(monkeypatch):
    from repro_torch.serve.engine import Engine

    real = Engine._sample

    def altered(self, sess, logits):
        return (real(self, sess, logits) + 1) % len(logits)

    monkeypatch.setattr(Engine, "_sample", altered)


def _altered_image(monkeypatch):
    from repro_torch.serve.kvcache import PagedSession

    real = PagedSession.restore_from_payload

    def altered(pool, payload):
        payload = dict(payload)
        for key in [k for k in payload if k.startswith("kv/")]:
            payload[key] = torch.as_tensor(np.asarray(payload[key])).clone().flip(0)
        return real(pool, payload)

    monkeypatch.setattr(PagedSession, "restore_from_payload", staticmethod(altered))


def _altered_last_page(monkeypatch):
    """A wrong page in a node's own positions: the trunk's pages, most of
    the image, come back right."""
    from repro_torch.serve.kvcache import PagedSession

    real = PagedSession.restore_from_payload

    def altered(pool, payload):
        payload = dict(payload)
        for key in [k for k in payload if k.startswith("kv/")]:
            rows = torch.as_tensor(np.asarray(payload[key])).clone()
            rows[-1] = -rows[-1]
            payload[key] = rows
        return real(pool, payload)

    monkeypatch.setattr(PagedSession, "restore_from_payload", staticmethod(altered))


FAULTS = {"stale_state": _stale_state, "half_batch": _half_batch,
          "altered_token": _altered_token, "altered_image": _altered_image,
          "altered_last_page": _altered_last_page}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run_tiny("qwen3-tiny.search", seed=3_000_000_003, seconds=2.0)
    assert r["correct"] is False, r["checks"]


def test_a_wrong_last_page_is_not_lost_under_the_trunk(monkeypatch):
    """The slow node's own positions are held apart from its trunk's."""
    _altered_last_page(monkeypatch)
    r = run_tiny("qwen3-tiny.search", seed=3_000_000_003, seconds=2.0)
    n = r["info"]["numbers"]
    assert n["kv_rel_err_slow_own"] > n["kv_rel_err_slow"] > r["checks"]["kv_rel_err"]["limit"]
    assert r["checks"]["slow_not_bit_equal"]["value"] >= 1
    assert r["correct"] is False


@pytest.mark.parametrize("cell", ["qwen3-tiny.search", "qwen3-moe-tiny.search"])
def test_control_fails_the_limits(cell):
    r = run_tiny(cell, seed=17, control=True)
    n = r["info"]["numbers"]
    assert r["checks"]["logit_gap"]["value"] == n["control_logit_gap"]
    assert r["checks"]["kv_rel_err"]["value"] == n["control_kv_rel_err"]
    assert n["logit_gap"] <= r["checks"]["logit_gap"]["limit"]
    assert r["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen3-14b.search"])
def test_control_fails_the_limits_on_the_card(cell, card):
    """The control at the cell's own size: its readings pass a limit."""
    from bench.harness.main import run_cell, set_caches

    set_caches()
    r = run_cell(cell, 3_000_000_021, 10.0, False, card, control=True)
    n = r["info"]["numbers"]
    print(json.dumps({k: v for k, v in n.items() if k != "node_errors"}))
    assert n["logit_gap"] <= r["checks"]["logit_gap"]["limit"]
    assert n["kv_rel_err"] <= r["checks"]["kv_rel_err"]["limit"]
    assert r["correct"] is False
