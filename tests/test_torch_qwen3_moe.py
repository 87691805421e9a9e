"""Qwen3-MoE as published (dropless, renormalized top-k) in the port, held
to the benchmark's plain reference (``bench/reference/qwen3_moe.py``) on
the CPU in float32, and the reference held to ``transformers``'
``Qwen3MoeForCausalLM``.

- the reference against ``Qwen3MoeForCausalLM``, weights mapped across:
  logits within 1e-5 (16 experts, top 4, renormalized);
- the port's ``Engine`` (prefill, batched decode at B = 1-4, a fork, a
  delta dump, a slow restore) against the reference: logits and K/V
  within 1e-4 (the port's float32 against the JAX package's bound);
- the decode MoE's plain version (``kernels.moe_decode``) against the
  all-experts ``bmm`` decode it replaced, held shares included;
- the decode step a CUDA graph captures, over a dropless MoE, makes no
  uncapturable call;
- capacity-bounded configs' forwards, prefill and decode bit for bit what
  they were before the decode MoE existed;
- ``moe.experts_read``: the distinct (layer, held expert) pairs of each
  step, counted where ``Engine.step`` records them;
- ``chip_smoke.py``'s phase 16 (the graphed dropless decode against the
  CPU) rehearsed on the CPU at a tiny size, and its gates.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness import registry  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.moe_decode import moe_decode_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from test_torch_engine_graphs import _CaptureBlockers, _leaves  # noqa: E402

DATA = ROOT / "bench" / "tests" / "data"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _family():
    return registry.load_module("models", "qwen3_moe"), registry.load_module("reference", "qwen3_moe")


def _tiny():
    return registry.load_json("configs", "qwen3-moe-dropless-tiny", DATA)


def _model(seed=17):
    fam, _ = _family()
    cfg = _tiny()
    w = fam.draw_weights(cfg, seed, torch.device("cpu"))
    return cfg, w, fam.build(cfg, w, torch.device("cpu"))


# ------------------------------------------------------------ transformers
def _hf_state_dict(cfg, w):
    """``weights`` (the port's layout) as ``Qwen3MoeForCausalLM``'s state dict."""
    d, H, KVH, Hd = (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
    a, m = w["stage0"]["l0_s0_attn"], w["stage0"]["l0_s1_moe"]
    sd = {"model.embed_tokens.weight": w["embed"], "lm_head.weight": w["lm_head"],
          "model.norm.weight": w["final_norm"]["scale"]}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        b = a["body"]
        sd[pre + "input_layernorm.weight"] = a["norm"]["scale"][i]
        sd[pre + "post_attention_layernorm.weight"] = m["norm"]["scale"][i]
        sd[pre + "self_attn.q_proj.weight"] = b["wq"][i].reshape(d, H * Hd).T
        sd[pre + "self_attn.k_proj.weight"] = b["wk"][i].reshape(d, KVH * Hd).T
        sd[pre + "self_attn.v_proj.weight"] = b["wv"][i].reshape(d, KVH * Hd).T
        sd[pre + "self_attn.o_proj.weight"] = b["wo"][i].reshape(H * Hd, d).T
        sd[pre + "self_attn.q_norm.weight"] = b["q_norm"]["scale"][i]
        sd[pre + "self_attn.k_norm.weight"] = b["k_norm"]["scale"][i]
        fb = m["body"]
        sd[pre + "mlp.gate.weight"] = fb["router"][i].T
        for e in range(cfg["num_experts"]):
            ex = pre + f"mlp.experts.{e}."
            sd[ex + "gate_proj.weight"] = fb["w_gate"][i, e].T
            sd[ex + "up_proj.weight"] = fb["w_up"][i, e].T
            sd[ex + "down_proj.weight"] = fb["w_down"][i, e].T
    return {k: v.contiguous() for k, v in sd.items()}


def test_reference_matches_transformers_qwen3_moe():
    transformers = pytest.importorskip("transformers")
    fam, ref = _family()
    cfg = _tiny()
    assert (cfg["num_experts"], cfg["num_experts_per_tok"], cfg["norm_topk_prob"]) == (16, 4, True)
    w = fam.draw_weights(cfg, 13, torch.device("cpu"))
    hcfg = transformers.Qwen3MoeConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        num_experts=cfg["num_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
        rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
        tie_word_embeddings=False, attn_implementation="eager")
    hf = transformers.Qwen3MoeForCausalLM(hcfg).eval()
    missing, unexpected = hf.load_state_dict(_hf_state_dict(cfg, w), strict=False)
    assert not unexpected and not missing
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg["vocab_size"], 21))
    with torch.no_grad():
        want = hf(toks[None], use_cache=False).logits[0]                 # (21, V)
    # the trunk's 13 tokens, then a node of 8 over the trunk's keys and values
    p = ref.Pass(ref.Plain(cfg, w), toks[:13], [toks[13:]])
    for i in range(cfg["num_hidden_layers"]):
        p.layer(p.p.layer(i))
    last, (rows,) = p.logits()
    got = torch.cat([last[None], rows])
    assert torch.allclose(got, want[12:], atol=1e-5, rtol=0), (got - want[12:]).abs().max()


# ------------------------------------------------- the port's Engine and C/R
def _kv(pool, sess, i):
    """K and V of layer ``i`` of ``sess``, every position."""
    pages = torch.as_tensor(sess.table[: sess.n_pages].astype(np.int64))
    out = []
    for pools in (pool.pools_k, pool.pools_v):
        t = pools["stage0"]["l0_s0_attn"][i][pages]
        out.append(t.reshape(-1, *t.shape[2:])[: sess.seq_len])
    return out


def test_engine_batched_decode_fork_dump_and_slow_restore_match_reference():
    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.serve import Engine, PagedSession, PagePool

    _, ref = _family()
    cfg, w, model = _model()
    assert model.cfg.moe_dropless and model.cfg.moe_renormalize
    pool = PagePool(model.cfg, num_pages=96, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    cr = DeltaCR(template_pool_size=2, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    S = 21
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg["vocab_size"], S).tolist()
    try:
        trunk = eng.new_session(prompt)
        first = np.asarray(trunk.extras["last_logits"])
        eng.step([trunk])                              # B = 1
        kids = [trunk.fork() for _ in range(3)]
        for k in kids:
            k.tokens[-1] = int(rng.integers(0, cfg["vocab_size"]))
        for B in (2, 3, 4):                            # batched decode of forks of one trunk
            eng.step(([trunk] + kids)[:B])
        kid = kids[0]
        cr.checkpoint(kid, 1, None)
        eng.step([kid])
        cr.checkpoint(kid, 2, 1)                      # a delta dump against its parent
        cr.wait_dumps()
        fast, path = cr.restore(2)
        assert path == "fast"
        assert cr.evict_template(2)
        slow, path = cr.restore(2)
        assert path == "slow" and slow.tokens == fast.tokens == kid.tokens
        for a, b in zip(_kv(pool, fast, 0) + _kv(pool, fast, 1), _kv(pool, slow, 0) + _kv(pool, slow, 1)):
            assert torch.equal(a, b)

        sessions = [trunk, slow] + kids[1:]
        suffixes = [torch.as_tensor(s.tokens[S:s.seq_len]) for s in sessions]
        p = ref.Pass(ref.Plain(cfg, w), torch.as_tensor(prompt), suffixes)
        for i in range(cfg["num_hidden_layers"]):
            (t0, t1), nodes = p.layer(p.p.layer(i))
            for s, (k_s, v_s) in zip(sessions, nodes):
                got_k, got_v = _kv(pool, s, i)
                assert ref._rel(got_k, torch.cat([t0, k_s])) < TOL, i
                assert ref._rel(got_v, torch.cat([t1, v_s])) < TOL, i
        last, rows = p.logits()
        assert np.abs(first - last.numpy()).max() < TOL
        for s, r in zip(sessions, rows):
            assert np.abs(np.asarray(s.extras["last_logits"]) - r[-1].numpy()).max() < TOL
        for s in [fast, slow, trunk] + kids:
            s.release()
    finally:
        cr.shutdown()


# ------------------------------------------------------------- the decode MoE
def _all_experts(params, spec, x):
    """The all-experts ``bmm`` decode the kernel replaced: one slot a row in
    every held expert, every expert run, the slots combined."""
    B = x.shape[0]
    gate_vals, expert_ids, _ = L._moe_gates(params, spec, x)
    lo, hi = spec.held_range
    flat_e = expert_ids.reshape(B, spec.top_k)
    here = (flat_e >= lo) & (flat_e < hi)
    flat_e = torch.where(here, flat_e - lo, torch.zeros_like(flat_e))
    flat_p = torch.zeros_like(flat_e)
    disp = L._moe_dispatch(x, flat_e, flat_p, hi - lo, 1)
    h = L._moe_expert_ffn(disp, params["w_gate"], params["w_up"], params["w_down"], spec.activation)
    return L._moe_combine(h, flat_e, flat_p, gate_vals, here, 1)


@pytest.mark.parametrize("held", [None, (0, 8), (8, 16)])
@pytest.mark.parametrize("B", [1, 3, 9])
def test_plain_decode_moe_is_the_all_experts_bmm(B, held):
    spec = L.MoESpec(d_model=32, d_ff=24, n_experts=16, top_k=4, dropless=True, held=held)
    params = L.moe_init(torch.Generator().manual_seed(B), spec, torch.float32, "cpu")
    x = torch.randn(B, 1, 32, generator=torch.Generator().manual_seed(2))
    ids = torch.full((B, 4), -1, dtype=torch.int32)
    got, _ = L.moe_apply(params, spec, x, ids)
    want = _all_experts(params, spec, x)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)
    gates, expert_ids, _ = L._moe_gates(params, spec, x)
    assert torch.equal(ids, expert_ids.reshape(B, 4).to(torch.int32))
    lo, hi = spec.held_range
    plain = moe_decode_ref(x[:, 0], ids, gates.reshape(B, 4), params["w_gate"], params["w_up"],
                           params["w_down"], (lo, hi))
    assert torch.equal(plain, got[:, 0])
    if held is not None:                              # an absent expert adds nothing
        out_of = ~((ids >= lo) & (ids < hi)).any(dim=1)
        if out_of.any():
            assert torch.count_nonzero(got[out_of]) == 0


def test_held_shares_of_the_decode_add_up_to_the_uncut_layer():
    spec = L.MoESpec(d_model=32, d_ff=24, n_experts=16, top_k=4, dropless=True)
    params = L.moe_init(torch.Generator().manual_seed(5), spec, torch.float32, "cpu")
    x = torch.randn(6, 1, 32, generator=torch.Generator().manual_seed(6))
    parts = []
    for lo, hi in ((0, 4), (4, 12), (12, 16)):
        share = {"router": params["router"], **{k: params[k][lo:hi] for k in ("w_gate", "w_up", "w_down")}}
        parts.append(L.moe_apply(share, dataclasses.replace(spec, held=(lo, hi)), x)[0])
    whole, _ = L.moe_apply(params, spec, x)
    assert torch.allclose(sum(parts), whole, atol=1e-6, rtol=0)


# -------------------------------------------------------------- capture safety
def test_dropless_decode_step_is_capture_safe():
    """The body a CUDA graph captures, ``decode_step`` over a program's
    static buffers at B = 3 with the routed ids written out, makes no
    uncapturable call, and returns the logits with the ids after them."""
    from repro_torch.serve import Engine, PagePool

    cfg, _, model = _model()
    pool = PagePool(model.cfg, num_pages=64, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    trunk = eng.new_session(list(range(3, 20)))
    kids = [trunk.fork() for _ in range(2)]
    for i, k in enumerate(kids):
        k.tokens[-1] = 5 + i
    eng.step([trunk] + kids)
    prog = eng._get_decode(3)
    assert len(prog.routes) == 1 and prog.routes[0].shape == (2, 3, 4)
    prog.stage([trunk] + kids)
    with _CaptureBlockers(_leaves(model.params) + _leaves(prog.cache) + [prog.tokens]) as mode:
        out = prog.body()
    assert mode.found == []
    V, K = cfg["vocab_size"], cfg["num_experts_per_tok"]
    assert out.shape == (3, V + 2 * K) and torch.isfinite(out).all()
    ids = out[:, V:].reshape(3, 2, K)
    assert torch.equal(ids, prog.routes[0].transpose(0, 1).float())
    assert ((ids >= 0) & (ids < 16)).all() and torch.equal(ids, ids.round())
    for s in [trunk] + kids:
        s.release()


# ------------------------------------------- capacity-bounded: unchanged
# sha256 of a seeded forward, a prefill and a decode step, computed by the
# code before the decode MoE kernel existed (tests/test_torch_jamba.py's
# digests, one CPU thread): the capacity-bounded layers and the jamba
# config with its dropless option off never reach the new path
BEFORE = {
    "qwen3-moe-30b-a3b-tiny": ("8c2607406e3fd551d2b8b7bf9997a3be7d27569970d47f1aa5115cce445e9235", {}),
    "jamba-1.5-large-398b-tiny": ("df25383535d0d87430fc687117a0dc23ca8b083f8292c5d47586f40b68a53be5",
                                  {"moe_dropless": False}),
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_capacity_bounded_forward_is_bit_equal(name):
    digest, over = BEFORE[name]
    cfg = dataclasses.replace(get_config(name), **over)
    assert not cfg.moe_dropless
    m = Model(cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    toks = torch.arange(24, dtype=torch.int64).reshape(2, 12) * 7 % 256
    with torch.no_grad():
        h, aux = m.forward(toks, remat=False)
        cache = m.init_cache(2, 16)
        lg, cache = m.prefill(toks, cache)
        lg2, _ = m.decode_step(toks[:, 0], cache)
    dig = hashlib.sha256()
    for t in (h, aux, lg, lg2):
        dig.update(t.detach().float().contiguous().numpy().tobytes())
    assert dig.hexdigest() == digest


# ------------------------------------------------------- moe.experts_read
def test_experts_read_is_counted_where_the_step_records_it():
    """Each ``engine.step`` span of a dropless MoE carries the step's
    distinct (layer, held expert) pairs and its rows;
    ``moe.experts_read`` sums them over the run.  A dense or
    capacity-bounded model records neither."""
    from repro_torch.serve import Engine, PagePool

    cfg, _, model = _model()
    pool = PagePool(model.cfg, num_pages=64, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    trunk = eng.new_session(list(range(3, 20)))
    kids = [trunk.fork() for _ in range(3)]
    for i, k in enumerate(kids):
        k.tokens[-1] = 40 + 9 * i
    captured = []
    orig = L._moe_gates

    def record(params, spec, x, aux=True):
        out = orig(params, spec, x, aux)
        captured.append(out[1].reshape(x.shape[0], -1))
        return out

    run = trace.new_run()
    L._moe_gates = record
    try:
        with trace.scope(run):
            for B in (1, 2, 4):
                captured.clear()
                eng.step(kids[:B] if B < 4 else [trunk] + kids)
                want = sum(len(set(c.flatten().tolist())) for c in captured)
                span = [s for s in trace.snapshot(run)["spans"] if s.name == "engine.step"][-1]
                assert span.attr["experts_read"] == want and span.attr["rows"] == B
                K, layers = 4, cfg["num_hidden_layers"]
                assert layers * K <= want <= layers * min(B * K, cfg["num_experts"])
                assert set(span.attr) == {"experts_read", "rows"}
    finally:
        L._moe_gates = orig
    spans = [s for s in trace.snapshot(run)["spans"] if s.name == "engine.step"]
    assert trace.snapshot(run)["counters"]["moe.experts_read"] == sum(s.attr["experts_read"] for s in spans)
    # a capacity-bounded MoE model: no ids, no count
    cap = Model(get_config("qwen3-moe-30b-a3b-tiny"), device="cpu")
    cap.init(torch.Generator().manual_seed(0))
    pool2 = PagePool(cap.cfg, num_pages=32, page_size=4, max_pages_per_session=8, device="cpu")
    eng2 = Engine(cap, pool2)
    s2 = eng2.new_session([1, 2, 3])
    run2 = trace.new_run()
    with trace.scope(run2):
        eng2.step([s2])
    snap = trace.snapshot(run2)
    assert "moe.experts_read" not in snap["counters"]
    assert all(not s.attr for s in snap["spans"] if s.name == "engine.step")
    assert eng2._get_decode(1).routes == []
    for s in [trunk, s2] + kids:
        s.release()


# ------------------------------------------------- chip_smoke's phase 16
def _phase16_cfg():
    from repro_torch.configs.base import Stage

    return dataclasses.replace(get_config("qwen3-moe-30b-a3b-tiny"), moe_dropless=True,
                               moe_renormalize=True, n_experts=16, top_k=4,
                               stages=(Stage(period=(("attn", "moe"),), n_periods=2),))


def test_phase16_rehearsal_on_the_cpu():
    """Both sides on the CPU: the same logits and routed experts at every
    width, K to B·K experts a layer, nothing launched or profiled."""
    import chip_smoke

    out = chip_smoke.run_dropless_path("cpu", cfg=_phase16_cfg(), prompt_len=9, steps=2)
    assert out["max_abs_logit_diff"] == 0.0 and out["decode_steps"] == 8
    assert out["launches"]["moe_decode"] == 0 and out["profile_b3"] is None
    assert sorted(out["experts_read_per_layer"]) == [1, 2, 3, 4]
    assert all(4 <= out["experts_read_per_layer"][B] <= min(4 * B, 16) for B in (1, 2, 3, 4))


def test_phase16_gates_catch_a_different_decode(monkeypatch):
    """A card side whose MoE output differs from the CPU's fails phase 16:
    the first call at B = 2 is the card's (each width's card step runs
    before the CPU's), and only it is altered."""
    import chip_smoke

    real, hit = L.moe_decode, []

    def off(x, *args, **kw):
        out = real(x, *args, **kw)
        if x.shape[0] == 2 and not hit:
            hit.append(True)
            return out + 1.0
        return out

    monkeypatch.setattr(L, "moe_decode", off)
    with pytest.raises(AssertionError, match="B=2"):
        chip_smoke.run_dropless_path("cpu", cfg=_phase16_cfg(), prompt_len=9, steps=1)
