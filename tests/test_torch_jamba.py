"""Jamba2-Mini's block in the port, held to the benchmark's plain reference
(``bench/reference/jamba.py``) on the CPU in float32, and the reference
held to ``transformers``' ``JambaForCausalLM``.

- the reference against ``JambaForCausalLM`` (``use_mamba_kernels=False``)
  with every expert held, weights mapped across: logits within 1e-5;
- the port's ``Engine`` (prefill, batched decode, a fork, a delta dump, a
  slow restore) against the reference at a tiny Jamba2-Mini-shaped config
  holding 8 of 16 experts: logits, K/V and every state leaf within 1e-4
  (the bound the doubling scan's rounding was given against the JAX
  package);
- the share test: the held-expert outputs of two halves add up to the
  uncut layer;
- the router: top 2 over all 16 experts, weights as the softmax gave them,
  no assignment dropped at prefill or decode;
- a long mamba prefill in pieces is the one-call scan;
- each new option, off by default, leaves the tiny qwen3, qwen3-MoE and
  jamba forwards bit for bit what they were before the options existed.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

DATA = ROOT / "bench" / "tests" / "data"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _family():
    return registry.load_module("models", "jamba"), registry.load_module("reference", "jamba")


def _tiny(**over):
    cfg = registry.load_json("configs", "jamba-tiny", DATA)
    cfg.update(over)
    return cfg


# ------------------------------------------------------------ transformers
def _hf_state_dict(cfg, w):
    """``weights`` (the port's layout) as ``JambaForCausalLM``'s state dict."""
    fam, ref = _family()
    per = ref.period(cfg)
    P = len(per)
    sd = {"model.embed_tokens.weight": w["embed"], "lm_head.weight": w["lm_head"],
          "model.final_layernorm.weight": w["final_norm"]["scale"]}
    for i in range(cfg["num_hidden_layers"]):
        li, r = i % P, i // P
        mixer, ffn = per[li]
        m, g = w["stage0"][f"l{li}_s0_{mixer}"], w["stage0"][f"l{li}_s1_{ffn}"]
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = m["norm"]["scale"][r]
        sd[pre + "pre_ff_layernorm.weight"] = g["norm"]["scale"][r]
        b = m["body"]
        if mixer == "attn":
            d = cfg["hidden_size"]
            for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv")):
                sd[pre + f"self_attn.{name}.weight"] = b[key][r].reshape(d, -1).T
            sd[pre + "self_attn.o_proj.weight"] = b["wo"][r].reshape(-1, d).T
        else:
            mm = pre + "mamba."
            sd.update({mm + "in_proj.weight": b["w_in"][r].T,
                       mm + "conv1d.weight": b["conv_w"][r].T[:, None, :],
                       mm + "conv1d.bias": b["conv_b"][r],
                       mm + "x_proj.weight": b["w_x_dbc"][r].T,
                       mm + "dt_proj.weight": b["w_dt"][r].T,
                       mm + "dt_proj.bias": b["dt_bias"][r],
                       mm + "A_log": b["A_log"][r], mm + "D": b["D"][r],
                       mm + "out_proj.weight": b["w_out"][r].T,
                       mm + "dt_layernorm.weight": b["dt_norm"]["scale"][r],
                       mm + "b_layernorm.weight": b["b_norm"]["scale"][r],
                       mm + "c_layernorm.weight": b["c_norm"]["scale"][r]})
        fb = g["body"]
        if ffn == "moe":
            sd[pre + "feed_forward.router.weight"] = fb["router"][r].T
            for e in range(fb["w_gate"].shape[1]):
                ex = pre + f"feed_forward.experts.{e}."
                sd[ex + "gate_proj.weight"] = fb["w_gate"][r, e].T
                sd[ex + "up_proj.weight"] = fb["w_up"][r, e].T
                sd[ex + "down_proj.weight"] = fb["w_down"][r, e].T
        else:
            for name, key in (("gate_proj", "w_gate"), ("up_proj", "w_up"), ("down_proj", "w_down")):
                sd[pre + f"feed_forward.{name}.weight"] = fb[key][r].T
    return {k: v.contiguous() for k, v in sd.items()}


def test_reference_matches_transformers_jamba():
    transformers = pytest.importorskip("transformers")
    fam, ref = _family()
    cfg = _tiny(num_experts=4, router_experts=4, experts_held=[0, 4])
    w = fam.draw_weights(cfg, 13, torch.device("cpu"))
    hcfg = transformers.JambaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], rms_norm_eps=cfg["rms_norm_eps"],
        num_experts=4, num_experts_per_tok=2, expert_layer_period=2, expert_layer_offset=1,
        attn_layer_period=8, attn_layer_offset=4, use_mamba_kernels=False,
        mamba_d_state=cfg["mamba_d_state"], mamba_d_conv=cfg["mamba_d_conv"],
        mamba_expand=cfg["mamba_expand"], mamba_dt_rank=cfg["mamba_dt_rank"],
        mamba_conv_bias=True, mamba_proj_bias=False, tie_word_embeddings=False,
        attn_implementation="eager")
    hf = transformers.JambaForCausalLM(hcfg).eval()
    missing, unexpected = hf.load_state_dict(_hf_state_dict(cfg, w), strict=False)
    assert not unexpected and not missing
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg["vocab_size"], 21))
    with torch.no_grad():
        want = hf(toks[None], use_cache=False).logits[0]                 # (21, V)
    # the trunk's 13 tokens, then a node of 8 from the trunk's states
    p = ref.Pass(ref.Plain(cfg, w), toks[:13], [toks[13:]])
    for i in range(cfg["num_hidden_layers"]):
        p.layer(p.p.layer(i))
    last, (rows,) = p.logits()
    got = torch.cat([last[None], rows])
    assert torch.allclose(got, want[12:], atol=1e-5, rtol=0), (got - want[12:]).abs().max()


# ------------------------------------------------- the port's Engine and C/R
def test_engine_fork_dump_and_slow_restore_match_reference():
    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.serve import Engine, PagedSession, PagePool

    fam, ref = _family()
    cfg = _tiny()
    w = fam.draw_weights(cfg, 17, torch.device("cpu"))
    model = fam.build(cfg, w, torch.device("cpu"))
    assert model.cfg.experts_held == (0, 8) and model.cfg.n_experts == 16
    pool = PagePool(model.cfg, num_pages=64, page_size=4, max_pages_per_session=24, device="cpu")
    eng = Engine(model, pool)
    cr = DeltaCR(template_pool_size=2, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    S = 21
    prompt = np.random.default_rng(3).integers(0, cfg["vocab_size"], S).tolist()
    try:
        trunk = eng.new_session(prompt)
        first = np.asarray(trunk.extras["last_logits"])
        for _ in range(2):
            eng.step([trunk])
        kid = trunk.fork()
        kid.tokens[-1] = (kid.tokens[-1] + 1) % cfg["vocab_size"]
        for _ in range(3):
            eng.step([trunk, kid])                    # batched decode of a session and its fork
        cr.checkpoint(kid, 1, None)
        eng.step([kid])
        cr.checkpoint(kid, 2, 1)                      # a delta dump against its parent
        cr.wait_dumps()
        fast, path = cr.restore(2)
        assert path == "fast"
        assert cr.evict_template(2)
        slow, path = cr.restore(2)
        assert path == "slow" and slow.tokens == fast.tokens == kid.tokens
        for key in pool.state_keys:
            for leaf, t in fast.extras[key].items():
                assert torch.equal(slow.extras[key][leaf], t)

        sessions = [trunk, slow]
        suffixes = [torch.as_tensor(s.tokens[S:s.seq_len]) for s in sessions]
        p = ref.Pass(ref.Plain(cfg, w), torch.as_tensor(prompt), suffixes)
        per = ref.period(cfg)
        a = 0
        for i in range(cfg["num_hidden_layers"]):
            mixer, (t0, t1), nodes = p.layer(p.p.layer(i))
            for s, want in zip(sessions, nodes):
                if mixer == "attn":
                    pages = torch.as_tensor(s.table[: s.n_pages].astype(np.int64))
                    for kv, pools, w_all in (("k", pool.pools_k, torch.cat([t0, want[0]])),
                                             ("v", pool.pools_v, torch.cat([t1, want[1]]))):
                        got = pools["stage0"][f"l{i % len(per)}_s0_attn"][a][pages]
                        got = got.reshape(-1, *got.shape[2:])[: s.seq_len]
                        assert ref._rel(got, w_all) < TOL, (i, kv)
                else:
                    st = s.extras[f"stage0/l{i % len(per)}_s0_mamba"]
                    for leaf, want_leaf in zip(("conv", "ssm"), want):
                        assert ref._rel(st[leaf][i // len(per), 0], want_leaf) < TOL, (i, leaf)
            a += mixer == "attn"
        last, rows = p.logits()
        assert np.abs(first - last.numpy()).max() < TOL
        for s, r in zip(sessions, rows):
            assert np.abs(np.asarray(s.extras["last_logits"]) - r[-1].numpy()).max() < TOL
        for s in (fast, slow, kid, trunk):
            s.release()
    finally:
        cr.shutdown()


# ------------------------------------------------------------------ the MoE
def _moe_case(E=16, d=32, f=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    spec = L.MoESpec(d_model=d, d_ff=f, n_experts=E, top_k=2, renormalize=False, dropless=True)
    return spec, L.moe_init(gen, spec, torch.float32, "cpu")


def _share(params, lo, hi):
    return {"router": params["router"], **{k: params[k][lo:hi] for k in ("w_gate", "w_up", "w_down")}}


@pytest.mark.parametrize("B,S", [(1, 40), (6, 1)])        # a prefill (gathered), decode rows (slots)
def test_held_halves_add_up_to_the_uncut_layer(B, S):
    _, ref = _family()
    spec, params = _moe_case()
    x = torch.randn(B, S, spec.d_model, generator=torch.Generator().manual_seed(1))
    halves = []
    for lo, hi in ((0, 8), (8, 16)):
        out, _ = L.moe_apply(_share(params, lo, hi), dataclasses.replace(spec, held=(lo, hi)), x)
        halves.append(out)
    plain = ref.Plain({"num_experts_per_tok": 2, "hidden_size": spec.d_model, "num_attention_heads": 1,
                       "num_key_value_heads": 1, "rms_norm_eps": 1e-6, "attn_layer_period": 8,
                       "attn_layer_offset": 4, "expert_layer_period": 2, "expert_layer_offset": 1,
                       "experts_held": [0, 16]}, {})
    want = plain.moe({"router": params["router"],
                      "experts": (params["w_gate"], params["w_up"], params["w_down"])},
                     x.reshape(B * S, -1)).reshape(B, S, -1)
    assert torch.allclose(halves[0] + halves[1], want, atol=1e-5, rtol=0)
    whole, _ = L.moe_apply(params, spec, x)
    assert torch.allclose(whole, want, atol=1e-5, rtol=0)
    assert torch.count_nonzero(halves[0]) and torch.count_nonzero(halves[1])


def test_router_takes_top2_of_all_unrenormalized_and_drops_nothing():
    """Every token routed to experts 0 and 1: a capacity-bounded layer
    would drop all but the first 8 of a group; this one computes each, at
    prefill (24 tokens in a row) and decode (24 rows of one token), with
    the softmax's own two weights, which sum to less than one."""
    spec, params = _moe_case()
    params["router"].zero_()
    params["router"][:, 0] = 0.02
    params["router"][:, 1] = 0.01
    x = torch.ones(1, 24, spec.d_model)
    one, _ = L.moe_apply(params, spec, x[:, :1])
    gates, ids, _ = L._moe_gates(params, spec, x[:, :1])
    assert ids[0, 0].tolist() == [0, 1]
    probs = torch.softmax(x[0, 0] @ params["router"], -1)
    assert torch.allclose(gates[0, 0], probs[:2]) and float(gates.sum()) < 0.99
    h = torch.nn.functional.silu(x[0, 0] @ params["w_gate"][:2]) * (x[0, 0] @ params["w_up"][:2])
    want = sum(probs[e] * (h[e] @ params["w_down"][e]) for e in range(2))
    assert torch.allclose(one[0, 0], want, atol=1e-5)
    prefill, _ = L.moe_apply(params, spec, x)
    decode, _ = L.moe_apply(params, spec, x.reshape(24, 1, -1))
    assert torch.allclose(prefill[0], one[0].expand(24, -1), atol=1e-6)
    assert torch.allclose(decode[:, 0], one[0].expand(24, -1), atol=1e-6)
    capped, _ = L.moe_apply(params, dataclasses.replace(spec, dropless=False), x)
    assert torch.count_nonzero(capped[0, 8:]) == 0             # what dropless avoids


def test_held_share_leaves_absent_experts_out():
    """An assignment to an expert this chip does not hold adds nothing:
    with every token routed to experts 8 and 9, the share 0-7 gives zeros."""
    spec, params = _moe_case()
    params["router"].zero_()
    params["router"][:, 8] = 1.0
    params["router"][:, 9] = 0.5
    x = torch.ones(3, 5, spec.d_model)
    for held in ((0, 8), (8, 16)):
        out, _ = L.moe_apply(_share(params, *held), dataclasses.replace(spec, held=held), x)
        out1, _ = L.moe_apply(_share(params, *held), dataclasses.replace(spec, held=held),
                              x.reshape(15, 1, -1))
        assert (torch.count_nonzero(out) == 0) == (held == (0, 8))
        assert torch.allclose(out.reshape(15, 1, -1), out1, atol=1e-6)


# ------------------------------------------------------------------ mamba
def test_long_mamba_prefill_in_pieces_is_the_one_call_scan(monkeypatch):
    spec = L.MambaSpec(d_model=32, inner_norm=True)
    params = L.mamba_init(torch.Generator().manual_seed(1), spec, torch.float32, "cpu")
    x = torch.randn(2, 1000, 32, generator=torch.Generator().manual_seed(2))
    monkeypatch.setattr(L, "MAMBA_PIECE", 1024)
    y1, (c1, h1) = L.mamba_apply(params, spec, x)
    monkeypatch.setattr(L, "MAMBA_PIECE", 256)
    y2, (c2, h2) = L.mamba_apply(params, spec, x)
    assert torch.allclose(y1, y2, atol=1e-6) and torch.equal(c1, c2)
    assert torch.allclose(h1, h2, atol=1e-6)
    monkeypatch.setattr(L, "MAMBA_PIECE", 300)
    with pytest.raises(ValueError):
        L.mamba_apply(params, spec, x)


# ------------------------------------------------------ options off: unchanged
# sha256 of a seeded forward, a prefill and a decode step of each tiny model,
# computed by the code before these options existed (one CPU thread)
BEFORE = {
    "qwen3-14b-tiny": "5ed542eea1b1d179109b468efffba2d35c46dcdfc153d75364716133a4241303",
    "qwen3-moe-30b-a3b-tiny": "8c2607406e3fd551d2b8b7bf9997a3be7d27569970d47f1aa5115cce445e9235",
    "jamba-1.5-large-398b-tiny": "df25383535d0d87430fc687117a0dc23ca8b083f8292c5d47586f40b68a53be5",
}
OFF = {"rope": True, "moe_renormalize": True, "moe_dropless": False, "experts_held": None,
       "mamba_inner_norm": False}


@pytest.mark.parametrize("option", sorted(OFF))
@pytest.mark.parametrize("name", sorted(BEFORE))
def test_each_option_off_leaves_the_forward_bit_equal(name, option):
    cfg = get_config(name)
    assert getattr(cfg, option) == OFF[option]             # off by default
    cfg = dataclasses.replace(cfg, **{option: OFF[option]})
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
    assert dig.hexdigest() == BEFORE[name]
