"""The frozen plain reference held to the port at a tiny size on the CPU,
so that a fault of the reference shows before it costs chip time: the
logits of the dense and the MoE model after a prefill and after decode
steps, and the keys and values the port holds after a fork and after a
slow restore from a dump image."""
import numpy as np
import pytest
import torch

from conftest import DATA, run_tiny

TOL = 1e-4       # float32 on both sides; the programs differ in summation order only


def _setup(config):
    from bench.harness import registry

    cfg = registry.load_json("configs", config, DATA)
    fam = registry.load_module("models", "qwen3")
    ref = registry.load_module("reference", "qwen3")
    weights = fam.draw_weights(cfg, 11, torch.device("cpu"))
    return cfg, fam, ref, weights


@pytest.mark.parametrize("config", ["qwen3-tiny", "qwen3-moe-tiny"])
def test_logits_after_prefill_and_decode(config):
    from repro_torch.serve import Engine, PagePool

    cfg, fam, ref, weights = _setup(config)
    model = fam.build(cfg, weights, torch.device("cpu"))
    pool = PagePool(model.cfg, num_pages=64, page_size=4, max_pages_per_session=16,
                    device="cpu")
    eng = Engine(model, pool)
    prompt = np.random.default_rng(3).integers(0, cfg["vocab_size"], 21).tolist()
    sess = eng.new_session(prompt)
    got = [np.asarray(sess.extras["last_logits"])]
    for _ in range(5):
        eng.step([sess])
        got.append(np.asarray(sess.extras["last_logits"]))
    suffix = torch.as_tensor(sess.tokens[21:sess.seq_len])
    p = ref.Pass(ref.Plain(cfg, weights), torch.as_tensor(prompt), [suffix])
    for i in range(cfg["num_hidden_layers"]):
        p.layer(p.p.layer(i))
    last, (rows,) = p.logits()
    want = torch.cat([last[None], rows]).numpy()
    assert want.shape == (6, cfg["vocab_size"])
    assert np.abs(np.stack(got) - want).max() < TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("cell", ["qwen3-tiny.search", "qwen3-moe-tiny.search"])
def test_kv_after_fork_and_slow_restore(cell):
    r = run_tiny(cell, seed=2_999_999_999)
    n = r["info"]["numbers"]
    assert n["slow_nodes"] >= 1 and n["nodes_restored"] > n["slow_nodes"]
    assert n["nodes_judged"] >= n["nodes_restored"]
    assert n["kv_rel_err_trunk"] < TOL
    assert n["kv_rel_err_fast"] < TOL
    assert n["kv_rel_err_slow"] < TOL
    assert n["kv_rel_err_slow_own"] < TOL
    assert n["logit_gap"] < TOL
    assert r["checks"]["slow_not_bit_equal"]["value"] == 0
    assert r["checks"]["restored_tokens_differ"]["value"] == 0


def test_moe_capacity_drops_in_token_order():
    """An expert's slots go to its earliest assignments of the group: with
    capacity 8, the ninth token routed to one expert skips it."""
    cfg, _, ref, weights = _setup("qwen3-moe-tiny")
    plain = ref.Plain(cfg, weights)
    W = plain.layer(0)
    E = cfg["num_experts"]
    W["router"] = torch.zeros_like(W["router"])
    W["router"][:, 0] = 1.0
    W["router"][:, 1] = 0.5
    h = torch.ones(24, cfg["hidden_size"])
    out_group = plain.moe_ffn(W, h, group=24)   # C = 8: tokens 8.. lose both experts
    out_alone = plain.moe_ffn(W, h, group=1)
    assert torch.allclose(out_group[:8], out_alone[:8])
    assert torch.count_nonzero(out_group[8:]) == 0
    assert E > 2
