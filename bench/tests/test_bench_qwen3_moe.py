"""The qwen3_moe family and its two kernel metrics on the CPU: the
configuration's published numbers and its weight layout against the port's
``param_shapes``, ``decode_costs`` by hand, the ``search`` driver end to end
on a tiny dropless Qwen3-MoE (correct; not correct under the fp8 control or
with a planted fault in the decode MoE), and the readers of
``kernel.moe_decode_roofline`` and ``kernel.moe_decode_ms_per_step`` on
made-up runs and on runs without their spans."""
import copy

import pytest
import torch

from conftest import DATA

from bench.harness import registry

CELL = "qwen3-moe-dropless-tiny.search"
NEW = ("kernel.moe_decode_roofline", "kernel.moe_decode_ms_per_step")
MS = 1_000_000


def _published():
    return registry.load_json("configs", "qwen3-30b-a3b"), registry.load_module("models", "qwen3_moe")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


def test_config_keeps_the_published_numbers():
    cfg, _ = _published()
    assert cfg["reduced"] == [] and "capacity_factor" not in cfg
    assert cfg["source"] == "https://huggingface.co/Qwen/Qwen3-30B-A3B"
    for k, v in {"hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
                 "num_hidden_layers": 48, "num_attention_heads": 32, "num_key_value_heads": 4,
                 "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
                 "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
                 "vocab_size": 151936, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
                 "tie_word_embeddings": False, "hidden_act": "silu",
                 "torch_dtype": "bfloat16"}.items():
        assert cfg[k] == v, k
    for k in ("weights", "embed_std", "capacity_factor"):
        assert k in cfg["assumed"], k


def test_weight_layout_is_the_ports_at_published_widths():
    from repro_torch.models import Model

    cfg, fam = _published()
    model = Model(fam.port_config(cfg), device="cpu")
    want = _flat(model.param_shapes())
    got = {p: (tuple(shape), dtype) for p, (shape, dtype, _) in fam.weight_specs(cfg).items()}
    assert got == want
    assert model.param_count() == 30_532_122_624                 # 61.06 GB in bf16
    mc = model.cfg
    assert (mc.n_experts, mc.n_held_experts, mc.top_k, mc.moe_d_ff) == (128, 128, 8, 768)
    assert mc.moe_dropless and mc.moe_renormalize and mc.experts_held is None
    assert mc.stages[0].n_periods == 48 and mc.stages[0].period == (("attn", "moe"),)


def test_a_capacity_factor_is_refused():
    cfg, fam = _published()
    with pytest.raises(ValueError, match="dropless"):
        fam.port_config(dict(cfg, capacity_factor=1.25))


def test_decode_costs_by_hand():
    cfg, fam = _published()
    c = fam.decode_costs(cfg)
    d, f, L, V = 2048, 768, 48, 151936
    attn = d * 4096 + 2 * d * 512 + 4096 * d
    moe = d * 128 + 8 * 3 * d * f                                    # router, 8 routed experts
    assert c["matmul_flops_per_row"] == 2.0 * ((attn + moe) * L + V * d) == 6_083_313_664.0
    assert c["attn_flops_per_position"] == 4.0 * 32 * 128 * 48
    assert c["pa_bytes_per_position"] == 2.0 * 4 * 128 * 2 * 48    # 96 KiB a token
    assert c["moe_expert_bytes"] == 3 * 2048 * 768 * 2 == 9_437_184.0
    assert c["moe_row_bytes"] == 48 * (2 * 2048 * 2 + 8 * 8) == 396_288.0


def _spec():
    spec = copy.deepcopy(registry.benchmark_spec())
    spec["workloads"].append({"name": CELL, "config": "qwen3-moe-dropless-tiny",
                              "traffic": "search", "chips": 1, "why": "CPU test"})
    for m in spec["per_layer"]:
        if "qwen3-30b-a3b.search" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return spec


def _run(seed, trace=False, control=False):
    from bench.harness.main import run_cell, set_caches

    set_caches()
    return run_cell(CELL, seed, 2.0, trace, torch.device("cpu"), spec=_spec(), base=DATA,
                    control=control)


def test_driver_is_correct_on_a_dropless_moe():
    torch.set_num_threads(1)
    r = _run(3_100_000_517, trace=True)
    n = r["info"]["numbers"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) >= {"logit_gap", "kv_rel_err", "kv_rel_err_early",
                                "slow_not_bit_equal", "restored_tokens_differ",
                                "dumps_not_durable"}
    assert n["kv_rel_err"] < 1e-5 and n["kv_rel_err_early"] <= n["kv_rel_err"]
    assert n["early_layers"] == [0, 1] and n["slow_nodes"] >= 1
    assert [row[0] for row in n["kv_rel_err_by_layer"]] == [0, 1]
    assert all(row[2] is None for row in n["kv_rel_err_by_layer"])
    # no device trace on the CPU: the kernel metrics have nothing to read
    assert not set(NEW) & set(r["metrics"])
    assert r["metrics"]["sched.batch_width"]["value"] >= 1


def test_control_is_not_correct():
    torch.set_num_threads(1)
    r = _run(3_100_000_518, control=True)
    n = r["info"]["numbers"]
    assert not r["correct"]
    for name in ("logit_gap", "kv_rel_err", "kv_rel_err_early"):
        assert n["control_" + name] > r["checks"][name]["limit"], name
        assert n[name] <= r["checks"][name]["limit"], name
    assert all(row[2] > row[1] for row in n["kv_rel_err_by_layer"])


def test_a_decode_moe_that_drops_an_expert_is_not_correct(monkeypatch):
    """Planted in the program: the decode MoE leaves out each row's last
    routed expert.  The prefill is sound, every decoded position is not:
    layer 1's keys and values of those positions come through layer 0's
    faulty MoE, so ``kv_rel_err_early`` sees it."""
    import importlib

    kmod = importlib.import_module("repro_torch.kernels.moe_decode")
    torch.set_num_threads(1)
    plain = kmod.moe_decode_ref

    def drops_last(x, ids, gates, *rest):
        gates = gates.clone()
        gates[:, -1] = 0.0
        return plain(x, ids, gates, *rest)

    monkeypatch.setattr(kmod, "moe_decode_ref", drops_last)
    r = _run(3_100_000_519)
    n = r["info"]["numbers"]
    assert not r["correct"]
    assert n["kv_rel_err_early"] > r["checks"]["kv_rel_err_early"]["limit"]
    assert n["kv_rel_err_trunk"] < 1e-5                        # the prefill gathers, unharmed


# --------------------------------------------------- the readers, made up
@pytest.fixture
def tracer():
    from repro_torch import trace

    trace.reset()
    yield trace
    trace.configure(enabled=True, capacity=65536)
    trace.reset()


KERNEL = "void repro_torch::(anonymous namespace)::moe_gate_up_kernel<__nv_bfloat16>(...)"


def _made_up(trace, costs):
    """A window with three decode steps, two of them inside the traced
    interval [10, 100] ms, and 4 ms of the decode MoE's kernels in the
    trace: 3 ms of gate/up, 0.5 of down, 0.5 of combine."""
    run = trace.new_run()
    with trace.scope(run):
        trace.record("search.run", 0, 200 * MS)
        trace.record("engine.step", 0, 8 * MS, experts_read=99, rows=1)
        trace.record("engine.step", 20 * MS, 40 * MS, experts_read=100, rows=3)
        trace.record("engine.step", 50 * MS, 70 * MS, experts_read=300, rows=4)
        trace.record("engine.run", 21 * MS, 39 * MS)
    by_name = {KERNEL: 3e-3, "void repro_torch::(anonymous namespace)::moe_down_kernel<float>(...)": 5e-4,
               "moe_combine_kernel<__nv_bfloat16>": 5e-4, "paged_attention_kernel": 9.0}
    spans = [("engine.step", a * MS, b * MS, 0, ([5], 5)) for a, b in ((0, 8), (20, 40), (50, 70))]
    return {"trace": {"by_name": by_name, "span_ns": (10 * MS, 100 * MS)}, "spans": spans,
            "costs": costs, "nodes": 3}


def test_readers_on_a_made_up_run(tracer):
    from bench.harness.peaks import HBM_BYTES_PER_S

    roofline = registry.load_module("metrics", "kernel.moe_decode_roofline").read
    per_step = registry.load_module("metrics", "kernel.moe_decode_ms_per_step").read
    rec = _made_up(tracer, {"moe_expert_bytes": 1e7, "moe_row_bytes": 1e6})
    need = (100 + 300) * 1e7 + (3 + 4) * 1e6              # the family's costs
    assert roofline(rec) == pytest.approx(100.0 * need / HBM_BYTES_PER_S / 4e-3, rel=1e-12)
    assert per_step(rec) == pytest.approx(4e-3 * 1e3 / 2, rel=1e-12)
    # jamba's family gives no such costs: its cell's config does (16 MoE
    # layers of experts (4096, 14336) in bfloat16, top 2)
    jcfg = registry.load_json("configs", "jamba2-mini")
    rec = _made_up(tracer, registry.load_module("models", "jamba").decode_costs(jcfg))
    need = (100 + 300) * 3 * 4096 * 14336 * 2 + (3 + 4) * 16 * (2 * 4096 * 2 + 8 * 2)
    assert roofline(rec) == pytest.approx(100.0 * need / HBM_BYTES_PER_S / 4e-3, rel=1e-12)
    assert roofline(_made_up(tracer, {"matmul_flops_per_row": 1.0})) is None   # no cell's costs


@pytest.mark.parametrize("name", NEW)
def test_reader_is_none_without_its_spans_or_kernel(tracer, name, monkeypatch):
    read = registry.load_module("metrics", name).read
    costs = {"moe_expert_bytes": 1e7, "moe_row_bytes": 1e6}
    rec = _made_up(tracer, costs)
    assert read(dict(rec, trace=None)) is None                             # an untraced run
    no_kernel = dict(rec["trace"], by_name={"paged_attention_kernel": 1.0})
    assert read(dict(rec, trace=no_kernel)) is None                        # a program without it
    assert read(dict(rec, trace=dict(rec["trace"], span_ns=(0, 1)), spans=[])) is None
    tracer.reset()
    if name == "kernel.moe_decode_roofline":
        assert read(rec) is None                                           # no search run
        import sys

        import repro_torch

        monkeypatch.delattr(repro_torch, "trace")
        monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
        assert read(rec) is None                                           # no tracer at all


def test_steps_without_routed_ids_give_no_roofline(tracer):
    """A parent's program records no ``experts_read`` on its steps."""
    run = tracer.new_run()
    with tracer.scope(run):
        tracer.record("search.run", 0, 200 * MS)
        tracer.record("engine.step", 20 * MS, 40 * MS)
    read = registry.load_module("metrics", "kernel.moe_decode_roofline").read
    rec = {"trace": {"by_name": {KERNEL: 1e-3}, "span_ns": (10 * MS, 100 * MS)}, "spans": [],
           "costs": {}, "nodes": 1}
    assert read(rec) is None
