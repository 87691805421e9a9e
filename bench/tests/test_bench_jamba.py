"""The jamba family, its ``search_state`` driver and the four recurrent-state
metrics on the CPU: the weight layout against the port's ``param_shapes``
at the published widths, ``decode_costs`` by hand, the driver end to end
at a tiny size (correct, and not correct under the fp8 control), the
readers on made-up spans and counters, and the program's spans and
counters where the metrics expect them."""
import copy
import sys

import numpy as np
import pytest
import torch

from conftest import DATA

from bench.harness import registry

CELL = "jamba-tiny.search_state"
NEW = ("dump.state_bytes_per_node", "dump.state_ms_per_node", "cr.state_upload_ms_per_node",
       "engine.state_ms_per_step")
MS = 1_000_000


def _published():
    return registry.load_json("configs", "jamba2-mini"), registry.load_module("models", "jamba")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


def test_weight_layout_is_the_ports_at_published_widths():
    from repro_torch.models import Model

    cfg, fam = _published()
    model = Model(fam.port_config(cfg), device="cpu")
    want = _flat(model.param_shapes())
    got = {p: (tuple(shape), dtype) for p, (shape, dtype, _) in fam.weight_specs(cfg).items()}
    assert got == want
    assert model.param_count() == 29_021_745_024                 # 58.04 GB in bf16
    mc = model.cfg
    assert (mc.n_experts, mc.n_held_experts, mc.top_k) == (16, 8, 2)
    assert not mc.rope and not mc.moe_renormalize and mc.moe_dropless and mc.mamba_inner_norm
    kinds = [k for layer in mc.stages[0].period for k in layer]
    assert mc.stages[0].n_periods == 4 and kinds.count("attn") == 1 and kinds.count("moe") == 4


def test_config_keeps_the_published_numbers():
    cfg, _ = _published()
    assert cfg["reduced"] == ["num_experts"] and cfg["num_experts"] == 8
    assert cfg["router_experts"] == 16 and cfg["experts_held"] == [0, 8]
    for k, v in {"hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
                 "num_attention_heads": 32, "num_key_value_heads": 8, "mamba_d_state": 16,
                 "mamba_d_conv": 4, "mamba_dt_rank": 256, "mamba_expand": 2,
                 "vocab_size": 65536, "num_experts_per_tok": 2}.items():
        assert cfg[k] == v, k


def test_decode_costs_by_hand():
    cfg, fam = _published()
    c = fam.decode_costs(cfg)
    d, di, f = 4096, 8192, 14336
    mamba = d * 2 * di + di * (256 + 32) + 256 * di + di * d         # in, x, dt, out projections
    attn = d * 4096 + 2 * d * 1024 + 4096 * d
    moe = d * 16 + 1 * 3 * d * f                                     # router; top 2 x 8/16 held
    weights = 28 * mamba + 4 * attn + 16 * 3 * d * f + 16 * moe + 65536 * d
    assert c["matmul_flops_per_row"] == 2.0 * weights == 18_035_507_200.0
    assert c["attn_flops_per_position"] == 4.0 * 32 * 128 * 4
    assert c["pa_bytes_per_position"] == 2.0 * 8 * 128 * 2 * 4       # 16 KiB a token
    assert c["pa_bytes_per_row"] == (2.0 * 32 * 128 * 2 + 4) * 4


def _spec():
    spec = copy.deepcopy(registry.benchmark_spec())
    spec["workloads"].append({"name": CELL, "config": "jamba-tiny", "traffic": "search",
                              "chips": 1, "why": "CPU test"})
    for m in spec["per_layer"]:
        if "jamba2-mini.search_32k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return spec


def _run(seed, trace=False, control=False):
    from bench.harness.main import run_cell, set_caches

    set_caches()
    return run_cell(CELL, seed, 2.0, trace, torch.device("cpu"), spec=_spec(), base=DATA,
                    control=control)


def test_driver_reads_states_back_and_is_correct():
    torch.set_num_threads(1)
    r = _run(3_100_000_417, trace=True)
    n = r["info"]["numbers"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) >= {"logit_gap", "kv_rel_err", "state_rel_err", "slow_not_bit_equal",
                                "restored_tokens_differ", "dumps_not_durable",
                                "no_slow_pair_compared"}
    assert n["state_rel_err_trunk"] < 1e-4 and n["state_rel_err_fast"] < 1e-4
    assert n["state_rel_err_slow"] < 1e-4 and n["slow_nodes"] >= 1
    assert n["state_rel_err_deep"] < 1e-4 and n["state_layers"] == [0, 1]
    # 7 mamba layers and 1 attention layer, each with its worst; no control
    assert [row[0] for row in n["state_rel_err_by_layer"]] == [0, 1, 2, 3, 5, 6, 7]
    assert [row[0] for row in n["kv_rel_err_by_layer"]] == [4]
    assert all(row[2] is None for row in n["state_rel_err_by_layer"])
    assert r["info"]["slow_pairs_compared"] >= 1
    assert r["checks"]["slow_not_bit_equal"]["value"] == 0
    assert r["checks"]["no_slow_pair_compared"]["value"] == 0
    m = r["metrics"]
    for name in NEW:
        assert m[name]["value"] > 0, name
    # 7 mamba sublayers, each a conv (3, 128) and an SSM (128, 16) state,
    # dumped once a node (the window's root and late dumps aside)
    per_node = 7 * (3 * 128 * 4 + 128 * 16 * 4)
    assert 0.5 * per_node <= m["dump.state_bytes_per_node"]["value"] <= 1.5 * per_node


def test_control_is_not_correct():
    torch.set_num_threads(1)
    r = _run(3_100_000_418, control=True)
    n = r["info"]["numbers"]
    assert not r["correct"]
    for name in ("logit_gap", "kv_rel_err", "state_rel_err"):
        assert n["control_" + name] > r["checks"][name]["limit"], name
        assert n[name] <= r["checks"][name]["limit"], name
    assert n["control_state_rel_err_deep"] >= n["control_state_rel_err"]
    assert all(row[2] > row[1] for row in n["state_rel_err_by_layer"] + n["kv_rel_err_by_layer"])


def test_reference_in_pieces_is_the_whole_pass():
    """The trunk's Mamba in pieces carrying its states, and the MLP a
    piece of rows at a time, give the one-piece pass's logits, K/V and
    states."""
    cfg = registry.load_json("configs", "jamba-tiny", DATA)
    weights = registry.load_module("models", "jamba").draw_weights(cfg, 7, torch.device("cpu"))
    prompt = torch.arange(100) % cfg["vocab_size"]
    suffixes = [torch.tensor([5, 6, 7]), torch.tensor([9])]

    def run(piece):
        ref = registry.load_module("reference", "jamba")
        ref.PIECE = piece
        pas = ref.Pass(ref.Plain(cfg, weights), prompt, suffixes)
        got = [pas.layer(pas.p.layer(i)) for i in range(cfg["num_hidden_layers"])]
        return got, pas.logits()

    (whole, (last_w, nodes_w)), (cut, (last_c, nodes_c)) = run(4096), run(32)
    assert torch.allclose(last_w, last_c, atol=1e-5)
    for a, b in zip(nodes_w, nodes_c):
        assert torch.allclose(a, b, atol=1e-5)
    for (mixer, trunk_w, node_w), (_, trunk_c, node_c) in zip(whole, cut):
        for a, b in zip(trunk_w, trunk_c):
            assert torch.allclose(a, b, atol=1e-5), mixer
        for pair_w, pair_c in zip(node_w, node_c):
            for a, b in zip(pair_w, pair_c):
                assert torch.allclose(a, b, atol=1e-5), mixer


def _cross(nodes):
    """Each fast-restored node given the state of the restored node whose
    tokens share the longest prefix with its own."""
    states = [n["kv"]["state"] for n in nodes]

    def shared(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))

    for n in nodes:
        if n["path"] == "fast":
            j = max((j for j, m in enumerate(nodes) if m is not n),
                    key=lambda j: shared(n["tail"], nodes[j]["tail"]))
            n["kv"]["state"] = states[j]


@pytest.mark.parametrize("fault", ["zeroed", "crossed"])
def test_a_state_restored_wrong_is_not_correct(monkeypatch, fault):
    """Planted in the check's read-back, after the window: ``zeroed``, each
    slow restore uploads its state leaves as zeros; ``crossed``, each fast
    node holds its nearest relative's state.  Either fails ``state_rel_err``
    though K/V are right, and a zeroed slow restore counts in
    ``slow_not_bit_equal``."""
    from bench.drivers import search
    from repro_torch.serve import kvcache

    torch.set_num_threads(1)
    collect, upload = search.SearchDriver.collect, kvcache._device_extra

    def faulty(self):
        if fault == "zeroed":
            monkeypatch.setattr(kvcache, "_device_extra",
                                lambda val, device: torch.zeros_like(upload(val, device)))
        try:
            collect(self)
        finally:
            monkeypatch.setattr(kvcache, "_device_extra", upload)
        if fault == "crossed":
            _cross([n for n in self.outputs["nodes"] if n.get("kv") is not None])

    monkeypatch.setattr(search.SearchDriver, "collect", faulty)
    r = _run(3_100_000_419)
    n = r["info"]["numbers"]
    assert not r["correct"]
    assert n["state_rel_err"] > r["checks"]["state_rel_err"]["limit"]
    assert n["kv_rel_err"] <= r["checks"]["kv_rel_err"]["limit"]
    if fault == "zeroed":
        assert n["state_rel_err_slow"] == pytest.approx(1.0)
        assert n["state_rel_err_fast"] < 1e-4
        assert r["checks"]["slow_not_bit_equal"]["value"] >= 1
    else:
        assert n["state_rel_err_fast"] > 1e-2
        assert r["checks"]["slow_not_bit_equal"]["value"] == 0


# --------------------------------------------------- the readers, made up
@pytest.fixture
def tracer():
    from repro_torch import trace

    trace.reset()
    yield trace
    trace.configure(enabled=True, capacity=65536)
    trace.reset()


def _made_up_run(trace):
    old = trace.new_run()
    with trace.scope(old):
        trace.record("search.run", 0, 10 * MS)
        trace.record("dump.state", 0, 9 * MS)
        trace.count("dump.state_bytes", 999)
    run = trace.new_run()
    with trace.scope(run):
        for name, a, b in (("engine.step", 0, 40), ("engine.step", 50, 80),
                           ("engine.state", 1, 2), ("engine.state", 30, 33),
                           ("engine.state", 51, 52), ("engine.state", 70, 72),
                           ("dump.state", 0, 20), ("dump.state", 30, 40),
                           ("cr.restore.state", 5, 8)):
            trace.record(name, a * MS, b * MS)
        trace.count("dump.state_bytes", 3000)
        trace.record("search.run", 0, 100 * MS)
    with trace.scope(None):
        trace.record("cr.restore.state", 0, 50 * MS)
    return run


READINGS = {"dump.state_bytes_per_node": 1000.0, "dump.state_ms_per_node": 10.0,
            "cr.state_upload_ms_per_node": 1.0, "engine.state_ms_per_step": 3.5}


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_made_up_run(tracer, name):
    _made_up_run(tracer)
    got = registry.load_module("metrics", name).read({"nodes": 3})
    assert got == pytest.approx(READINGS[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_zero_or_none_without_its_spans(tracer, name, monkeypatch):
    read = registry.load_module("metrics", name).read
    assert read({"nodes": 3}) is None                          # no search run
    with tracer.scope(tracer.new_run()):
        tracer.record("search.run", 0, MS)
    assert read({"nodes": 3}) == 0.0                           # a model without state
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read({"nodes": 3}) is None                          # a program without a tracer


# ------------------------------------------ the program's spans, where read
@pytest.mark.parametrize("config", ["jamba-tiny", "qwen3-tiny"])
def test_state_spans_and_counter_sit_where_the_metrics_read_them(tracer, config):
    from repro_torch.core import DeltaCR, DumpPolicy
    from repro_torch.serve import Engine, PagedSession, PagePool

    torch.set_num_threads(1)
    cfg = registry.load_json("configs", config, DATA)
    fam = registry.load_module("models", cfg["family"])
    model = fam.build(cfg, fam.draw_weights(cfg, 5, torch.device("cpu")), torch.device("cpu"))
    pool = PagePool(model.cfg, num_pages=64, page_size=4, max_pages_per_session=16, device="cpu")
    eng = Engine(model, pool)
    cr = DeltaCR(template_pool_size=2, async_warm=False, policy=DumpPolicy(mode="delta"),
                 restore_fn=lambda p: PagedSession.restore_from_payload(pool, p))
    leaves = 2 * len(pool.state_keys)
    try:
        sess = eng.new_session(list(range(9)))
        state_bytes = sum(t.nbytes for k in pool.state_keys for t in sess.extras[k].values())
        tracer.reset()
        run = tracer.new_run()
        with tracer.scope(run):
            eng.step([sess])
            kid = sess.fork()
            eng.step([sess, kid])
            cr.checkpoint(kid, 1, None)
            cr.wait_dumps()
            assert cr.evict_template(1)
            slow, path = cr.restore(1)
            assert path == "slow"
        snap = tracer.snapshot(run)                   # the dump's spans carry the caller's run
        names = [s.name for s in snap["spans"]]
        assert names.count("engine.state") == (4 if leaves else 0)       # stage + absorb a step
        assert names.count("dump.state") == leaves                        # one a state leaf
        assert names.count("cr.restore.state") == leaves
        assert snap["counters"].get("dump.state_bytes", 0) == state_bytes
        for s in (sess, kid, slow):
            s.release()
    finally:
        cr.shutdown()
