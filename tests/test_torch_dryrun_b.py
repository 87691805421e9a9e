"""The port's dry run on its own terms: (d) the ``meta`` trace counts the
FLOPs and collectives of the same step run on CPU tensors, for a tiny
dense and a tiny MoE architecture and every step kind; the microbatched
train and prefill steps compute what the whole batch does; (e) the
expert-parallel collectives' bytes in a record equal the capacity formula
that ``chip_smoke.py`` phase 12 holds; (f) the command line."""
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.dist import collectives
from repro_torch.launch import dryrun
from repro_torch.models.model import _moe_spec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b")
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
MESH = (2, 2)


def _tiny_cell(arch, kind, *, seq_len=16, batch=4):
    """The ``-tiny`` config of ``arch`` and its ``kind`` shape cut to size."""
    full = get_config(arch).shape(KINDS[kind])
    return get_config(arch + "-tiny"), dataclasses.replace(full, seq_len=seq_len,
                                                          global_batch=batch)


def _run(cfg, shape, device, *, mesh_shape=MESH, seed=0):
    """(FLOPs, ledger, outputs) of one step of the cell on ``device``."""
    mesh = dryrun.mesh_for(False, shape=mesh_shape, device=device)
    fn, args, _, _ = dryrun.build_step(cfg, shape, mesh)
    if device == "meta":
        real = dryrun._meta_args(args)
    else:
        real = dryrun.materialize(cfg, shape, args, device, seed=seed)
    collectives.reset_ledger()
    counter = FlopCounterMode(display=False)
    with dryrun.cell_context(cfg, shape, mesh), counter:
        out = fn(*real)
    return counter.get_total_flops(), collectives.ledger(), out


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_counts_what_the_cpu_step_does(arch, kind):
    cfg, shape = _tiny_cell(arch, kind)
    meta_flops, meta_ledger, _ = _run(cfg, shape, "meta")
    cpu_flops, cpu_ledger, _ = _run(cfg, shape, "cpu")
    assert meta_flops == cpu_flops > 0
    assert meta_ledger == cpu_ledger
    assert bool(meta_ledger["calls"]) == cfg.is_moe


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_microbatched_steps_count_and_compute_as_the_whole_batch(monkeypatch, kind):
    """Two microbatches: the ``meta`` count equals the CPU's, and the step
    gives the whole batch's loss, or its logits and cache rows."""
    cfg, shape = _tiny_cell("olmo-1b", kind)
    _, _, whole = _run(cfg, shape, "cpu", mesh_shape=(1, 1))
    monkeypatch.setitem(dryrun.MICROBATCH, (cfg.name, kind), 2)
    meta_flops, _, _ = _run(cfg, shape, "meta", mesh_shape=(1, 1))
    cpu_flops, _, split = _run(cfg, shape, "cpu", mesh_shape=(1, 1))
    assert meta_flops == cpu_flops
    if kind == "train":
        torch.testing.assert_close(split[2], whole[2], rtol=1e-5, atol=1e-6)
        return
    torch.testing.assert_close(split[0], whole[0], rtol=1e-5, atol=1e-5)
    for got, want in zip(dryrun.leaves(split[1]), dryrun.leaves(whole[1])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert split[1]["lens"].tolist() == [shape.seq_len] * shape.global_batch


def test_moe_decode_flops_by_sublayer():
    """qwen3-moe-30b-a3b ``decode_32k``, unsharded, B = 128 (the count
    ``PERF.md`` explains): every expert runs its capacity slots for every
    batch row, since each row is one token group of capacity 8, and the
    dense-cache attention reads all 32,768 positions.  By op and sublayer,
    per layer: the experts' three products over (E, B * C, D) x (D, F),
    the two attention products over (B * KVH, G, Hd) x (S), the combine
    (B, 1, K) x (K, D); and the projections, router and head in ``mm``."""
    cfg = get_config("qwen3-moe-30b-a3b")
    shape = cfg.shape("decode_32k")
    mesh = dryrun.mesh_for(False, shape=(1, 1))
    fn, args, _, _ = dryrun.build_step(cfg, shape, mesh)
    counter = FlopCounterMode(display=False)
    with counter:                            # no sharding context: the local MoE path
        fn(*dryrun._meta_args(args))
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    B, S, D, L = shape.global_batch, shape.seq_len, cfg.d_model, cfg.n_layers
    E, K, F, Hd = cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.head_dim
    KVH, G, H = cfg.n_kv_heads, cfg.group, cfg.n_heads
    C = _moe_spec(cfg).capacity(1)
    experts = L * 3 * 2 * E * (B * C) * D * F
    attention = L * 2 * 2 * (B * KVH) * G * Hd * S
    combine = L * 2 * B * K * D
    proj = L * 2 * B * D * (H * Hd + 2 * KVH * Hd + H * Hd + E) + 2 * B * D * cfg.vocab_size
    assert C == 8
    assert by_op == {"aten.bmm": experts + attention + combine, "aten.mm": proj}
    assert (experts, attention) == (59_373_627_899_904, 3_298_534_883_328)
    assert 72 < sum(by_op.values()) / (2 * cfg.active_param_count() * B) < 74


def _a2a_bytes(spec, ep, C, itemsize):
    # chip_smoke.py's phase 12 formula: (ep - 1)/ep of a rank's (E, C, D)
    # buffer each way
    return 2 * (ep - 1) * (spec.n_experts // ep) * C * spec.d_model * itemsize


@pytest.mark.parametrize("mesh_shape", ((1, 4), (2, 2), (2, 4)))
@pytest.mark.parametrize("kind", ("prefill", "decode", "train"))
def test_ep_all_to_all_bytes_equal_the_capacity_formula(kind, mesh_shape):
    """Per rank, each MoE layer's two all_to_alls over "model" move the
    formula's bytes; train's forward runs twice (its periods are
    recomputed in the backward pass), and the backward's own transposed
    collectives are not in the ledger."""
    cfg, shape = _tiny_cell("qwen3-moe-30b-a3b", kind, seq_len=8, batch=4)
    data, ep = mesh_shape
    rec = dryrun.trace_cell(cfg, shape, dryrun.mesh_for(False, shape=mesh_shape))
    spec = _moe_spec(cfg)
    tokens = (shape.global_batch // data) * (1 if kind == "decode" else shape.seq_len)
    if kind != "decode":                     # sequence parallelism over "model"
        tokens //= ep
    layers = sum(s.n_periods * sum(k == "moe" for layer in s.period for k in layer)
                 for s in cfg.stages)
    passes = 2 if kind == "train" else 1
    per_layer = _a2a_bytes(spec, ep, spec.capacity(tokens), 4)       # float32 tiny config
    coll = rec["collectives"]
    assert coll["bytes_by_op"]["all-to-all"] == passes * layers * per_layer
    assert coll["counts_by_op"]["all-to-all"] == passes * layers * 2
    assert coll["total_bytes"] == sum(coll["bytes_by_op"].values())
    assert coll["bytes_by_op"]["reduce-scatter"] == coll["bytes_by_op"]["collective-permute"] == 0
    assert (coll["bytes_by_op"]["all-gather"] > 0) == (data > 1)
    assert "lower bound" in coll["scope"]


def test_cli_writes_resumes_and_fails_on_an_error(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k", "--both-meshes",
                 "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in recs] == [("16x16", "skip"), ("2x16x16", "skip")]

    def broken(*a, **k):
        raise RuntimeError("no cell may run on resume")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k", "--both-meshes",
                 "--out", str(out), "--resume"])
    assert capsys.readouterr().out.count("[skip-done] olmo-1b|long_500k|") == 2
    assert len(json.loads(out.read_text())) == 2
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out", str(out),
                     "--resume"])
    assert exc.value.code == 1
    recs = json.loads(out.read_text())
    assert recs[-1]["status"] == "error" and "no cell may run" in recs[-1]["error"]
    assert "summary: 0 ok, 2 skip, 1 error" in capsys.readouterr().out


def test_cli_runs_a_cell_without_a_card(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a machine with no card
    visible writes a record with the reference's keys."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
                        "--shape", "decode_32k", "--out", str(out)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    [rec] = json.loads(out.read_text())
    assert set(rec) == {"arch", "shape", "mesh", "kind", "status", "lower_s", "compile_s",
                        "flops", "bytes_accessed", "collectives", "n_devices", "memory",
                        "param_count", "active_param_count", "microbatches"}
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] == 2_164_541_504
    assert "1 ok, 0 skip, 0 error" in r.stdout
