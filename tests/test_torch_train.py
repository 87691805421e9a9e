"""The JAX package's ``tests/test_train.py`` on the port: optimizer math,
coupled checkpoint/restart, straggler watchdog, gradient compression,
elastic reshard (a device per leaf, where the reference gives a
``SingleDeviceSharding``), data-pipeline determinism.  All on the CPU at
``olmo-1b-tiny``; this file imports no JAX."""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.train import (
    DataConfig,
    OptimizerConfig,
    PackedStream,
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    decompress_grads,
    error_feedback_init,
)
from repro_torch.train.optim import tree_leaves, tree_map

torch.set_num_threads(1)


def _model(cfg):
    return Model(cfg, device="cpu")


# ------------------------------------------------------------------- optimizer
def test_adamw_converges_on_quadratic():
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(torch.square(w - target)), [w])
        params, opt, _ = adamw_update(params, {"w": g}, opt, cfg)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 2.0], atol=0.05)


def test_weight_decay_excludes_norms():
    cfg = OptimizerConfig(peak_lr=0.1, warmup_steps=0, total_steps=10, weight_decay=1.0)
    params = {"norm": {"scale": torch.ones(4)}, "w": torch.ones(4)}
    zeros = tree_map(torch.zeros_like, params)
    opt = adamw_init(params, cfg)
    p2, _, _ = adamw_update(params, zeros, opt, cfg)
    np.testing.assert_allclose(p2["norm"]["scale"].numpy(), params["norm"]["scale"].numpy())
    assert float(p2["w"][0]) < 1.0                                            # decayed


def test_compression_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy((rng.standard_normal(512) * 1e-3).astype(np.float32))}
    err = error_feedback_init(g)
    acc_plain = np.zeros(512)
    acc_comp = np.zeros(512)
    for _ in range(50):
        comp, err = compress_grads(g, err)
        acc_comp += decompress_grads(comp)["w"].numpy()
        acc_plain += g["w"].numpy()
    # with error feedback the accumulated compressed signal tracks the truth
    rel = np.linalg.norm(acc_comp - acc_plain) / np.linalg.norm(acc_plain)
    assert rel < 0.02, rel


# ---------------------------------------------------------------------- data
def test_stream_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4)
    s1 = PackedStream(cfg)
    for _ in range(3):
        s1.next_batch()
    state = s1.state()
    next_batch = s1.next_batch()
    s2 = PackedStream(cfg)
    s2.restore(state)
    resumed = s2.next_batch()
    np.testing.assert_array_equal(next_batch["tokens"], resumed["tokens"])


def test_stream_rank_sharding_disjoint():
    a = PackedStream(DataConfig(vocab_size=1000, seq_len=64, global_batch=4, n_ranks=2, rank=0))
    b = PackedStream(DataConfig(vocab_size=1000, seq_len=64, global_batch=4, n_ranks=2, rank=1))
    ba, bb = a.next_batch(), b.next_batch()
    assert ba["tokens"].shape == (2, 64)
    assert not np.array_equal(ba["tokens"], bb["tokens"])


def test_labels_masked_at_eod():
    cfg = DataConfig(vocab_size=100, seq_len=128, global_batch=2)
    batch = PackedStream(cfg).next_batch()
    eod_positions = batch["tokens"] == cfg.eod_id
    assert np.all(batch["labels"][eod_positions] == -1)


# -------------------------------------------------------------------- trainer
def _mk_trainer(model, **tcfg):
    return Trainer(
        model,
        OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=100),
        DataConfig(vocab_size=model.cfg.vocab_size, seq_len=32, global_batch=4),
        TrainerConfig(**{"steps": 12, "ckpt_every": 4, "log_every": 4, **tcfg}),
    )


@pytest.fixture(scope="module")
def trainer_rig():
    model = _model(get_config("olmo-1b-tiny"))
    return model, _mk_trainer(model)


def test_train_restart_resumes_identically(trainer_rig):
    """Crash at step N, restore, rerun → identical params as uninterrupted."""
    model, _ = trainer_rig
    # uninterrupted reference
    tr_ref = _mk_trainer(model)
    p, o, e = tr_ref.init_state(0)
    p_ref, *_ = tr_ref.run(p, o, e)
    # interrupted run: crash at step 10, restore from step-8 checkpoint
    tr = _mk_trainer(model)
    p, o, e = tr.init_state(0)
    with pytest.raises(RuntimeError):
        tr.run(p, o, e, fail_at=10)
    p2, o2, e2, step = tr.restore_latest()
    assert step == 8
    p_resumed, *_ = tr.run(p2, o2, e2, start_step=step)
    for a, b in zip(tree_leaves(p_ref), tree_leaves(p_resumed)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_checkpoint_storage_is_delta_encoded(trainer_rig):
    # the embedding is frozen between generations in this synthetic check:
    # write the same tree twice; second generation must add ~no physical bytes
    from repro_torch.core import DeltaFS

    fs = DeltaFS(chunk_bytes=1 << 12)
    tree = {f"w{i}": np.ones((256, 64), np.float32) * i for i in range(4)}
    for name, arr in tree.items():
        fs.write(f"ckpt/{name}", arr)
    fs.checkpoint()
    before = fs.store.stats.bytes_written
    for name, arr in tree.items():      # unchanged second generation
        fs.write(f"ckpt/{name}", arr)
    fs.checkpoint()
    assert fs.store.stats.bytes_written == before


def test_straggler_watchdog():
    events = []
    wd = StragglerWatchdog(factor=3.0, window=8, on_straggler=lambda s, r: events.append((s, r)))
    for i in range(8):
        wd.observe(i, 0.1)
    wd.observe(8, 0.95)                  # 9.5× median
    assert wd.flagged == [8]
    assert events and events[0][0] == 8
    wd.observe(9, 0.1)
    assert wd.flagged == [8]


def test_elastic_reshard_roundtrip(trainer_rig):
    """Host-chunk checkpoints restore under a different logical layout: one
    device per leaf (the port's single-device placement)."""
    _, tr = trainer_rig
    p, o, e = tr.init_state(1)
    devices = tree_map(lambda _: torch.device("cpu"), p)
    p2 = tr.reshard(p, devices)
    for a, b in zip(tree_leaves(p), tree_leaves(p2)):
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_microbatch_accumulation_matches_full_batch():
    cfg = get_config("olmo-1b-tiny")
    model = _model(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    mk = lambda mb: Trainer(
        model,
        OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=1e9),
        data_cfg,
        TrainerConfig(steps=2, ckpt_every=0, microbatches=mb),
    )
    t1, t2 = mk(1), mk(2)
    p1, o1, e1 = t1.init_state(3)
    p2, o2, e2 = t2.init_state(3)
    p1, *_ = t1.run(p1, o1, e1)
    p2, *_ = t2.run(p2, o2, e2)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
