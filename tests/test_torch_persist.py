"""Disk persistence: save/load preserves every generation + sharing.

The JAX package's ``tests/test_persist.py`` on the port's ``save_store`` and
``load_store``; its trainer case on the port's ``Trainer``.  Two more cases
carry a trainer's archive across packages: the port's ``Trainer`` restores
a JAX ``Trainer``'s ``save_checkpoints`` file with byte-equal params, and
the JAX ``Trainer`` restores the port's."""
import pytest

pytest.importorskip("torch")

import os

import numpy as np

from repro_torch.core import DeltaFS
from repro_torch.core.persist import load_store, save_store


def _arr(seed, n=512):
    return np.random.default_rng(seed).integers(0, 255, size=n).astype(np.uint8)


def test_save_load_roundtrip(tmp_path):
    fs = DeltaFS(chunk_bytes=64)
    fs.write("a", _arr(1))
    fs.write("b", _arr(2))
    c1 = fs.checkpoint()
    mod = _arr(1).copy()
    mod[:8] = 0                        # dirty one chunk of "a"
    fs.write("a", mod)
    fs.delete("b")
    c2 = fs.checkpoint()
    path = str(tmp_path / "store.npz")
    n_chunks = save_store(fs, {"c1": c1, "c2": c2}, path)
    # structural sharing preserved on disk: far fewer chunks than 2 full copies
    assert n_chunks < 2 * (2 * 512 // 64)

    fs2, configs = load_store(path)
    fs2.switch(configs["c1"])
    np.testing.assert_array_equal(fs2.read("a"), _arr(1))
    np.testing.assert_array_equal(fs2.read("b"), _arr(2))
    fs2.switch(configs["c2"])
    np.testing.assert_array_equal(fs2.read("a"), mod)
    assert not fs2.exists("b")
    fs2.debug_validate()


def _port_trainer(steps=8):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig

    cfg = get_config("olmo-1b-tiny")
    return Trainer(
        Model(cfg, device="cpu"),
        OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        TrainerConfig(steps=steps, ckpt_every=4, log_every=4),
    )


def _jax_trainer(steps=8):
    from repro.configs import get_config
    from repro.models import Model
    from repro.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig

    cfg = get_config("olmo-1b-tiny")
    return Trainer(
        Model(cfg),
        OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        TrainerConfig(steps=steps, ckpt_every=4, log_every=4),
    )


def _port_leaves(tree):
    from repro_torch.core.convert import tensor_to_numpy
    from repro_torch.train.optim import tree_paths

    return {p: tensor_to_numpy(t) for p, t in tree_paths(tree)}


def _jax_leaves(tree):
    import jax

    from repro_torch.train.optim import tree_paths

    return dict(tree_paths(jax.tree.map(np.asarray, tree)))


def _assert_bytes_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].tobytes() == w.tobytes(), k


def test_trainer_cross_process_restart(tmp_path):
    """The port's trainer saves its generations, a fresh trainer (another
    "process") loads them, restores byte-equal params and trains on."""
    t1 = _port_trainer()
    p, o, e = t1.init_state(0)
    p, o, e, step = t1.run(p, o, e)
    path = str(tmp_path / "train.npz")
    t1.save_checkpoints(path)

    t2 = _port_trainer()                # fresh "process"
    t2.load_checkpoints(path)
    assert isinstance(t2.fs, DeltaFS)
    p2, o2, e2, step2 = t2.restore_latest()
    assert step2 == 8
    _assert_bytes_equal(_port_leaves(p2), _port_leaves(p))
    _assert_bytes_equal(_port_leaves(o2), _port_leaves(o))
    # and training continues
    t2.run(p2, o2, e2, start_step=step2, steps=step2 + 2)
    assert t2.metrics_log[-1]["step"] == 10


def test_port_trainer_restores_a_jax_archive(tmp_path):
    jt = _jax_trainer()
    p, o, e = jt.init_state(0)
    p, o, e, _ = jt.run(p, o, e)
    path = str(tmp_path / "jax_train.npz")
    jt.save_checkpoints(path)

    tt = _port_trainer()
    tt.load_checkpoints(path)
    p2, o2, e2, step = tt.restore_latest()
    assert step == 8
    _assert_bytes_equal(_port_leaves(p2), _jax_leaves(p))
    _assert_bytes_equal(_port_leaves(o2), _jax_leaves(o))
    tt.run(p2, o2, e2, start_step=step, steps=step + 1)


def test_jax_trainer_restores_a_port_archive(tmp_path):
    tt = _port_trainer()
    p, o, e = tt.init_state(0)
    p, o, e, _ = tt.run(p, o, e)
    path = str(tmp_path / "port_train.npz")
    tt.save_checkpoints(path)

    jt = _jax_trainer()
    jt.load_checkpoints(path)
    p2, o2, e2, step = jt.restore_latest()
    assert step == 8
    _assert_bytes_equal(_jax_leaves(p2), _port_leaves(p))
    _assert_bytes_equal(_jax_leaves(o2), _port_leaves(o))
    jt.run(p2, o2, e2, start_step=step, steps=step + 1)
