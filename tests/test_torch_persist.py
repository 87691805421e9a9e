"""Disk persistence: save/load preserves every generation + sharing.

The JAX package's ``tests/test_persist.py`` on the port's ``save_store`` and
``load_store``.  The port has no ``train/`` yet, so the trainer case runs the
JAX package's ``Trainer`` with its archive calls routed to the port's: the
port writes the reference's generations and reads them back into a port
``DeltaFS``, which the restarted trainer restores from and trains on."""
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


def test_trainer_cross_process_restart(tmp_path, monkeypatch):
    import jax
    import repro.core.persist as reference_persist
    from repro.configs import get_config
    from repro.models import Model
    from repro.train import DataConfig, OptimizerConfig, Trainer, TrainerConfig

    monkeypatch.setattr(reference_persist, "save_store", save_store)
    monkeypatch.setattr(reference_persist, "load_store", load_store)

    cfg = get_config("olmo-1b-tiny")
    mk = lambda: Trainer(
        Model(cfg),
        OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        TrainerConfig(steps=8, ckpt_every=4, log_every=4),
    )
    t1 = mk()
    p, o, e = t1.init_state(0)
    p, o, e, step = t1.run(p, o, e)
    path = str(tmp_path / "train.npz")
    t1.save_checkpoints(path)

    t2 = mk()                           # fresh "process"
    t2.load_checkpoints(path)
    assert isinstance(t2.fs, DeltaFS)   # the port's archive reader ran
    p2, o2, e2, step2 = t2.restore_latest()
    assert step2 == 8
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and training continues
    t2.run(p2, o2, e2, start_step=step2, steps=step2 + 2)
