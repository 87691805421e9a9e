"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port
loads neither, and its entry points run on the card unless asked not to."""
import ast
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite shares one process with the JAX tests)
import numpy as np
import pytest
import torch

from repro_torch.core import CowTensorState, state_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_import_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_sources_are_covered():
    names = {p.name for p in PORT_FILES}
    assert {
        "delta_fused.py", "delta_diff.py", "delta_apply.py", "deltacr.py", "chip_smoke.py",
        "page_copy.py", "paged_attention.py", "kvcache.py", "engine.py", "model.py", "layers.py",
        "sandbox_tree.py", "gc.py", "scheduler.py", "mcts.py", "fanout.py", "archetypes.py",
        "decode_task.py", "persist.py", "placement.py", "sharding.py", "shard_dump.py",
        "mesh.py", "collectives.py", "serve.py", "quickstart.py", "mcts_search.py",
        "rl_fanout.py", "train_lm.py",
    } <= names


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys; import repro_torch, repro_torch.core, repro_torch.kernels;"
        "import repro_torch.core.convert, repro_torch.configs, repro_torch.models;"
        "import repro_torch.serve, repro_torch.search;"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.launch.mesh;"
        "import repro_torch.dist.collectives, repro_torch.launch.serve;"
        "import repro_torch.examples.quickstart, repro_torch.examples.mcts_search;"
        "import repro_torch.examples.rl_fanout, repro_torch.examples.train_lm;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_tensor_state_defaults_to_the_card():
    """No device means the card: without one it raises, never falls back
    to the CPU; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        assert CowTensorState({"x": torch.zeros(4)}).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CowTensorState({"x": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({})
    assert CowTensorState({"x": torch.zeros(4)}, device="cpu").device.type == "cpu"


def test_sandbox_state_defaults_to_the_card():
    """``build_sandbox_state`` without a device builds its heap on the
    card; without one it raises before writing a file, never falls back to
    the CPU."""
    from repro_torch.core import DeltaFS
    from repro_torch.search import ARCHETYPES, build_sandbox_state

    spec = ARCHETYPES["tools"]
    if torch.cuda.is_available():
        assert build_sandbox_state(spec, DeltaFS()).device.type == "cuda"
        return
    fs = DeltaFS()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sandbox_state(spec, fs)
    assert fs.keys() == []
    assert build_sandbox_state(spec, fs, device="cpu").device.type == "cpu"


def test_kernel_wrappers_raise_for_wrong_inputs():
    from repro_torch.kernels import ops

    with pytest.raises(ValueError):
        ops.delta_diff(torch.zeros(4, 8, dtype=torch.uint8), torch.zeros(4, 9, dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.delta_apply(
            torch.zeros(4, 8, dtype=torch.uint8), torch.zeros(2, 8, dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int64),
        )
    with pytest.raises(ValueError):
        ops.fused_encode(torch.zeros(4, 8, dtype=torch.uint8), torch.zeros(4, 8, dtype=torch.uint8), 0)


def test_serving_entry_points_default_to_the_card():
    """``Model`` and ``PagePool`` without a device mean the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import PagePool

    cfg = get_config("olmo-1b-tiny")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        assert PagePool(cfg, num_pages=4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagePool(cfg, num_pages=4)
    assert PagePool(cfg, num_pages=4, device="cpu").pools_k["stage0"]["l0_s0_attn"].device.type == "cpu"


def _saved_root(tmp_path):
    """A persisted root of one host-state checkpoint."""
    from repro_torch.core import CowArrayState, DeltaCR, save_state

    cr = DeltaCR(restore_fn=lambda p: CowArrayState(p), chunk_bytes=256)
    cr.checkpoint(CowArrayState({"heap": np.arange(512, dtype=np.float32)}), 1, None)
    cr.wait_dumps()
    root = str(tmp_path / "root")
    save_state(root, deltacr=cr)
    cr.shutdown()
    return root


def test_recover_defaults_to_the_card(tmp_path):
    """``recover`` and ``PersistencePlane.recover`` without a device mean
    the card: without one they raise, never recover onto the CPU."""
    from repro_torch.core import PersistencePlane, recover

    root = _saved_root(tmp_path)
    if torch.cuda.is_available():
        rec = recover(root)
        rec_id = rec.deltacr.pipeline.anchored_ids()[0]
        rec_grid = rec.deltacr.pipeline.record_for(rec_id).views["heap"].grid
        assert rec_grid.device.type == "cuda"
        rec.deltacr.shutdown()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        recover(root)
    with pytest.raises(RuntimeError, match="CUDA"):
        PersistencePlane(root).recover()
    rec = recover(root, device="cpu")
    assert rec.deltacr.images.image_for(1) is not None
    rec.deltacr.shutdown()


def test_rebuilt_anchors_are_uploaded_once_or_raise(tmp_path, monkeypatch):
    """Off the CPU, every rebuilt anchor grid is a uint8 tensor on the asked
    device (the meta device stands in for the card here), one upload per
    tensor; a failed upload raises and registers no host grid."""
    from repro_torch.core import recover
    from repro_torch.core import delta_pipeline

    root = _saved_root(tmp_path)
    rec = recover(root, device="cpu", auto_restore=False)
    pipe, image = rec.deltacr.pipeline, rec.deltacr.images.image_for(1)
    host = pipe.record_for(image.image_id)
    assert isinstance(host.views["heap"].grid, np.ndarray)   # the CPU keeps numpy
    pipe.release_record(host)
    pipe.clear()
    uploads = []
    real = delta_pipeline._upload_grid
    monkeypatch.setattr(delta_pipeline, "_upload_grid",
                        lambda g, d: uploads.append(g.shape) or real(g, d))
    assert pipe.rebuild_generation(image, device="meta")
    rec_ = pipe.record_for(image.image_id)
    grid = rec_.views["heap"].grid
    pipe.release_record(rec_)
    assert grid.device.type == "meta" and grid.dtype == torch.uint8
    assert tuple(grid.shape) == (8, 256) and uploads == [(8, 256)]
    pipe.clear()

    def fail(g, d):
        raise torch.cuda.OutOfMemoryError("upload failed")

    monkeypatch.setattr(delta_pipeline, "_upload_grid", fail)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pipe.rebuild_generation(image, device="meta")
    assert pipe.anchored_ids() == []
    rec.deltacr.shutdown()
