"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port
loads neither, and its entry points run on the card unless asked not to."""
import ast
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite shares one process with the JAX tests)
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
    assert {"delta_fused.py", "delta_diff.py", "delta_apply.py", "deltacr.py", "chip_smoke.py"} <= names


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys; import repro_torch, repro_torch.core, repro_torch.kernels;"
        "import repro_torch.core.convert;"
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
