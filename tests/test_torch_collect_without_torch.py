"""The port's tests skip themselves where torch is absent, so the JAX
package's CI (``requirements-dev.txt`` has no torch) still collects and
runs the reference's tests."""
import pytest

pytest.importorskip("torch")

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"

COLLECT = (
    "import sys; sys.modules['torch'] = None; import pytest;"
    "sys.exit(pytest.main(['--collect-only', '-q', '-o', 'addopts=', '-rs',"
    " '-p', 'no:cacheprovider', 'tests/']))"
)


def test_collection_without_torch_skips_the_port_and_keeps_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", COLLECT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "error" not in out.splitlines()[-1].lower(), out[-4000:]
    ids = [line for line in r.stdout.splitlines() if "::" in line]
    port = sorted(p.name for p in TESTS.glob("test_torch_*.py"))
    reference = sorted(p.name for p in TESTS.glob("test_*.py") if p.name not in port)
    collected = {line.split("::")[0].split("/")[-1] for line in ids}
    assert not any(name.startswith("test_torch_") for name in collected)
    assert set(reference) <= collected, sorted(set(reference) - collected)
    skipped = [line for line in r.stdout.splitlines()
               if line.startswith("SKIPPED") and "could not import 'torch'" in line]
    assert sorted(line.split("tests/")[1].split(":")[0] for line in skipped) == port
