"""Build and load the CUDA kernels of ``csrc/`` as one shared library.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one ``.so`` with
a plain C interface that ``ctypes`` loads.  No PyTorch headers are
included, so a build takes seconds.  The library lands in
``build/repro_torch_kernels/<hash of sources and flags>/`` under the
repository root (or ``$REPRO_TORCH_BUILD_DIR``), so a changed source
rebuilds and an unchanged one is loaded as it is.

The build happens at the first kernel launch on a CUDA tensor, never at
import.  A failed build raises :class:`KernelBuildError` and a failed
launch :class:`KernelLaunchError`: nothing falls back to the plain version
for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

__all__ = [
    "KernelBuildError",
    "KernelError",
    "KernelLaunchError",
    "build_dir",
    "build_log",
    "check",
    "library",
    "stream_handle",
]

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS]
LIB_NAME = "librepro_torch_kernels.so"

_c = ctypes
_P = _c.c_void_p
_I64 = _c.c_int64
# C entry points: name -> argument types (every one returns a cudaError_t)
SIGNATURES = {
    "repro_delta_diff": [_P, _P, _P, _I64, _I64, _c.c_int, _P],
    "repro_delta_apply": [_P, _P, _P, _I64, _I64, _I64, _c.c_int, _P],
    "repro_delta_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _c.c_int, _P],
}


class KernelError(RuntimeError):
    """A kernel of this package failed to build or to launch.  The dump
    path re-raises it instead of retrying or degrading to the host path, so
    a broken kernel on a CUDA tensor is never hidden."""


class KernelBuildError(KernelError):
    pass


class KernelLaunchError(KernelError):
    pass


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log: str = ""
build_seconds: float = 0.0


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if root:
        return Path(root)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(out: Path) -> str:
    """Compile every source in parallel, link, and return the compiler log."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / LIB_NAME
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp), *(str(o) for _, o, _ in procs)]
        r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{r.stdout}")
        os.replace(lib_tmp, out)          # atomic: concurrent builders agree
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = build_dir() / _digest()
        target.mkdir(parents=True, exist_ok=True)
        so = target / LIB_NAME
        if not so.exists():
            t0 = time.perf_counter()
            _log = _compile(so)
            build_seconds = time.perf_counter() - t0
            (target / "build.log").write_text(_log)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build_log() -> str:
    """The compiler output of this process's build ('' when it was cached)."""
    return _log


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err} at launch")


def stream_handle(tensor: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``tensor``'s device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
