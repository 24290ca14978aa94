"""Build the hand-written CUDA kernels and load them with ctypes.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The libraries land in the
checkout's ``build/repro_torch/<hash>/`` directory, keyed by a hash of
all the sources and the flags, so an edit rebuilds and an unchanged
tree reuses its build. All sources compile in parallel, one ``nvcc``
each, at the first use of any kernel; nothing happens at import.

Every exported C function launches on the stream it is given,
allocates nothing, does not synchronise, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ell_spmv", "pack", "flash_attention", "ell_onehot")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    return shutil.which("nvcc")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict:
    """Compile every source that is not built yet.

    Returns ``{"dir": build directory, "seconds": wall time of this
    call's compiles, "logs": {source: nvcc/ptxas output}}`` (``logs``
    is empty when everything was built already).
    """
    out_dir = _build_dir()
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    report = {"dir": out_dir, "seconds": 0.0, "logs": {}}
    if not todo:
        return report
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = out_dir / f"lib{s}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report["logs"][s] = log.strip()
        if proc.returncode != 0:
            failed.append(f"{s}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{s}.so")
    report["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(
            str(build()["dir"] / f"lib{name}.so"))
    return lib


def declare(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int,
            n_float: int = 0):
    """``fn(ptr * n_ptr, int * n_int, float * n_float, stream)
    -> cudaError_t``."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_float] * n_float + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
