"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `d3gs_tpu_torch/csrc/<name>.cu` has plain C entry points and compiles
on its own into `build/lib<name>.so` at the repository root (git-ignored),
at first use or when a source is newer than its library. Several sources
compile concurrently, one nvcc each. No PyTorch headers are included, so a
build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of d3gs_tpu_torch cannot be built")


def sources() -> list[str]:
    """Names of the libraries, one per `csrc/*.cu`: the port's kernels and
    `blend_checks` (two checks chip_smoke.py runs, used by no path)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the stale kernels among `names` (default: all), one nvcc
    process each, all started together. Returns each compiler's output
    (ptxas register and shared-memory report included); raises if any
    build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, building it first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def entry(name: str, argtypes,
          symbol: str | None = None) -> ctypes._CFuncPtr:
    """The C entry point `d3gs_<symbol>` (default: `d3gs_<name>`) of kernel
    `name`, with its argument types set; it returns the launch's
    cudaError_t as an int."""
    fn = getattr(load(name), "d3gs_" + (symbol or name))
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
