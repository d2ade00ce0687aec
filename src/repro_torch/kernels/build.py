"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch_kernels/`` at the root of the checkout. A library is
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. ``build_all()`` starts one nvcc per source, all together,
and waits for them. A failed build raises with nvcc's stderr. Nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
SOURCES = ("stoch_quant", "bipartite_mix", "grouped_quant", "grouped_fused",
           "grouped_fused_tiled", "paged_attention", "edge_gather_mix",
           "slstm_cell")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise KernelBuildError(
            f"nvcc not found on PATH or under {cuda_home}/bin")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def _start(name: str, nvcc: str):
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its error report, or "" on success."""
    proc, tmp, target = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}"
    os.replace(tmp, target)
    return ""


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every listed source that has no library yet, one nvcc each,
    all started together. Raises after all of them have ended if any
    failed, with nvcc's stderr (also written to this process's stderr)."""
    names = list(names)
    with _lock:
        nvcc = nvcc_path()
        jobs = {n: _start(n, nvcc) for n in names}
        errors = [_finish(n, job) for n, job in jobs.items() if job]
    errors = [e for e in errors if e]
    if errors:
        sys.stderr.write("\n".join(errors) + "\n")
        raise KernelBuildError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)))
        return _loaded[name]
