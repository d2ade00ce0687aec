"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch_kernels/`` at the root of the checkout. A library is
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A source listed in ``VARIANTS`` is compiled once per
variant, with that variant's ``-D`` flags, into a library of its own
(``lib<name>.<variant>_<hash>.so``): the paged-attention decode kernel is
built per head dim (its source requires the define), so that its 48
instantiations compile in six processes. ``build_all()`` starts one nvcc per source and variant, all
together, and waits for them. A failed build raises with nvcc's stderr.
Nothing is built when this module is imported.
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
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
SOURCES = ("stoch_quant", "bipartite_mix", "grouped_quant", "grouped_fused",
           "grouped_fused_tiled", "paged_attention", "edge_gather_mix",
           "slstm_cell")
# per-source variants: name -> {variant: extra nvcc flags}
VARIANTS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "paged_attention": {f"hd{hd}": (f"-DPAGED_HEAD_DIM={hd}",)
                        for hd in (32, 64, 80, 112, 128, 256)},
}

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Optional[str]], ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise KernelBuildError(
            f"nvcc not found on PATH or under {cuda_home}/bin")
    return found


def _flags(name: str, variant: Optional[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + (VARIANTS[name][variant] if variant else ())


def _target(name: str, variant: Optional[str] = None) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(_flags(name, variant))
    tag = hashlib.sha256(src + flags.encode()).hexdigest()
    stem = f"{name}.{variant}" if variant else name
    return BUILD_DIR / f"lib{stem}_{tag[:16]}.so"


def _units(names: Iterable[str]):
    """(source, variant) of every library the sources build."""
    for name in names:
        for variant in VARIANTS.get(name, {None: ()}):
            yield name, variant


def _start(name: str, variant: Optional[str], nvcc: str):
    target = _target(name, variant)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(name, variant), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
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


def _build(units) -> None:
    """Compile the (source, variant) libraries not built yet, one nvcc
    each, all started together; raise after all have ended if any failed,
    with nvcc's stderr (also written to this process's stderr)."""
    with _lock:
        nvcc = nvcc_path()
        jobs = {u: _start(*u, nvcc) for u in units}
        errors = [_finish(f"{n}.{v}" if v else n, job)
                  for (n, v), job in jobs.items() if job]
    errors = [e for e in errors if e]
    if errors:
        sys.stderr.write("\n".join(errors) + "\n")
        raise KernelBuildError("\n".join(errors))


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every library of the listed sources (one per variant) that
    is not built yet, all together (:func:`_build`)."""
    _build(list(_units(names)))


def load(name: str, variant: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, or of one of its
    ``VARIANTS`` (a source that has variants is built only as those),
    built at first use."""
    key = (name, variant)
    with _lock:
        lib = _loaded.get(key)
    if lib is not None:
        return lib
    if (variant is None) != (name not in VARIANTS) or (
            variant is not None and variant not in VARIANTS[name]):
        raise KernelBuildError(f"{name}.cu has no library {variant!r}; "
                               f"its variants: {list(VARIANTS.get(name, ()))}")
    _build([key])
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(_target(name, variant)))
        return _loaded[key]
