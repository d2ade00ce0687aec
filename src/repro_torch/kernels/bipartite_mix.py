"""Launch wrapper of the CUDA ``bipartite_mix`` kernels
(csrc/bipartite_mix.cu): a streaming pass for the LM trainer's few wide
rows, a register-tiled product for the rest; the C launcher picks one from
the shapes.

The port's counterpart of ``repro.kernels.bipartite_mix.bipartite_mix``. It
takes CUDA float32 tensors only; ``kernels.ops.bipartite_mix`` is the entry
point the topology calls. The host path is kept thin: the C function and
its argument types are resolved once, the stream is read as a raw handle,
and only the checks that guard memory (device, dtype, contiguity, shapes)
run per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_F32 = torch.float32
_MAX_ROWS = 32 * 65535     # gridDim.y of the tiled design, in 32-row tiles
_MAX_COLS = 2 ** 31 - 129  # column offsets of the tiled design in an int
_launch = None


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry's argument types set."""
    global _launch
    lib = build.load("bipartite_mix")
    if _launch is None:
        fn = lib.bipartite_mix_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_int64, ctypes.c_void_p]
        _launch = fn
    return lib


def bipartite_mix_cuda(adjacency: torch.Tensor, values: torch.Tensor
                       ) -> torch.Tensor:
    """``adjacency (M, N) @ values (N, d)`` on the current stream, float32
    in and out. Same contract as ``ref.bipartite_mix_ref``."""
    if not (values.is_cuda and values.dim() == 2 and adjacency.dim() == 2
            and values.dtype == _F32 and adjacency.dtype == _F32
            and adjacency.get_device() == values.get_device()
            and adjacency.shape[1] == values.shape[0]
            and values.is_contiguous() and adjacency.is_contiguous()):
        raise ValueError(
            f"bipartite_mix: needs contiguous float32 CUDA (M, N) and (N, d) "
            f"tensors on one device, got {tuple(adjacency.shape)} "
            f"{adjacency.dtype} on {adjacency.device} and "
            f"{tuple(values.shape)} {values.dtype} on {values.device}")
    m, d = adjacency.shape[0], values.shape[1]
    if m > _MAX_ROWS or d > _MAX_COLS:
        raise ValueError(f"bipartite_mix: too many rows or columns ({m}, "
                         f"{d})")
    if _launch is None:
        _lib()
    # a square adjacency (every caller's but a row block's) gives out the
    # shape of values: empty_like is the cheaper allocation from Python
    out = (torch.empty_like(values) if m == values.shape[0]
           else values.new_empty((m, d)))
    err = _launch(adjacency.data_ptr(), values.data_ptr(), out.data_ptr(),
                  m, values.shape[0], d,
                  torch._C._cuda_getCurrentRawStream(values.get_device()))
    if err != 0:
        raise RuntimeError(f"bipartite_mix launch failed: CUDA error {err}")
    return out
