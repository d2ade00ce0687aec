"""Launch wrapper of the CUDA ``bipartite_mix`` kernel (csrc/bipartite_mix.cu).

The port's counterpart of ``repro.kernels.bipartite_mix.bipartite_mix``. It
takes CUDA float32 tensors only; ``kernels.ops.bipartite_mix`` is the entry
point the topology calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_ROW_BLOCKS = 65535    # gridDim.y, in tiles of 8 rows


def _lib() -> ctypes.CDLL:
    lib = build.load("bipartite_mix")
    fn = lib.bipartite_mix_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.bipartite_mix_max_n.restype = ctypes.c_int
        lib.bipartite_mix_max_n.argtypes = []
    return lib


def bipartite_mix_cuda(adjacency: torch.Tensor, values: torch.Tensor
                       ) -> torch.Tensor:
    """``adjacency (M, N) @ values (N, d)`` on the current stream, float32
    in and out. Same contract as ``ref.bipartite_mix_ref``."""
    if not values.is_cuda or values.dim() != 2 or adjacency.dim() != 2:
        raise ValueError(f"bipartite_mix: needs CUDA (M, N) and (N, d) "
                         f"tensors, got {tuple(adjacency.shape)} and "
                         f"{tuple(values.shape)} on {values.device}")
    m, n = adjacency.shape
    d = values.shape[1]
    if values.shape[0] != n:
        raise ValueError(f"bipartite_mix: adjacency {tuple(adjacency.shape)} "
                         f"does not match values {tuple(values.shape)}")
    for name, x in (("adjacency", adjacency), ("values", values)):
        if (x.device != values.device or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"bipartite_mix: {name} must be a contiguous "
                             f"float32 tensor on {values.device}, got "
                             f"{x.dtype} on {x.device}")
    lib = _lib()
    if n > lib.bipartite_mix_max_n():
        raise ValueError(f"bipartite_mix: at most {lib.bipartite_mix_max_n()}"
                         f" workers (the adjacency tile lives in shared "
                         f"memory), got {n}")
    if (m + 7) // 8 > _MAX_ROW_BLOCKS:
        raise ValueError(f"bipartite_mix: too many rows ({m})")
    out = torch.empty((m, d), dtype=torch.float32, device=values.device)
    err = lib.bipartite_mix_f32(
        adjacency.data_ptr(), values.data_ptr(), out.data_ptr(), m, n, d,
        torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bipartite_mix launch failed: CUDA error {err}")
    return out
