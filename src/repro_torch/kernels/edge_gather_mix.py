"""Launch wrapper of the CUDA ``edge_gather_mix`` kernel
(csrc/edge_gather_mix.cu).

The port's counterpart of ``repro.kernels.edge_gather_mix.edge_gather_mix``.
It takes CUDA tensors only; ``kernels.ops.edge_gather_mix`` is the entry
point the sparse topology calls. The table's ids are not checked here (that
would read the table back to the host every call): the kernel clamps them
into [0, N).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _lib() -> ctypes.CDLL:
    lib = build.load("edge_gather_mix")
    fn = lib.edge_gather_mix_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.edge_gather_mix_max_n.restype = ctypes.c_int
        lib.edge_gather_mix_max_n.argtypes = []
    return lib


def edge_gather_mix_cuda(values: torch.Tensor, nbr_table: torch.Tensor,
                         nbr_valid: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_s valid[n, s] * values[nbr[n, s]]`` on the current
    stream: values (N, d) float32, nbr_table (N, S) int32, nbr_valid (N, S)
    float32, all contiguous on one card -> (N, d) float32. Same contract as
    ``ref.edge_gather_mix_ref``, bit for bit."""
    if (not values.is_cuda or values.dim() != 2 or nbr_table.dim() != 2
            or nbr_valid.shape != nbr_table.shape):
        raise ValueError(f"edge_gather_mix: needs CUDA (N, d) values and "
                         f"(N, S) table and validity, got "
                         f"{tuple(values.shape)}, {tuple(nbr_table.shape)}, "
                         f"{tuple(nbr_valid.shape)} on {values.device}")
    n, d = values.shape
    if nbr_table.shape[0] != n:
        raise ValueError(f"edge_gather_mix: table {tuple(nbr_table.shape)} "
                         f"does not match values {tuple(values.shape)}")
    for name, x, dtype in (("values", values, torch.float32),
                           ("nbr_table", nbr_table, torch.int32),
                           ("nbr_valid", nbr_valid, torch.float32)):
        if (x.device != values.device or x.dtype != dtype
                or not x.is_contiguous()):
            raise ValueError(f"edge_gather_mix: {name} must be a contiguous "
                             f"{dtype} tensor on {values.device}, got "
                             f"{x.dtype} on {x.device}")
    lib = _lib()
    if n > lib.edge_gather_mix_max_n():
        raise ValueError(f"edge_gather_mix: at most "
                         f"{lib.edge_gather_mix_max_n()} workers, got {n}")
    out = torch.empty((n, d), dtype=torch.float32, device=values.device)
    vec4 = int(d % 4 == 0 and values.data_ptr() % 16 == 0)
    err = lib.edge_gather_mix_f32(
        values.data_ptr(), nbr_table.data_ptr(), nbr_valid.data_ptr(),
        out.data_ptr(), n, nbr_table.shape[1], d, vec4,
        torch.cuda.current_stream(values.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_gather_mix launch failed: CUDA error {err}")
    return out
