"""Launch wrapper of the CUDA ``stoch_quantize`` kernel (csrc/stoch_quant.cu).

The port's counterpart of ``repro.kernels.stoch_quant.stoch_quantize``. It
takes CUDA float32 tensors only; ``kernels.ops.stoch_quantize`` is the entry
point the engine calls (it counts launches and sends CPU tensors to the
plain version in ``kernels.ref``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_ROWS = 65535          # gridDim.y


def _lib() -> ctypes.CDLL:
    lib = build.load("stoch_quant")
    fn = lib.stoch_quantize_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    return lib


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if (x.device != device or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"stoch_quantize: {name} must be a contiguous "
                         f"float32 tensor on {device}, got {x.dtype} on "
                         f"{x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"stoch_quantize: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")


def stoch_quantize_cuda(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                        uniforms: torch.Tensor, delta: torch.Tensor,
                        qrange: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the (N, d)
    reconstruction. Same contract as ``ref.stoch_quantize_ref``."""
    if theta.dim() != 2 or not theta.is_cuda:
        raise ValueError(f"stoch_quantize: theta must be a CUDA (N, d) "
                         f"tensor, got {tuple(theta.shape)} on "
                         f"{theta.device}")
    n, d = theta.shape
    if n > _MAX_ROWS:
        raise ValueError(f"stoch_quantize: at most {_MAX_ROWS} rows, got {n}")
    for name, x, shape in (("theta", theta, (n, d)),
                           ("q_hat_prev", q_hat_prev, (n, d)),
                           ("uniforms", uniforms, (n, d)),
                           ("delta", delta, (n,)), ("qrange", qrange, (n,))):
        _check(name, x, shape, theta.device)
    out = torch.empty_like(theta)
    # the kernel's float4 body assumes the four (N, d) buffers share their
    # alignment: it peels each row up to the same 16-byte boundary
    if any(x.data_ptr() % 16 for x in (theta, q_hat_prev, uniforms, out)):
        raise ValueError("stoch_quantize: the (N, d) buffers must start on "
                         "16-byte boundaries")
    err = _lib().stoch_quantize_f32(
        theta.data_ptr(), q_hat_prev.data_ptr(), uniforms.data_ptr(),
        delta.data_ptr(), qrange.data_ptr(), out.data_ptr(), n, d,
        torch.cuda.current_stream(theta.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stoch_quantize launch failed: CUDA error {err}")
    return out
