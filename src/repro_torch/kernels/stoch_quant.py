"""Launch wrapper of the CUDA ``stoch_quantize`` kernel (csrc/stoch_quant.cu).

The port's counterpart of ``repro.kernels.stoch_quant.stoch_quantize``. It
takes CUDA float32 tensors only; ``kernels.ops.stoch_quantize`` is the entry
point the engine calls (it counts launches and sends CPU tensors to the
plain version in ``kernels.ref``). The host path is kept thin, as B2's: the
C function is resolved once, one combined check guards memory, and the
stream is read as a raw handle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

THREADS = 256
MAX_BLOCKS = 132 * (2048 // THREADS)   # one wave of the H100's 132 SMs

_F32 = torch.float32
_launch = None


def blocks(total: int) -> int:
    """The kernel's grid for ``total`` = N d elements: enough blocks of 256
    threads for one group of 4 a thread, at least one, one wave at most (a
    grid-stride loop past it). Pure: the CPU tests model the kernel's walk
    on it."""
    return max(1, min(MAX_BLOCKS, -(-(total // 4) // THREADS)))


def _lib() -> ctypes.CDLL:
    """The loaded library, its entries' argument types set."""
    global _launch
    lib = build.load("stoch_quant")
    if _launch is None:
        lib.stoch_quantize_empty.restype = ctypes.c_int
        lib.stoch_quantize_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn = lib.stoch_quantize_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _launch = fn
    return lib


def stoch_quantize_cuda(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                        uniforms: torch.Tensor, delta: torch.Tensor,
                        qrange: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; returns the (N, d)
    reconstruction. Same contract as ``ref.stoch_quantize_ref``."""
    dev = theta.get_device()
    if not (theta.is_cuda and theta.dim() == 2 and theta.dtype == _F32
            and q_hat_prev.dtype == _F32 and uniforms.dtype == _F32
            and delta.dtype == _F32 and qrange.dtype == _F32
            and q_hat_prev.shape == theta.shape
            and uniforms.shape == theta.shape
            and delta.shape == theta.shape[:1]
            and qrange.shape == theta.shape[:1]
            and q_hat_prev.get_device() == dev
            and uniforms.get_device() == dev and delta.get_device() == dev
            and qrange.get_device() == dev and theta.is_contiguous()
            and q_hat_prev.is_contiguous() and uniforms.is_contiguous()
            and delta.is_contiguous() and qrange.is_contiguous()):
        raise ValueError(
            f"stoch_quantize: needs contiguous CUDA float32 (N, d) theta, "
            f"q_hat_prev, uniforms and (N,) delta, qrange on one device, got "
            + ", ".join(f"{tuple(x.shape)} {x.dtype} on {x.device}"
                        for x in (theta, q_hat_prev, uniforms, delta,
                                  qrange)))
    if _launch is None:
        _lib()
    total = theta.numel()
    out = torch.empty_like(theta)
    # the float4 body needs the three inputs 16-byte aligned (out is a
    # fresh allocation, aligned)
    vec = not (theta.data_ptr() | q_hat_prev.data_ptr()
               | uniforms.data_ptr()) % 16
    err = _launch(theta.data_ptr(), q_hat_prev.data_ptr(),
                  uniforms.data_ptr(), delta.data_ptr(), qrange.data_ptr(),
                  out.data_ptr(), total, theta.shape[1], vec, blocks(total),
                  torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"stoch_quantize launch failed: CUDA error {err}")
    return out


def empty_launch(total: int, device: torch.device) -> None:
    """An empty kernel on the grid ``stoch_quantize`` takes for ``total``
    elements, through the same ctypes path: the floor under a launch."""
    err = _lib().stoch_quantize_empty(
        blocks(total), torch._C._cuda_getCurrentRawStream(device.index or 0))
    if err != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")
