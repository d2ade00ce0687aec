"""Launch wrappers of the three grouped quantize CUDA kernels:

* ``stoch_quantize_grouped_cuda`` (csrc/grouped_quant.cu), the port of
  ``repro.kernels.stoch_quant.stoch_quantize_grouped``;
* ``stoch_quantize_grouped_fused_cuda`` (csrc/grouped_fused.cu), of
  ``stoch_quantize_grouped_fused``;
* ``stoch_quantize_grouped_fused_tiled_cuda`` (csrc/grouped_fused_tiled.cu),
  of ``stoch_quantize_grouped_fused_tiled``.

They take CUDA float32 tensors only. The column groups arrive as the
packing's ``group_runs`` (per group, its ``(offset, size)`` column runs),
which must tile ``[0, D)``; the kernels read the run boundaries, never a
``(D,)`` id map. ``kernels.ops`` holds the entry points the engine calls.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_RUNS = 256          # gq::kMaxSegs in csrc/grouped_common.cuh
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def column_runs(group_runs, dim: int) -> Tuple[ctypes.Array, ctypes.Array,
                                                int]:
    """The runs sorted by column as host arrays ``(offsets (S+1,) int64,
    group ids (S,) int32, S)``. Raises unless they tile ``[0, dim)``."""
    runs = sorted((int(off), int(size), g)
                  for g, rs in enumerate(group_runs) for off, size in rs
                  if int(size) > 0)
    pos = 0
    for off, size, _ in runs:
        if off != pos:
            raise ValueError(f"group runs must tile [0, {dim}) without gaps "
                             f"or overlaps; column {pos} starts no run")
        pos += size
    if pos != dim:
        raise ValueError(f"group runs cover {pos} columns, the buffer has "
                         f"{dim}")
    if not runs or len(runs) > MAX_RUNS:
        raise ValueError(f"the grouped kernels take 1..{MAX_RUNS} column "
                         f"runs, got {len(runs)}")
    offs = (_LL * (len(runs) + 1))(*([r[0] for r in runs] + [dim]))
    gids = (ctypes.c_int * len(runs))(*[r[2] for r in runs])
    return offs, gids, len(runs)


def _check(op: str, tensors: Sequence[Tuple[str, torch.Tensor, tuple]],
           device) -> None:
    for name, x, shape in tensors:
        if (x.device != device or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"{op}: {name} must be a contiguous float32 "
                             f"tensor on {device}, got {x.dtype} on "
                             f"{x.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")


def _buffers(op: str, theta: torch.Tensor, qprev, unif, side, n_groups):
    """Validate the (N, D) buffers and the (N, G) side arrays."""
    if theta.dim() != 2 or not theta.is_cuda:
        raise ValueError(f"{op}: theta must be a CUDA (N, D) tensor, got "
                         f"{tuple(theta.shape)} on {theta.device}")
    n, d = theta.shape
    _check(op, [("theta", theta, (n, d)), ("q_hat_prev", qprev, (n, d)),
                ("uniforms", unif, (n, d))]
           + [(name, x, (n, n_groups)) for name, x in side], theta.device)
    if any(x.data_ptr() % 16 for x in (theta, qprev, unif)):
        raise ValueError(f"{op}: the (N, D) buffers must start on 16-byte "
                         f"boundaries")
    return n, d


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def stoch_quantize_grouped_cuda(theta, q_hat_prev, uniforms, delta, qrange,
                                group_runs) -> torch.Tensor:
    """Grouped quantize with given (N, G) Δ and R; same contract as
    ``ref.stoch_quantize_grouped_ref``."""
    op = "stoch_quantize_grouped"
    n_groups = delta.shape[1] if delta.dim() == 2 else -1
    n, d = _buffers(op, theta, q_hat_prev, uniforms,
                    [("delta", delta), ("qrange", qrange)], n_groups)
    offs, gids, n_runs = column_runs(group_runs, d)
    if max(gids) >= n_groups:
        raise ValueError(f"{op}: a run names group {max(gids)}, the side "
                         f"information has {n_groups} groups")
    out = torch.empty_like(theta)
    lib = _lib("grouped_quant", "grouped_quant_f32",
               [_P] * 6 + [_LL, _LL, ctypes.c_int, _P, _P, ctypes.c_int, _P])
    err = lib.grouped_quant_f32(
        theta.data_ptr(), q_hat_prev.data_ptr(), uniforms.data_ptr(),
        delta.data_ptr(), qrange.data_ptr(), out.data_ptr(), n, d, n_groups,
        offs, gids, n_runs, _stream(theta))
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err}")
    return out


_FUSED_ARGS = [_P] * 10 + [_LL, _LL, ctypes.c_int, _P, _P, ctypes.c_int,
                           _F, _F, _F]


def _fused(op, lib_name, fn_name, extra_types, extra_args, theta, q_hat_prev,
           uniforms, bits_prev, range_prev, initialized, group_runs, omega,
           b0, b_max):
    n_groups = bits_prev.shape[1] if bits_prev.dim() == 2 else -1
    n, d = _buffers(op, theta, q_hat_prev, uniforms,
                    [("bits_prev", bits_prev), ("range_prev", range_prev),
                     ("initialized", initialized)], n_groups)
    offs, gids, n_runs = column_runs(group_runs, d)
    if max(gids) >= n_groups:
        raise ValueError(f"{op}: a run names group {max(gids)}, the state "
                         f"has {n_groups} groups")
    out = torch.empty_like(theta)
    side = dict(dtype=torch.float32, device=theta.device)
    range_new = torch.zeros((n, n_groups), **side)   # the max accumulator
    bits = torch.empty((n, n_groups), **side)
    delta = torch.empty((n, n_groups), **side)
    lib = _lib(lib_name, fn_name, _FUSED_ARGS + extra_types + [_P])
    err = getattr(lib, fn_name)(
        theta.data_ptr(), q_hat_prev.data_ptr(), uniforms.data_ptr(),
        bits_prev.data_ptr(), range_prev.data_ptr(), initialized.data_ptr(),
        out.data_ptr(), range_new.data_ptr(), bits.data_ptr(),
        delta.data_ptr(), n, d, n_groups, offs, gids, n_runs, float(omega),
        float(b0), float(b_max), *extra_args, _stream(theta))
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err}")
    return out, range_new, bits, delta


def stoch_quantize_grouped_fused_cuda(theta, q_hat_prev, uniforms,
                                      bits_prev, range_prev, initialized,
                                      group_runs, omega, b0, b_max):
    """One grouped round in one cooperative launch; same contract as
    ``ref.stoch_quantize_grouped_fused_ref``: returns ``(out, range_new,
    bits, delta)``."""
    return _fused("stoch_quantize_grouped_fused", "grouped_fused",
                  "grouped_fused_f32", [], [], theta, q_hat_prev, uniforms,
                  bits_prev, range_prev, initialized, group_runs, omega, b0,
                  b_max)


def stoch_quantize_grouped_fused_tiled_cuda(theta, q_hat_prev, uniforms,
                                            bits_prev, range_prev,
                                            initialized, group_runs, omega,
                                            b0, b_max, block_d: int):
    """The same round in two launches over ``block_d``-column tiles."""
    if block_d < 1:
        raise ValueError(f"block_d must be >= 1, got {block_d}")
    if theta.dim() == 2 and theta.shape[0] > 65535:
        raise ValueError("stoch_quantize_grouped_fused_tiled: at most 65535 "
                         "rows")
    return _fused("stoch_quantize_grouped_fused_tiled",
                  "grouped_fused_tiled", "grouped_fused_tiled_f32", [_LL],
                  [int(block_d)], theta, q_hat_prev, uniforms, bits_prev,
                  range_prev, initialized, group_runs, omega, b0, b_max)
