"""The kernels' entry points: the plain version for a CPU tensor, the CUDA
kernel for a CUDA tensor. There is no fall-back: a CUDA tensor that the
kernel does not take raises, and so does a failed build or launch.

``launches`` counts kernel calls by name, one per call (the tiled fused
round is two CUDA launches and counts once). It is bumped only where a
kernel is launched (never on the CPU path), so a run can show that the main
path went through the kernels: set the counts to 0 before the run and read
them after.

The grouped entry points take the JAX package's arguments plus the
packing's ``group_runs`` (per group, its ``(offset, size)`` column runs):
the CUDA kernels read the runs, the plain versions the ``(D,)``
``group_ids`` map, which may be None (it is then built from the runs).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from repro_torch.core.packing import runs_to_col_ids
from repro_torch.kernels import ref
from repro_torch.kernels.bipartite_mix import bipartite_mix_cuda
from repro_torch.kernels.grouped_quant import (
    stoch_quantize_grouped_cuda, stoch_quantize_grouped_fused_cuda,
    stoch_quantize_grouped_fused_tiled_cuda)
from repro_torch.kernels.stoch_quant import stoch_quantize_cuda

KERNELS = ("stoch_quantize", "bipartite_mix", "stoch_quantize_grouped",
           "stoch_quantize_grouped_fused",
           "stoch_quantize_grouped_fused_tiled")
launches: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def stoch_quantize(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                   uniforms: torch.Tensor, delta: torch.Tensor,
                   qrange: torch.Tensor) -> torch.Tensor:
    """Fused quantize -> dequantize, Eqs. 14-20 (see ``ref``)."""
    if theta.device.type == "cpu":
        return ref.stoch_quantize_ref(theta, q_hat_prev, uniforms, delta,
                                      qrange)
    out = stoch_quantize_cuda(theta, q_hat_prev, uniforms, delta, qrange)
    launches["stoch_quantize"] += 1
    return out


def bipartite_mix(adjacency: torch.Tensor, values: torch.Tensor
                  ) -> torch.Tensor:
    """Neighbour sum ``A @ V`` (see ``ref``)."""
    if values.device.type == "cpu":
        return ref.bipartite_mix_ref(adjacency, values)
    out = bipartite_mix_cuda(adjacency, values)
    launches["bipartite_mix"] += 1
    return out


def _col_ids(group_ids: Optional[torch.Tensor], group_runs, dim: int,
             device) -> torch.Tensor:
    """The (D,) column -> group map the plain versions take."""
    if group_ids is not None:
        return group_ids
    return torch.from_numpy(runs_to_col_ids(group_runs, dim)).to(device)


def stoch_quantize_grouped(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                           uniforms: torch.Tensor, delta: torch.Tensor,
                           qrange: torch.Tensor,
                           group_ids: Optional[torch.Tensor], *,
                           group_runs) -> torch.Tensor:
    """Grouped quantize -> dequantize with given (N, G) Δ and R (see
    ``ref.stoch_quantize_grouped_ref``)."""
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_ref(
            theta, q_hat_prev, uniforms, delta, qrange,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device))
    out = stoch_quantize_grouped_cuda(theta, q_hat_prev, uniforms, delta,
                                      qrange, group_runs)
    launches["stoch_quantize_grouped"] += 1
    return out


def stoch_quantize_grouped_fused(theta, q_hat_prev, uniforms, bits_prev,
                                 range_prev, initialized, group_ids, *,
                                 group_runs, omega: float, b0: int,
                                 b_max: int):
    """One grouped round with the range reduction folded in (see
    ``ref.stoch_quantize_grouped_fused_ref``). ``REPRO_QUANT_TILE_D=<n>``
    (n > 0) routes it through the D-tiled kernel with n-column tiles, as
    the JAX package's ``ops.stoch_quantize_grouped_fused`` does."""
    tile_d = int(os.environ.get("REPRO_QUANT_TILE_D", "0"))
    if tile_d > 0:
        return stoch_quantize_grouped_fused_tiled(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            group_ids, group_runs=group_runs, omega=omega, b0=b0,
            b_max=b_max, block_d=tile_d)
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_fused_ref(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device),
            group_runs=group_runs, omega=omega, b0=b0, b_max=b_max)
    out = stoch_quantize_grouped_fused_cuda(
        theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
        group_runs, omega, b0, b_max)
    launches["stoch_quantize_grouped_fused"] += 1
    return out


def stoch_quantize_grouped_fused_tiled(theta, q_hat_prev, uniforms,
                                       bits_prev, range_prev, initialized,
                                       group_ids, *, group_runs,
                                       omega: float, b0: int, b_max: int,
                                       block_d: int = 512):
    """The D-tiled twin of :func:`stoch_quantize_grouped_fused`, with the
    same outputs bit for bit."""
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_fused_ref(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device),
            group_runs=group_runs, omega=omega, b0=b0, b_max=b_max)
    out = stoch_quantize_grouped_fused_tiled_cuda(
        theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
        group_runs, omega, b0, b_max, block_d)
    launches["stoch_quantize_grouped_fused_tiled"] += 1
    return out
