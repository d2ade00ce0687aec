"""The kernels' entry points: the plain version for a CPU tensor, the CUDA
kernel for a CUDA tensor. There is no fall-back: a CUDA tensor that the
kernel does not take raises, and so does a failed build or launch.

``launches`` counts kernel launches by name. It is bumped only where a
kernel is launched (never on the CPU path), so a run can show that the main
path went through the kernels: set the counts to 0 before the run and read
them after.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bipartite_mix import bipartite_mix_cuda
from repro_torch.kernels.stoch_quant import stoch_quantize_cuda

KERNELS = ("stoch_quantize", "bipartite_mix")
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
