"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (``kernels.ops``), what the tests hold
against the JAX package's ``repro.kernels.ref``, and what ``chip_smoke.py``
holds each CUDA kernel against on the card. Each repeats its kernel's
arithmetic in the same order; none is a yardstick of speed.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def stoch_quantize_ref(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                       uniforms: torch.Tensor, delta: torch.Tensor,
                       qrange: torch.Tensor) -> torch.Tensor:
    """Fused quantize -> dequantize (paper Eqs. 14, 15, 20).

    theta, q_hat_prev, uniforms: (N, d); delta, qrange: (N,) per-worker
    step size Δ and range R. All math in float32; Δ is floored at 1e-12.
    Returns the (N, d) reconstruction Q̂^k = Q̂^{k-1} + Δ q - R in
    ``theta``'s dtype."""
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    unif32 = uniforms.to(torch.float32)
    safe_delta = torch.clamp_min(delta.to(torch.float32), _EPS)[:, None]
    r = qrange.to(torch.float32)[:, None]
    c = (theta32 - qprev32 + r) / safe_delta
    floor_c = torch.floor(c)
    q = floor_c + (unif32 < (c - floor_c)).to(torch.float32)
    levels = 2.0 * r / safe_delta            # = 2^b - 1
    q = torch.minimum(torch.clamp_min(q, 0.0), levels)
    return (qprev32 + safe_delta * q - r).to(theta.dtype)


def bipartite_mix_ref(adjacency: torch.Tensor, values: torch.Tensor
                      ) -> torch.Tensor:
    """Neighbor aggregation ``A @ V``: adjacency (M, N) cast to the values'
    dtype, values (N, d) -> (M, d)."""
    return adjacency.to(values.dtype) @ values
