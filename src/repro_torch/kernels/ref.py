"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (``kernels.ops``), what the tests hold
against the JAX package's ``repro.kernels.ref``, and what ``chip_smoke.py``
holds each CUDA kernel against on the card. Each repeats its kernel's
arithmetic in the same order; none is a yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import bit_schedule

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


def stoch_quantize_grouped_ref(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                               uniforms: torch.Tensor, delta: torch.Tensor,
                               qrange: torch.Tensor,
                               group_ids: torch.Tensor) -> torch.Tensor:
    """Grouped quantize -> dequantize over a packed buffer (Eqs. 14-20,
    group-wise). theta, q_hat_prev, uniforms: (N, D); delta, qrange: (N, G);
    group_ids: (D,) integer column -> group map. Column j takes the side
    information of group ``group_ids[j]``; G=1 is
    :func:`stoch_quantize_ref` bit for bit."""
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    unif32 = uniforms.to(torch.float32)
    gid = group_ids.to(device=theta.device, dtype=torch.int64)
    delta_c = delta.to(torch.float32).index_select(1, gid)       # (N, D)
    range_c = qrange.to(torch.float32).index_select(1, gid)
    safe_delta = torch.clamp_min(delta_c, _EPS)
    c = (theta32 - qprev32 + range_c) / safe_delta
    floor_c = torch.floor(c)
    q = floor_c + (unif32 < (c - floor_c)).to(torch.float32)
    levels = 2.0 * range_c / safe_delta      # = 2^{b_g} - 1, column-wise
    q = torch.minimum(torch.clamp_min(q, 0.0), levels)
    return (qprev32 + safe_delta * q - range_c).to(theta.dtype)


def grouped_range_ref(diff: torch.Tensor, group_runs) -> torch.Tensor:
    """Per-worker per-group ``max |diff|`` over each group's static
    contiguous column runs: (N, G). Max does not depend on order, so any
    reduction order gives the same bits."""
    absdiff = torch.abs(diff)
    cols = []
    for runs in group_runs:
        parts = [torch.amax(absdiff[:, off:off + size], dim=1)
                 for off, size in runs]
        if not parts:
            parts = [torch.zeros((diff.shape[0],), dtype=torch.float32,
                                 device=diff.device)]
        cols.append(parts[0] if len(parts) == 1
                    else torch.amax(torch.stack(parts, dim=0), dim=0))
    return torch.stack(cols, dim=1)


def stoch_quantize_grouped_fused_ref(
    theta: torch.Tensor, q_hat_prev: torch.Tensor, uniforms: torch.Tensor,
    bits_prev: torch.Tensor, range_prev: torch.Tensor,
    initialized: torch.Tensor, group_ids: torch.Tensor, *, group_runs,
    omega: float, b0: int, b_max: int,
):
    """One whole grouped round: range reduction over the group runs, the
    Eq. (18) bit schedule (``core.quantization.bit_schedule``), the grouped
    quantize, and degenerate groups (R <= 1e-12) passed through unchanged.
    Returns ``(out (N, D), range_new, bits, delta)``, the last three
    (N, G) float32."""
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    range_new = grouped_range_ref(theta32 - qprev32, group_runs)
    bits, delta, degen = bit_schedule(
        bits_prev.to(torch.float32), range_new,
        range_prev.to(torch.float32), initialized.to(torch.float32),
        omega, b0, b_max)
    out = stoch_quantize_grouped_ref(theta, q_hat_prev, uniforms, delta,
                                     range_new, group_ids)
    gid = group_ids.to(device=theta.device, dtype=torch.int64)
    degen_c = degen.index_select(1, gid)
    out = torch.where(degen_c, qprev32.to(out.dtype), out)
    return out, range_new, bits, delta.to(torch.float32)


def bipartite_mix_ref(adjacency: torch.Tensor, values: torch.Tensor
                      ) -> torch.Tensor:
    """Neighbor aggregation ``A @ V``: adjacency (M, N) cast to the values'
    dtype, values (N, d) -> (M, d)."""
    return adjacency.to(values.dtype) @ values
