"""The benchmark's yardstick for device work: the H100's peaks and the bytes
and operations of each measured kernel and of a whole step.

The kernel functions are frozen copies of the port's roofline arithmetic
(``repro_torch/bench/roofline.py`` as of its first benchmark): each input
byte read once, each output byte written once, the float32 operations at
the rate outside the tensor cores. A kernel's least time is the larger of
its bytes over the memory rate and its operations over the float32 rate.
They are copied, not imported, so that a change to the program cannot move
the yardstick.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of the quantizer per element: sub, add, div, floor,
# sub, compare, add, max, min, mul, add, sub
QUANT_OPS_PER_ELEM = 12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least time in seconds of ``n_bytes`` moved and ``n_ops`` float32
    operations."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS)


def quant_work(n: int, d: int) -> Tuple[float, float]:
    """B1 (``stoch_quantize``) on (n, d): theta, q_prev and the uniforms
    read, the reconstruction written; the (n,) step and range read."""
    return 4.0 * (4 * n * d + 2 * n), float(QUANT_OPS_PER_ELEM * n * d + 2 * n)


def mix_work(m: int, n: int, d: int) -> Tuple[float, float]:
    """B2 (``bipartite_mix``) on an (m, n) adjacency and (n, d) float32
    values: the adjacency and values read, (m, d) written; a multiply-add
    per (m, n, d)."""
    return 4.0 * (m * n + n * d + m * d), 2.0 * m * n * d


def edge_work(table: np.ndarray, valid: np.ndarray, d: int
              ) -> Tuple[float, float]:
    """B6 (``edge_gather_mix``) over a degree-padded (N, S) neighbour table
    and its validity: the V rows a valid slot references, once, out
    written once, the table and validity read once; a multiply-add per
    valid slot and column."""
    n = table.shape[0]
    referenced = np.unique(table[valid > 0]).size
    n_bytes = 4.0 * referenced * d + 4.0 * n * d + 8.0 * table.size
    return n_bytes, 2.0 * float(valid.sum()) * d


def convex_step_work(n: int, d: int) -> Tuple[float, float]:
    """The least work of one CQ-GGADMM iteration of per-worker least
    squares, whatever the method: every worker solves one (d, d) system
    whose matrix ``X_n^T X_n + rho d_n I`` it cannot hold in any cache, so
    it reads d*d float32 values once, and applies a factor or inverse made
    beforehand (two triangular solves: 2 d*d operations). The vectors of the
    step (theta, the replicas, the duals, the draws: a few (N, d) arrays)
    are left out, as is the one-off factorisation."""
    return 4.0 * n * d * d, 2.0 * n * d * d


# bfloat16 dense products on the tensor cores (NVIDIA's data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
# bytes per element of a grouped quantize round: theta, q_prev and the
# uniforms read once, the reconstruction written once
GROUPED_BYTES_PER_ELEM = 16


def grouped_work(n_el: int) -> Tuple[float, float]:
    """B3 (``stoch_quantize_grouped_fused``) on a packed buffer of
    ``n_el`` elements; the (N, G) side arrays are left out."""
    return (float(GROUPED_BYTES_PER_ELEM * n_el),
            float(QUANT_OPS_PER_ELEM * n_el))


def lm_step_flops(token_flops: float, tokens: int,
                  local_steps: int) -> float:
    """The model operations a consensus step requires: forward and
    backward (twice the forward) of every acting worker's ``tokens`` in
    each of its ``local_steps``, at ``token_flops`` forward operations a
    token (the ``token_flops`` of the configuration's reference model); the
    loss the step reports is left out."""
    return 3.0 * token_flops * tokens * local_steps
