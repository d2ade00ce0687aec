"""Stochastic quantization of CQ-GGADMM (paper Sec. 5, Eqs. 14-20).

Each worker n transmits, at iteration k, the quantized *difference* between
its current model theta_n^k and its previously quantized model Q̂_n^{k-1}:

  range    R_n^k   = max_i |[theta_n^k]_i - [Q̂_n^{k-1}]_i|      (covers diff)
  step     Δ_n^k   = 2 R_n^k / (2^{b_n^k} - 1)
  coords   c_i     = (theta_i - Q̂prev_i + R) / Δ                 (Eq. 14)
  rounding q_i     = ceil(c_i) w.p. p_i = c_i - floor(c_i)        (Eq. 15/17)
  rebuild  Q̂_n^k  = Q̂_n^{k-1} + Δ_n^k * q - R_n^k * 1           (Eq. 20)

Convergence requires Δ_n^k <= ω Δ_n^{k-1}, enforced by growing the bit width
per Eq. (18):

  b_n^k >= ceil( log2( 1 + (2^{b_n^{k-1}} - 1) R_n^k / (ω R_n^{k-1}) ) ).

Everything here is float32 tensor code with the JAX reference's operation
order, so the schedule tables agree with ``repro.core.quantization``
exactly. The elementwise quantize chain itself is the ``stoch_quantize``
kernel (``repro_torch/kernels``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_EPS = 1e-12
# float32 ln 2. The JAX reference evaluates exp2(x) as exp(x ln 2) and
# log2(x) as log(x) / ln 2 (XLA expands them so), which makes 2^13 - 1 come
# out as 8191.004. The schedule below does the same, so its bit widths and
# step sizes agree with the reference exactly, not to an ulp.
_LN2 = 0.693147182


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x * _LN2)


def _log2(x: torch.Tensor) -> torch.Tensor:
    # divide by a tensor on x's device: PyTorch on CUDA turns a division by
    # a Python scalar into a multiply by its reciprocal, which rounds
    # differently from the true division the CPU and the kernels do
    return torch.log(x) / torch.tensor(_LN2, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    b0: int = 2            # initial bit width
    omega: float = 0.99    # step-size contraction factor ω in (0,1)
    b_max: int = 16        # cap on per-dimension bit width
    b_overhead: int = 64   # b_R + b_b side-information bits per transmission

    def __post_init__(self):
        if not 0.0 < self.omega < 1.0:
            raise ValueError(f"omega must be in (0, 1), got {self.omega}")
        if not 1 <= self.b0 <= self.b_max:
            raise ValueError(f"need 1 <= b0 <= b_max, got {self.b0}, "
                             f"{self.b_max}")


def required_bits(bits_prev: torch.Tensor, range_new: torch.Tensor,
                  range_prev: torch.Tensor, omega: float,
                  initialized: torch.Tensor, b0: int, b_max: int
                  ) -> torch.Tensor:
    """Bit-growth rule of Eq. (18), elementwise over float32 tensors.

    First iteration (initialized == 0) uses b0. Degenerate previous ranges
    keep the previous width.
    """
    levels_prev = _exp2(bits_prev) - 1.0
    ratio = range_new / torch.clamp_min(omega * range_prev, _EPS)
    b_new = torch.ceil(_log2(1.0 + levels_prev * ratio))
    b_new = torch.where(range_prev <= _EPS, bits_prev, b_new)
    b_new = torch.where(initialized > 0, b_new,
                        torch.full_like(b_new, float(b0)))
    return torch.clamp(b_new, 1.0, float(b_max))


def bit_schedule(bits_prev: torch.Tensor, range_new: torch.Tensor,
                 range_prev: torch.Tensor, initialized: torch.Tensor,
                 omega: float, b0: int, b_max: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. (18) bit growth plus the step size Δ = 2R / (2^b - 1) and the
    degenerate-range flag. Returns ``(bits, delta, degen)``."""
    bits = required_bits(bits_prev, range_new, range_prev, omega,
                         initialized, b0, b_max)
    levels = _exp2(bits) - 1.0
    delta = 2.0 * range_new / torch.clamp_min(levels, 1.0)
    degen = range_new <= _EPS
    return bits, delta, degen


def stochastic_round(c: torch.Tensor, uniforms: torch.Tensor
                     ) -> torch.Tensor:
    """Eq. (15)/(17): round c up with probability frac(c), down otherwise."""
    floor_c = torch.floor(c)
    return floor_c + (uniforms < (c - floor_c)).to(c.dtype)
