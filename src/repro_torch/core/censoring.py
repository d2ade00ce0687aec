"""Communication censoring (paper Sec. 4).

A worker transmits at iteration k+1 only if its candidate transmission moved
enough relative to the *last transmitted* state:

    transmit  <=>  || state_last - candidate || >= tau^{k+1},
    tau^k = tau0 * xi^k,   tau0 > 0, xi in (0, 1).

For CQ-GGADMM the candidate is the quantized reconstruction Q̂_n^{k+1}
(Algorithm 2 line 7/15). tau0 = 0 disables censoring (GGADMM).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CensorConfig:
    tau0: float = 0.0       # 0 disables censoring
    xi: float = 0.8         # decay rate, in (0, 1)

    def __post_init__(self):
        if self.tau0 < 0.0:
            raise ValueError(f"tau0 must be >= 0, got {self.tau0}")
        if not 0.0 < self.xi < 1.0:
            raise ValueError(f"xi must be in (0, 1), got {self.xi}")

    @property
    def enabled(self) -> bool:
        return self.tau0 > 0.0


def threshold(cfg: CensorConfig, k: int,
              device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """tau^k = tau0 * xi^k in float32, as a 0-d tensor on ``device``. A
    subnormal result is flushed to 0, as the JAX reference's XLA flushes
    float32 subnormals, so both reach tau = 0 at the same k."""
    xi = torch.tensor(cfg.xi, dtype=torch.float32, device=device)
    tau = cfg.tau0 * torch.pow(xi, float(k))
    return torch.where(tau < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(tau), tau)


def group_thresholds(tau: torch.Tensor, group_dims: Tuple[int, ...],
                     total_dim: int) -> torch.Tensor:
    """Per-group thresholds ``tau_g = tau * sqrt(d_g / d)``: the squared
    thresholds partition the global censor budget, so group-mode censoring
    is the paper's single test at G=1. Returns (G,)."""
    dims = torch.tensor(group_dims, dtype=torch.float32, device=tau.device)
    return tau * torch.sqrt(dims / max(float(total_dim), 1.0))


def group_censor_mask(change_g: torch.Tensor, tau_g: torch.Tensor
                      ) -> torch.Tensor:
    """(N, G) float 0/1 mask: group g of worker n transmits iff its norm
    moved at least tau_g. ``change_g``: (N, G) per-group change norms."""
    return (change_g >= tau_g[None, :]).to(torch.float32)


def censor_mask(last_sent: torch.Tensor, candidate: torch.Tensor,
                cfg: CensorConfig, k_next: int) -> torch.Tensor:
    """(N,) float 0/1 mask: 1 => worker transmits this round.

    ``last_sent``/``candidate``: (N, d); ``k_next`` is the iteration index
    k+1 at which the threshold is evaluated."""
    if not cfg.enabled:
        return torch.ones(last_sent.shape[0], dtype=last_sent.dtype,
                          device=last_sent.device)
    change = torch.linalg.vector_norm(candidate - last_sent, dim=-1)
    tau = threshold(cfg, k_next, last_sent.device)
    return (change >= tau).to(last_sent.dtype)


def compose_tx_mask(timeout_mask: torch.Tensor, censor_mask: torch.Tensor,
                    group_censor_mask: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a timeout into the censoring decision: a timed-out worker is a
    censored worker, ``tx = timeout & censor`` per worker and per group
    (float 0/1 masks, so ``&`` is a product)."""
    tm = timeout_mask.to(censor_mask.dtype)
    return censor_mask * tm, group_censor_mask * tm[:, None]
