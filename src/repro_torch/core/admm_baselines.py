"""Benchmark schemes of Sec. 7 as ``EngineConfig`` presets.

* C-ADMM (Liu et al., 2019b): censoring on top of the *Jacobian*
  decentralized ADMM — all workers update and transmit in parallel every
  iteration, no worker grouping, no quantization (``alternating=False``).
* GGADMM / C-GGADMM / CQ-GGADMM and the Q-GGADMM ablation (quantization
  without censoring).
"""
from __future__ import annotations

from repro_torch.core.censoring import CensorConfig
from repro_torch.core.engine import EngineConfig as ADMMConfig
from repro_torch.core.quantization import QuantConfig


def ggadmm(rho: float = 1.0) -> ADMMConfig:
    return ADMMConfig(rho=rho, alternating=True)


def c_ggadmm(rho: float = 1.0, tau0: float = 1.0, xi: float = 0.8) -> ADMMConfig:
    return ADMMConfig(rho=rho, alternating=True,
                      censor=CensorConfig(tau0=tau0, xi=xi))


def cq_ggadmm(rho: float = 1.0, tau0: float = 1.0, xi: float = 0.8,
              b0: int = 2, omega: float = 0.99) -> ADMMConfig:
    return ADMMConfig(rho=rho, alternating=True,
                      censor=CensorConfig(tau0=tau0, xi=xi),
                      quantize=QuantConfig(b0=b0, omega=omega))


def q_ggadmm(rho: float = 1.0, b0: int = 2, omega: float = 0.99) -> ADMMConfig:
    return ADMMConfig(rho=rho, alternating=True,
                      quantize=QuantConfig(b0=b0, omega=omega))


def c_admm(rho: float = 1.0, tau0: float = 1.0, xi: float = 0.8) -> ADMMConfig:
    """Censored Jacobian decentralized ADMM (Liu et al., 2019b)."""
    return ADMMConfig(rho=rho, alternating=False,
                      censor=CensorConfig(tau0=tau0, xi=xi))


def jacobian_admm(rho: float = 1.0) -> ADMMConfig:
    return ADMMConfig(rho=rho, alternating=False)


ALL_SCHEMES = {
    "ggadmm": ggadmm,
    "c-ggadmm": c_ggadmm,
    "cq-ggadmm": cq_ggadmm,
    "q-ggadmm": q_ggadmm,
    "c-admm": c_admm,
    "jacobian-admm": jacobian_admm,
}
