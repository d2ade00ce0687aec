"""Theorem 3 machinery: topology constants, the penalty bound rho_bar of
Eq. (150), and the linear contraction factor (1 + delta_2)/2 of Eq. (39).
A numpy-only copy of ``repro.core.theory`` (the port imports nothing of the
JAX package), held to the original by ``tests/test_torch_figures.py``.

The proof's free parameters (eta_0..eta_5, eta > 1, kappa in (0, kappa_bar))
are searched over a small grid; ``best_rate_bound`` returns the tightest
valid certificate. Used by tests/benchmarks to check that the *measured*
contraction of ||theta^k - theta*||_F^2 respects the certified rate, and
that the bound orders topologies the way Fig. 6 does (denser graph =>
better sigma_min(M_-) => smaller certified rate).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.core.graph import WorkerGraph


def topology_constants(graph: WorkerGraph) -> dict:
    """sigma_max(C), sigma_max(M_-), min nonzero singular value of M_-."""
    c = graph.c_matrix
    m_minus = graph.signed_incidence
    sc = np.linalg.svd(c, compute_uv=False)
    sm = np.linalg.svd(m_minus, compute_uv=False)
    nonzero = sm[sm > 1e-8]
    return {
        "sigma_max_C": float(sc[0]),
        "sigma_max_M": float(sm[0]),
        "sigma_min_M": float(nonzero[-1]),
    }


@dataclasses.dataclass(frozen=True)
class RateCertificate:
    feasible: bool
    rho_bar: float
    rate: float          # (1 + delta_2) / 2 — contraction of Eq. (39)
    kappa: float
    delta: float         # discriminant of Eq. (149)
    constants: dict


def rate_bound(graph: WorkerGraph, mu: float, lips: float, *,
               rho: float, kappa: float,
               etas=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0), eta: float = 2.0,
               psi: float = 0.0) -> RateCertificate:
    """Evaluate the Thm-3 certificate at one parameter point.

    etas = (eta0, eta1, eta3, eta4, eta5) ordering per Appendix D (eta2 is
    fixed to 2 kappa / rho inside the proof); psi = max(xi, omega) for
    CQ-GGADMM, 0 for exact GGADMM.
    """
    tc = topology_constants(graph)
    s_c2 = tc["sigma_max_C"] ** 2
    s_m2 = tc["sigma_min_M"] ** 2
    eta0, eta1, eta3, eta4, eta5, *_ = tuple(etas) + (1.0,)
    b1 = eta1 * s_c2 / 2.0
    b2 = (eta0 / 2.0 * s_c2 + 1.0 / (2 * eta0) + 1.0 / (2 * eta1)
          + eta3 / 2.0 + eta4 / 2.0 + eta5 / 4.0)
    c = 4.0 * eta * lips ** 2 / s_m2
    a = 8.0 * eta * s_c2 / ((eta - 1.0) * s_m2)
    delta = mu ** 2 - 4.0 * c * kappa * (
        (b2 + a * kappa) + (1.0 + kappa) * (b1 + a * kappa))
    if delta <= 0:
        return RateCertificate(False, 0.0, 1.0, kappa, delta, tc)
    rho_bar = (mu + np.sqrt(delta)) / (
        (b2 + a * kappa) + (1.0 + kappa) * (b1 + a * kappa))
    feasible = 0.0 < rho < rho_bar
    delta2 = max(1.0 / (1.0 + kappa), psi ** 2)
    rate = (1.0 + delta2) / 2.0
    return RateCertificate(feasible, float(rho_bar), float(rate), kappa,
                           float(delta), tc)


def _kappa_bar(graph, mu, lips, *, etas, eta) -> float:
    """Largest kappa with Delta > 0 (bisection; Delta is decreasing in
    kappa, Delta(0) = mu^2 > 0)."""
    lo, hi = 0.0, 1.0
    while rate_bound(graph, mu, lips, rho=1e-30, kappa=hi, etas=etas,
                     eta=eta).delta > 0 and hi < 1e6:
        lo, hi = hi, hi * 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if rate_bound(graph, mu, lips, rho=1e-30, kappa=mid, etas=etas,
                      eta=eta).delta > 0:
            lo = mid
        else:
            hi = mid
    return lo


def best_rate_bound(graph: WorkerGraph, mu: float, lips: float, *,
                    rho: float, psi: float = 0.0,
                    eta_grid=(1.5, 2.0, 4.0, 8.0),
                    eta_i_grid=(0.1, 0.3, 1.0, 3.0)
                    ) -> Optional[RateCertificate]:
    """Search the proof's free parameters for the tightest feasible
    certificate: per (eta, eta_i), take kappa just inside the analytic
    kappa_bar (the largest with Delta > 0), check rho < rho_bar, keep the
    smallest certified rate."""
    best: Optional[RateCertificate] = None
    for eta in eta_grid:
        for e_i in eta_i_grid:
            etas = (e_i,) * 5
            kb = _kappa_bar(graph, mu, lips, etas=etas, eta=eta)
            if kb <= 0:
                continue
            for frac in (0.9, 0.5, 0.1):
                cert = rate_bound(graph, mu, lips, rho=rho,
                                  kappa=frac * kb, etas=etas, eta=eta,
                                  psi=psi)
                if cert.feasible and (best is None
                                      or cert.rate < best.rate):
                    best = cert
    return best


def linreg_convexity(x: np.ndarray) -> tuple:
    """(mu, L) of the stacked per-worker least-squares objectives:
    mu = min_n lambda_min(X_n^T X_n), L = max_n lambda_max(X_n^T X_n)."""
    mus, lips = [], []
    for xn in x:
        eig = np.linalg.eigvalsh(xn.T @ xn)
        mus.append(eig[0])
        lips.append(eig[-1])
    return float(min(mus)), float(max(lips))
