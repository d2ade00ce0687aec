"""Primal subproblem solvers for the (CQ-G)GADMM updates.

Every primal update in the paper (Eqs. 8/9, 11/12, 21/22) has the form

    theta_n^{k+1} = argmin_theta  f_n(theta) + <theta, v_n> + (rho d_n / 2) ||theta||^2

This module provides batched-over-workers solvers for the paper's two tasks:

  * linear regression  f_n = 0.5 ||X_n theta - y_n||^2          -> closed form
  * logistic regression f_n = (1/s) sum log(1+exp(-y x'theta)) + mu0/2||theta||^2
                                                                -> Newton steps

plus a generic gradient-descent solver for any differentiable f_n.

The per-worker Gram matrices ``X_n^T X_n`` and ``X_n^T y_n`` of the linear
problem do not depend on v, so they are computed once, at construction. The
solve is ``torch.linalg.solve`` (the JAX package leaves it to XLA too).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


class LinearRegressionProblem:
    """Per-worker least squares: x (N, s, d), y (N, s)."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor):
        self.x = x
        self.y = y
        self.gram = torch.einsum("nsd,nse->nde", x, x)      # (N, d, d)
        self.xty = torch.einsum("nsd,ns->nd", x, y)         # (N, d)

    @property
    def n_workers(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    def local_loss(self, theta: torch.Tensor) -> torch.Tensor:
        """(N,) local objective f_n(theta_n) for stacked theta (N, d)."""
        resid = torch.einsum("nsd,nd->ns", self.x, theta) - self.y
        return 0.5 * torch.sum(resid ** 2, dim=-1)

    def global_loss(self, theta_bar: torch.Tensor) -> torch.Tensor:
        """Scalar sum_n f_n(theta) at a single shared theta (d,)."""
        resid = torch.einsum("nsd,d->ns", self.x, theta_bar) - self.y
        return 0.5 * torch.sum(resid ** 2)

    def optimum(self) -> torch.Tensor:
        """Closed-form consensus optimum of (P1)."""
        gram = self.gram.sum(dim=0)
        rhs = self.xty.sum(dim=0)
        return torch.linalg.solve(gram + 1e-9 * _eye(self.dim, gram), rhs)

    def primal_solve(self, v: torch.Tensor, rho_d: torch.Tensor,
                     theta_init: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Solves (X_n^T X_n + rho d_n I) theta = X_n^T y_n - v_n, batched.
        ``theta_init`` is ignored (closed form)."""
        del theta_init
        lhs = self.gram + rho_d[:, None, None] * _eye(self.dim, self.gram)
        return torch.linalg.solve(lhs, self.xty - v)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionProblem:
    """Per-worker binary logistic regression with L2 term mu0/2 ||theta||^2.

    x: (N, s, d), y: (N, s) in {-1, +1}.
    """

    x: torch.Tensor
    y: torch.Tensor
    mu0: float = 1e-3
    newton_steps: int = 8

    @property
    def n_workers(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    def local_loss(self, theta: torch.Tensor) -> torch.Tensor:
        s = self.x.shape[1]
        margins = self.y * torch.einsum("nsd,nd->ns", self.x, theta)
        nll = torch.sum(torch.nn.functional.softplus(-margins), dim=-1) / s
        return nll + 0.5 * self.mu0 * torch.sum(theta ** 2, dim=-1)

    def global_loss(self, theta_bar: torch.Tensor) -> torch.Tensor:
        s = self.x.shape[1]
        margins = self.y * torch.einsum("nsd,d->ns", self.x, theta_bar)
        nll = torch.sum(torch.nn.functional.softplus(-margins), dim=-1) / s
        reg = 0.5 * self.mu0 * torch.sum(theta_bar ** 2)
        return torch.sum(nll) + self.n_workers * reg

    def optimum(self, steps: int = 200) -> torch.Tensor:
        """Newton solve of the *global* problem (for optimality-gap
        curves), with the gradient and Hessian written out."""
        s = self.x.shape[1]
        theta = torch.zeros(self.dim, dtype=self.x.dtype,
                            device=self.x.device)
        eye = _eye(self.dim, theta)
        reg = self.n_workers * self.mu0
        for _ in range(steps):
            margins = self.y * torch.einsum("nsd,d->ns", self.x, theta)
            sig = torch.sigmoid(-margins)
            grad = (-torch.einsum("ns,ns,nsd->d", self.y, sig, self.x) / s
                    + reg * theta)
            w = sig * (1.0 - sig)
            hess = (torch.einsum("ns,nsd,nse->de", w, self.x, self.x) / s
                    + reg * eye)
            theta = theta - torch.linalg.solve(hess + 1e-9 * eye, grad)
        return theta

    def primal_solve(self, v: torch.Tensor, rho_d: torch.Tensor,
                     theta_init: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Batched Newton solve of the augmented local subproblem."""
        s = self.x.shape[1]
        theta = theta_init if theta_init is not None else torch.zeros(
            (self.n_workers, self.dim), dtype=self.x.dtype,
            device=self.x.device)
        eye = _eye(self.dim, theta)
        for _ in range(self.newton_steps):
            margins = self.y * torch.einsum("nsd,nd->ns", self.x, theta)
            sig = torch.sigmoid(-margins)                        # (N, s)
            grad = (-torch.einsum("ns,ns,nsd->nd", self.y, sig, self.x) / s
                    + (self.mu0 + rho_d[:, None]) * theta + v)
            w = sig * (1.0 - sig)                                # (N, s)
            hess = torch.einsum("ns,nsd,nse->nde", w, self.x, self.x) / s
            hess = hess + (self.mu0 + rho_d)[:, None, None] * eye[None]
            theta = theta - torch.linalg.solve(hess, grad)
        return theta


@dataclasses.dataclass(frozen=True)
class GradientDescentSolver:
    """Generic inexact primal solver: K GD steps on the augmented subproblem.

    local_grad(theta) must return the (N, d) batched gradient of f_n.
    """

    local_grad: Callable[[torch.Tensor], torch.Tensor]
    steps: int = 20
    lr: float = 0.05

    def primal_solve(self, v: torch.Tensor, rho_d: torch.Tensor,
                     theta_init: torch.Tensor) -> torch.Tensor:
        theta = theta_init
        for _ in range(self.steps):
            g = self.local_grad(theta) + v + rho_d[:, None] * theta
            theta = theta - self.lr * g
        return theta
