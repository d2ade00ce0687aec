"""Plain CQ-GGADMM consensus training of a language model (the paper's
Algorithm 2 with an inexact local solve), and the training comparison.

Written from the paper's equations in plain PyTorch over the per-worker
parameters of ``reference/xlstm.py`` (a dict by path, leading worker axis
N); it imports nothing of the program. Per step, heads then tails:

  v_n      = alpha_n - rho sum_{m in N_n} theta_hat_m
  theta_n  <- K Adam steps (b1 0.9, b2 0.95, eps 1e-8, the moments kept
              from step to step, the bias correction restarted each solve)
              on f_n(theta) + <theta, v_n> + rho d_n / 2 ||theta||^2,
              f_n the worker's mean cross entropy on its own rows
  per leaf l (a quantization group): R = max |theta_l - Qhat_l|,
              b = ceil(log2(1 + (2^b' - 1) R / (omega R'))) (b0 at first),
              Delta = 2 R / (2^b - 1), stochastic rounding of
              (theta_l - Qhat_l + R) / Delta, Qhat_l <- Qhat_l + Delta q - R
  transmit iff ||Qhat - theta_hat|| (all leaves) >= tau0 xi^{k+1}
  alpha   += rho (D - A) theta_hat

The stochastic-rounding uniforms of a phase are one (N, P) draw, P the
parameter count, whose columns are the leaves in the order of their paths,
each flattened row-major. The loss a step reports is the workers' mean
loss after the step on the step's rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import xlstm

Path = xlstm.Path
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Settings:
    rho: float
    tau0: float
    xi: float
    b0: int
    omega: float
    b_max: int
    local_steps: int
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    @staticmethod
    def of(cfg: dict) -> "Settings":
        return Settings(cfg["rho"], cfg["tau0"], cfg["xi"], cfg["bits"],
                        cfg["omega"], cfg["b_max"], cfg["local_steps"],
                        cfg["lr"])


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


class Trainer:
    """The whole consensus state, and its steps."""

    def __init__(self, params0: Dict[Path, torch.Tensor], n: int, graph,
                 model: dict, s: Settings, act: xlstm.Act):
        self.s, self.model, self.act, self.graph = s, model, act, graph
        dev = next(iter(params0.values())).device
        self.adj = torch.as_tensor(graph.adjacency, device=dev)
        self.deg = torch.as_tensor(graph.degrees, device=dev)
        self.theta = {p: x[None].repeat((n,) + (1,) * x.dim())
                      for p, x in params0.items()}
        zeros = {p: torch.zeros_like(x) for p, x in self.theta.items()}
        self.hat = {p: x.clone() for p, x in zeros.items()}
        self.alpha = {p: x.clone() for p, x in zeros.items()}
        self.q = {p: x.clone() for p, x in zeros.items()}
        self.mu = {p: x.clone() for p, x in zeros.items()}
        self.nu = zeros
        g = len(params0)
        side = torch.zeros((n, g), dtype=torch.float64, device=dev)
        self.r_prev, self.delta = side, side.clone()
        self.bits = side + s.b0
        self.init = side.clone()
        self.k = 0
        self.paths = list(params0)
        sizes = [int(np.prod(x.shape)) for x in params0.values()]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()

    def _mix(self, tree):
        return {p: torch.einsum("nm,m...->n...", self.adj, x)
                for p, x in tree.items()}

    def _solve(self, rows, v, tokens, labels):
        s, quad = self.s, self.s.rho * self.deg[rows]
        th = {p: x[rows] for p, x in self.theta.items()}
        mu = {p: x[rows] for p, x in self.mu.items()}
        nu = {p: x[rows] for p, x in self.nu.items()}
        for i in range(s.local_steps):
            leaves = {p: x.detach().requires_grad_(True)
                      for p, x in th.items()}
            with torch.enable_grad():
                total = xlstm.losses(leaves, tokens[rows], labels[rows],
                                     self.model, self.act).sum()
                grads = torch.autograd.grad(total, list(leaves.values()))
            b1c, b2c = 1.0 - s.b1 ** (i + 1), 1.0 - s.b2 ** (i + 1)
            for p, g in zip(th, grads):
                g = g + v[p][rows] + _per_row(quad, g) * th[p]
                mu[p] = s.b1 * mu[p] + (1 - s.b1) * g
                nu[p] = s.b2 * nu[p] + (1 - s.b2) * g.square()
                th[p] = th[p] - s.lr * (mu[p] / b1c) / (
                    torch.sqrt(nu[p] / b2c) + s.eps)
        for p in th:
            self.theta[p][rows] = th[p].detach()
            self.mu[p][rows] = mu[p]
            self.nu[p][rows] = nu[p]

    def _quantize(self, rows, u):
        s, out = self.s, {}
        for g, p in enumerate(self.paths):
            th, q = self.theta[p][rows], self.q[p][rows]
            diff = (th - q).reshape(len(rows), -1)
            r = diff.abs().amax(dim=1).to(torch.float64)
            r_prev, b_prev = self.r_prev[rows, g], self.bits[rows, g]
            bits = torch.ceil(torch.log2(1.0 + (torch.exp2(b_prev) - 1.0)
                                         * r / torch.clamp_min(
                                             s.omega * r_prev, _EPS)))
            bits = torch.where(r_prev <= _EPS, b_prev, bits)
            bits = torch.where(self.init[rows, g] > 0, bits,
                               torch.full_like(bits, s.b0))
            bits = torch.clamp(bits, 1.0, float(s.b_max))
            levels = torch.exp2(bits) - 1.0
            delta = 2.0 * r / torch.clamp_min(levels, 1.0)
            uu = u[rows, self.offsets[g]:self.offsets[g + 1]]
            r32 = r.to(torch.float32)[:, None]
            c = (diff + r32) / torch.clamp_min(delta, _EPS).to(
                torch.float32)[:, None]
            low = torch.floor(c)
            level = torch.minimum((low + (uu < c - low).float()).clamp_min(0),
                                  levels.to(torch.float32)[:, None])
            new = (q.reshape(len(rows), -1) + delta.to(torch.float32)[:, None]
                   * level - r32)
            degen = (r <= _EPS)[:, None]
            out[p] = torch.where(degen, q.reshape(len(rows), -1),
                                 new).reshape(q.shape)
            self.r_prev[rows, g] = torch.where(r <= _EPS, r_prev, r)
            self.delta[rows, g] = torch.where(r <= _EPS, self.delta[rows, g],
                                              delta)
            self.bits[rows, g] = bits
            self.init[rows, g] = 1.0
        return out

    def step(self, tokens, labels, u0, u1) -> float:
        """One step on the (N, B, S) rows with the two phases' (N, P)
        uniforms; returns the reported loss."""
        s = self.s
        head = torch.as_tensor(self.graph.head_mask, device=self.adj.device)
        tau = s.tau0 * s.xi ** (self.k + 1)
        for mask, u in ((head, u0), (~head, u1)):
            rows = torch.nonzero(mask)[:, 0]
            neigh = self._mix(self.hat)
            v = {p: self.alpha[p] - s.rho * neigh[p] for p in neigh}
            self._solve(rows, v, tokens, labels)
            q_new = self._quantize(rows, u)
            change = torch.sqrt(sum(
                (q_new[p] - self.hat[p][rows]).reshape(len(rows), -1)
                .square().sum(dim=1) for p in self.paths))
            tx = change >= tau
            for p in self.paths:
                keep = _per_row(tx, q_new[p])
                self.hat[p][rows] = torch.where(keep, q_new[p],
                                                self.hat[p][rows])
                self.q[p][rows] = q_new[p]
        neigh = self._mix(self.hat)
        for p in self.paths:
            self.alpha[p] = self.alpha[p] + s.rho * (
                _per_row(self.deg, self.hat[p]) * self.hat[p] - neigh[p])
        self.k += 1
        with torch.no_grad():
            return float(xlstm.losses(self.theta, tokens, labels, self.model,
                                      self.act).mean())


def leaf_norms(tree: Dict[Path, torch.Tensor]) -> Dict[Path, float]:
    return {p: float(torch.linalg.vector_norm(x.float())) for p, x in
            tree.items()}


def run(params0, n: int, graph, model: dict, s: Settings,
        batches: Sequence, draws: Callable[[], torch.Tensor],
        act: xlstm.Act) -> dict:
    """The reference's (or the control's) first ``len(batches)`` steps:
    each step's loss, the moments' leaf norms after the first step and the
    leaves' change norms after the last."""
    tr = Trainer(params0, n, graph, model, s, act)
    losses: List[float] = []
    mu_norms = None
    for i, (tokens, labels) in enumerate(batches):
        losses.append(tr.step(tokens, labels, draws(), draws()))
        if i == 0:
            mu_norms = leaf_norms(tr.mu)
    change = leaf_norms({p: tr.theta[p] - params0[p][None]
                         for p in tr.paths})
    return {"losses": losses, "mu_norms": mu_norms, "change_norms": change}


def compare(program: dict, reference: dict) -> Dict[str, float]:
    """The training readings: ``loss_gap``, the worst step's relative gap
    of the reported loss; ``grad_gap`` and ``change_gap``, the worst leaf's
    gap between the program's and the reference's norms of the first
    step's moments and of the change over the steps, each against the
    larger of that leaf's reference norm and the median leaf's. Leaves
    whose reference moment is under a thousandth of the median leaf's move
    by round-off alone and are left out of the change."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(program["losses"], reference["losses"]))}
    ref_mu = reference["mu_norms"]
    med_mu = float(np.median(list(ref_mu.values())))
    moving = [p for p in ref_mu if ref_mu[p] >= 1e-3 * med_mu]
    for key, name, paths in (("mu_norms", "grad_gap", list(ref_mu)),
                             ("change_norms", "change_gap", moving)):
        want = reference[key]
        med = float(np.median([want[p] for p in paths]))
        out[name] = max(abs(program[key][p] - want[p]) / max(want[p], med)
                        for p in paths)
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: math.inf for k in out}
    return out
