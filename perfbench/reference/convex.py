"""Plain CQ-GGADMM (the paper's Algorithm 2) on per-worker least squares,
and the stage-by-stage judge of the program's iterations.

Written from the paper's equations in plain PyTorch, in float64 for the
reference; it imports nothing of the program. Per iteration, heads then
tails:

  v_n      = alpha_n - rho sum_{m in N_n} theta_hat_m
  theta_n  = (X_n^T X_n + rho d_n I)^{-1} (X_n^T y_n - v_n)      (Eqs. 21/22)
  R_n      = max_i |theta_n,i - Qhat_n,i|                         (Eq. 14)
  b_n      = ceil(log2(1 + (2^{b_n'} - 1) R_n / (omega R_n')))    (Eq. 18)
  Delta_n  = 2 R_n / (2^{b_n} - 1)
  c        = (theta_n - Qhat_n + R_n) / Delta_n,  q = floor(c) + [u < frac c]
  Qhat_n  <- Qhat_n + Delta_n q - R_n                             (Eq. 20)
  transmit iff ||Qhat_n - theta_hat_n|| >= tau0 xi^{k+1}         (Sec. 4)
  alpha   += rho (D - A) theta_hat                                (Eq. 23)

The first iteration takes b0 bits; a range of 0 keeps the previous step.
The local systems are solved by a Cholesky factor of each worker's matrix,
made once per graph (a different method from the program's).

:func:`check_step` judges one iteration of the program from its state
before and after: each stage is recomputed from the program's own inputs to
that stage, so that an iteration is judged by itself (stochastic rounding
makes two correct float trajectories part at a rounding tie). Discrete
outcomes are compared exactly, except where the reference's own value lies
within the float32 evaluation's rounding of the decision's edge: there
either outcome is right.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_EPS = 1e-12
# the band around a decision's edge in which either outcome is right: a
# float32 evaluation of c = (theta - Qhat + R) / Delta is a few ulp off
LEVEL_TIE = 1e-6          # of max(1, c)
BITS_TIE = 1e-5           # of the log2 before its ceiling
CENSOR_TIE = 1e-5         # of tau
RANGE_TOL = 1e-6          # relative, R: a max of float32 differences
DELTA_TOL = 1e-5          # relative, Delta: 2^b - 1 through exp/log in f32
GRID_TOL = 1e-2           # a reconstruction's level off an integer
F32_ULP = 2.0 ** -23


@dataclasses.dataclass(frozen=True)
class Precision:
    """The arithmetic of a run of the reference: its dtype, and whether
    every product's operands are first rounded to TF32 (10 explicit
    mantissa bits), as the tensor cores' TF32 mode does."""
    dtype: torch.dtype
    tf32: bool = False


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, tf32=True)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties away)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return (tf32(x) if prec.tf32 else x).to(prec.dtype)


@dataclasses.dataclass(frozen=True)
class Scheme:
    """CQ-GGADMM's settings (the configuration's)."""
    rho: float
    tau0: float
    xi: float
    b0: int
    omega: float
    b_max: int

    @staticmethod
    def of(cfg: dict) -> "Scheme":
        return Scheme(cfg["rho"], cfg["tau0"], cfg["xi"], cfg["b0"],
                      cfg["omega"], cfg["b_max"])

    def tau(self, k: int) -> float:
        return self.tau0 * self.xi ** k


class Problem:
    """Per-worker least squares in one precision: the Gram matrices and
    ``X^T y`` worked out from the data in blocks of workers, and one
    Cholesky factor per set of degrees."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, rho: float,
                 prec: Precision, block: int = 8):
        n, _, d = x.shape
        self.rho, self.prec = rho, prec
        self.gram = torch.empty((n, d, d), dtype=prec.dtype, device=x.device)
        self.xty = torch.empty((n, d), dtype=prec.dtype, device=x.device)
        for lo in range(0, n, block):
            xb = _operand(x[lo:lo + block], prec)
            yb = _operand(y[lo:lo + block], prec)
            self.gram[lo:lo + block] = xb.transpose(1, 2) @ xb
            self.xty[lo:lo + block] = (xb.transpose(1, 2)
                                       @ yb[..., None])[..., 0]
        self._factors: Dict[bytes, torch.Tensor] = {}

    def factor(self, degrees: np.ndarray) -> torch.Tensor:
        key = np.asarray(degrees, np.float32).tobytes()
        if key not in self._factors:
            shift = torch.as_tensor(self.rho * np.asarray(degrees, np.float64),
                                    dtype=self.prec.dtype,
                                    device=self.gram.device)
            lhs = self.gram.clone()
            lhs.diagonal(dim1=1, dim2=2).add_(shift[:, None])
            self._factors = {key: torch.linalg.cholesky(lhs)}
        return self._factors[key]

    def solve(self, rows: torch.Tensor, v: torch.Tensor,
              degrees: np.ndarray) -> torch.Tensor:
        """theta of workers ``rows`` for their ``v`` (len(rows), d)."""
        chol = self.factor(degrees).index_select(0, rows)
        rhs = self.xty.index_select(0, rows) - v.to(self.prec.dtype)
        return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def mix(adjacency: np.ndarray, values: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    """sum over each worker's neighbours: A @ V."""
    a = torch.as_tensor(adjacency, device=values.device).to(prec.dtype)
    return a @ _operand(values, prec)


def _schedule(bits_prev, r_new, r_prev, initialized, s: Scheme):
    """Eq. (18) and the step: (bits, delta, the log2 before its ceiling)."""
    pre = torch.log2(1.0 + (torch.exp2(bits_prev) - 1.0)
                     * r_new / torch.clamp_min(s.omega * r_prev, _EPS))
    bits = torch.where(r_prev <= _EPS, bits_prev, torch.ceil(pre))
    bits = torch.where(initialized > 0, bits, torch.full_like(bits, s.b0))
    bits = torch.clamp(bits, 1.0, float(s.b_max))
    delta = 2.0 * r_new / torch.clamp_min(torch.exp2(bits) - 1.0, 1.0)
    return bits, delta, pre


def quantize(theta, q_prev, u, r_prev, bits_prev, initialized, s: Scheme):
    """One worker-wise stochastic quantization round (Eqs. 14-20) in the
    dtype of ``theta``: (Qhat, R, bits, Delta), the last three (n,)."""
    diff = theta - q_prev
    r_new = diff.abs().amax(dim=1)
    bits, delta, _ = _schedule(bits_prev, r_new, r_prev, initialized, s)
    c = (diff + r_new[:, None]) / torch.clamp_min(delta, _EPS)[:, None]
    low = torch.floor(c)
    level = low + (u.to(theta.dtype) < c - low).to(theta.dtype)
    level = torch.minimum(level.clamp_min(0.0),
                          (torch.exp2(bits) - 1.0)[:, None])
    q_new = q_prev + delta[:, None] * level - r_new[:, None]
    degen = (r_new <= _EPS)[:, None]
    return (torch.where(degen, q_prev, q_new), r_new, bits,
            torch.where(degen[:, 0], torch.zeros_like(delta), delta))


def step(state: dict, u0: torch.Tensor, u1: torch.Tensor, graph,
         problem: Problem, s: Scheme) -> dict:
    """One whole iteration in ``problem``'s precision (the control runs
    this in the program's place)."""
    prec = problem.prec
    st = {k: (v.clone() if torch.is_tensor(v) else v)
          for k, v in state.items()}
    dev = st["theta"].device
    head = torch.as_tensor(graph.head_mask, device=dev)
    tau = s.tau(st["k"] + 1)
    for mask, u in ((head, u0), (~head, u1)):
        rows = torch.nonzero(mask)[:, 0]
        v = (st["alpha"].to(prec.dtype)
             - s.rho * mix(graph.adjacency, st["theta_hat"], prec))[rows]
        theta = problem.solve(rows, v, graph.degrees).to(st["theta"].dtype)
        q_prev = st["q_hat"][rows]
        q_new, r_new, bits, delta = quantize(
            theta, q_prev, u[rows], st["range"][rows], st["bits"][rows],
            st["init"][rows], s)
        change = torch.linalg.vector_norm(q_new - st["theta_hat"][rows], dim=1)
        tx = (change >= tau)[:, None]
        st["theta"][rows] = theta
        st["theta_hat"][rows] = torch.where(tx, q_new, st["theta_hat"][rows])
        st["q_hat"][rows] = q_new
        degen = r_new <= _EPS
        st["range"][rows] = torch.where(degen, st["range"][rows], r_new)
        st["delta"][rows] = torch.where(degen, st["delta"][rows], delta)
        st["bits"][rows] = bits
        st["init"][rows] = 1.0
    hat = st["theta_hat"].to(prec.dtype)
    deg = torch.as_tensor(graph.degrees, device=dev).to(prec.dtype)
    lap = deg[:, None] * hat - mix(graph.adjacency, st["theta_hat"], prec)
    st["alpha"] = (st["alpha"].to(prec.dtype) + s.rho * lap).to(
        st["alpha"].dtype)
    st["k"] += 1
    return st


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got.to(want.dtype) - want))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def check_step(before: dict, after: dict, u0: torch.Tensor, u1: torch.Tensor,
               graph, problem: Problem, s: Scheme,
               duals_reset: bool = False) -> Dict[str, float]:
    """Judge one iteration ``before -> after`` of the program (states as
    :func:`snapshot` keeps them) against the float64 reference, stage by
    stage. ``duals_reset``: the duals were set to 0 before the iteration
    (a new graph). Returns the readings ``solve_rel_err`` (the Frobenius
    error of theta relative to the reference's, the worse phase) and
    ``dual_rel_err`` (that of the duals relative to the norms of the terms
    the update sums) and the counts ``quant_errors`` and
    ``censor_errors``."""
    f64 = torch.float64
    dev = before["theta"].device
    head = torch.as_tensor(graph.head_mask, device=dev)
    alpha0 = (torch.zeros_like(before["alpha"]) if duals_reset
              else before["alpha"]).to(f64)
    hat0, hat1 = before["theta_hat"].to(f64), after["theta_hat"].to(f64)
    tau = s.tau(before["k"] + 1)
    out = {"solve_rel_err": 0.0, "quant_errors": 0, "censor_errors":
           int(after["k"] != before["k"] + 1)}
    for mask, u, hat_in in ((head, u0, hat0), (~head, u1, hat1)):
        rows = torch.nonzero(mask)[:, 0]
        v = (alpha0 - s.rho * mix(graph.adjacency, hat_in, REFERENCE))[rows]
        theta_ref = problem.solve(rows, v, graph.degrees)
        theta = after["theta"][rows].to(f64)
        out["solve_rel_err"] = max(out["solve_rel_err"],
                                   _rel(theta, theta_ref))
        out["quant_errors"] += quant_errors(before, after, rows, theta,
                                            u[rows].to(f64), s)
        out["censor_errors"] += censor_errors(before, after, rows, tau)
    deg = torch.as_tensor(graph.degrees, device=dev).to(f64)
    own, neigh = deg[:, None] * hat1, mix(graph.adjacency, hat1, REFERENCE)
    alpha_ref = alpha0 + s.rho * (own - neigh)
    # relative to the terms summed: near consensus D theta_hat and
    # A theta_hat cancel, and the sum alone would magnify any rounding
    norm = torch.linalg.vector_norm
    scale = float(norm(alpha0) + s.rho * (norm(own) + norm(neigh)))
    diff = float(norm(after["alpha"].to(f64) - alpha_ref))
    out["dual_rel_err"] = diff / scale if scale > 0 else (
        0.0 if diff == 0 else math.inf)
    return out


def quant_errors(before, after, rows, theta, u, s: Scheme) -> int:
    """Wrong outcomes of the program's quantization of its own ``theta``:
    ranges, bit widths, steps, and levels away from a rounding tie."""
    f64 = torch.float64
    q0 = before["q_hat"][rows].to(f64)
    q1 = after["q_hat"][rows].to(f64)
    r_prev = before["range"][rows].to(f64)
    b_prev = before["bits"][rows].to(f64)
    init = before["init"][rows].to(f64)
    r1, b1, d1 = (after[k][rows].to(f64) for k in ("range", "bits", "delta"))
    r_ref = (theta - q0).abs().amax(dim=1)
    degen = r_ref <= _EPS
    # a degenerate range keeps the previous range, step and reconstruction
    r_want = torch.where(degen, r_prev, r_ref)
    errors = int(((r1 - r_want).abs() > RANGE_TOL * r_want + _EPS).sum())
    b_ref, _, pre = _schedule(b_prev, r_ref, r_prev, init, s)
    edge = (init > 0) & (r_prev > _EPS) & (
        (pre - torch.round(pre)).abs() <= BITS_TIE)
    errors += int(((b1 != b_ref) & ~edge).sum())
    d_ref = 2.0 * r1 / torch.clamp_min(torch.exp2(b1) - 1.0, 1.0)
    live = ~degen
    errors += int(((d1 - d_ref).abs() > DELTA_TOL * d_ref)[live].sum())
    errors += int((q1[degen] != q0[degen]).sum())
    if not bool(live.any()):
        return errors
    q0, q1, theta, u = q0[live], q1[live], theta[live], u[live]
    r1, d1, b1 = r1[live, None], d1[live, None], b1[live, None]
    c = (theta - q0 + r1) / d1
    shifted = c - u
    level_ref = torch.clamp(torch.floor(shifted) + 1.0, min=0.0)
    level_ref = torch.minimum(level_ref, torch.exp2(b1) - 1.0)
    # the float32 c is a few ulp of each of its terms off, in levels
    rounding = F32_ULP * 4.0 * ((theta - q0).abs() + 2.0 * r1) / d1
    tie = ((shifted - torch.round(shifted)).abs()
           <= LEVEL_TIE * torch.clamp_min(c.abs(), 1.0) + rounding)
    # the program's float32 rebuild Qhat + Delta q - R, read back as a
    # level, is a few ulp of its terms off; where that is a quarter level
    # or more the level cannot be read back, and the entry is not judged
    slack = F32_ULP * 4.0 * (q0.abs() + 2.0 * r1) / d1
    readable = (slack < 0.25) & (rounding < 0.25)
    level = (q1 - q0 + r1) / d1
    nearest = torch.round(level)
    errors += int((((level - nearest).abs() > GRID_TOL + slack)
                   & readable).sum())
    errors += int(((nearest != level_ref) & ~tie & readable).sum())
    return errors


def censor_errors(before, after, rows, tau: float) -> int:
    """Wrong transmit decisions, and committed replicas that are neither
    the new reconstruction nor the old replica."""
    q1 = after["q_hat"][rows]
    hat0, hat1 = before["theta_hat"][rows], after["theta_hat"][rows]
    change = torch.linalg.vector_norm(q1.to(torch.float64)
                                      - hat0.to(torch.float64), dim=1)
    tx_ref = change >= tau
    tie = (change - tau).abs() <= CENSOR_TIE * tau
    sent = torch.all(hat1 == q1, dim=1)
    kept = torch.all(hat1 == hat0, dim=1)
    wrong = (~sent & ~kept) | ((sent != tx_ref) & ~tie & ~(sent & kept))
    return int(wrong.sum())


def snapshot(theta, theta_hat, alpha, q_hat, range_prev, bits_prev,
             delta_prev, initialized, k: int) -> dict:
    """A state as the judge reads it: (N, d) and (N,) tensors and k."""
    return {"theta": theta.clone(), "theta_hat": theta_hat.clone(),
            "alpha": alpha.clone(), "q_hat": q_hat.clone(),
            "range": range_prev.reshape(-1).clone(),
            "bits": bits_prev.reshape(-1).clone(),
            "delta": delta_prev.reshape(-1).clone(),
            "init": initialized.reshape(-1).clone(), "k": int(k)}


def initial_state(n: int, d: int, s: Scheme, dtype, device) -> dict:
    """The state before the first iteration: all zeros, b0 bits."""
    z = torch.zeros((n, d), dtype=dtype, device=device)
    side = torch.zeros((n,), dtype=dtype, device=device)
    return {"theta": z, "theta_hat": z.clone(), "alpha": z.clone(),
            "q_hat": z.clone(), "range": side, "bits": side + s.b0,
            "delta": side.clone(), "init": side.clone(), "k": 0}


def state_errors(state: dict, want: dict) -> int:
    """Entries of a state that differ from ``want`` (the start)."""
    return sum(int((state[k].to(torch.float64)
                    != want[k].to(torch.float64)).sum())
               for k in want if torch.is_tensor(want[k])) + int(
                   state["k"] != want["k"])


def max_readings(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The worst reading of each number over the judged iterations; the
    counts are summed."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = (out.get(k, 0) + v) if k.endswith("_errors") else max(
                out.get(k, 0.0), v)
    return out


def judge_steps(records, x, y, graph_of, s: Scheme,
                start: Optional[dict] = None):
    """Every recorded iteration judged; ``records`` yields (iteration,
    before, after, u0, u1, duals_reset) and ``graph_of(iteration)`` the
    graph it ran on. ``start``, where given, is the program's state before
    its first iteration, held to :func:`initial_state` (its wrong entries
    count as quantizer errors of the first iteration). Returns the worst
    readings and each iteration's."""
    problem = Problem(x, y, s.rho, REFERENCE)
    readings = [check_step(b, a, u0, u1, graph_of(it), problem, s, reset)
                for it, b, a, u0, u1, reset in records]
    if start is not None and readings:
        readings[0]["quant_errors"] += state_errors(start, initial_state(
            start["theta"].shape[0], start["theta"].shape[1], s,
            torch.float32, start["theta"].device))
    return max_readings(readings), readings
