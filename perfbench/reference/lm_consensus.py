"""Plain CQ-GGADMM consensus training of a language model (the paper's
Algorithm 2 with an inexact local solve), and the stage-by-stage judge of
the program's steps.

Written from the paper's equations in plain PyTorch over the per-worker
parameters of the configuration's reference model (a module of
``reference/``, named by the configuration's ``reference``: a dict by
path, leading worker axis N, and its ``losses``); it imports nothing of
the program. Per step, heads then tails:

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

Under a fleet's faults (``reference/fleet.py``) a worker transmits only
where it also acts; after the dual update a delivery lands a parked
reconstruction in ``theta_hat``.

The stochastic-rounding uniforms of a phase are one (N, P) draw, P the
parameter count, whose columns are the leaves in the order of their paths,
each flattened row-major. The loss a step reports is the workers' mean
loss after the step on the step's rows.

:func:`check_step` judges one step of the program from its state before
and after it and from what its local solve's gradient function was handed
and gave back (a :class:`Recorder` keeps them). Each stage is recomputed
from the program's own inputs to that stage, so that a step is judged by
itself: bfloat16 activations and stochastic rounding make two correct
trajectories part after the first step, and a comparison of trajectories
reads that drift, not a fault.

A model enters as ``losses(params, tokens, labels, act)``: each worker's
loss (W,), every term the program's loss adds, with the activations
rounded by ``act``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import convex
from perfbench.reference import fleet as fleet_ref

Path = Tuple[str, ...]
Leaves = Dict[Path, torch.Tensor]
Act = Callable[[torch.Tensor], torch.Tensor]
LossFn = Callable[[Leaves, torch.Tensor, torch.Tensor, Act], torch.Tensor]
_EPS = 1e-12
# the state a judge reads: per-worker trees by path, (N, G) quantizer sides
TREES = ("theta", "theta_hat", "alpha", "q_hat", "mu", "nu")
SIDES = ("range", "bits", "delta", "init")
# bits a transmission carries besides its levels: a group's range and
# width (the program's ``b_overhead``)
OVERHEAD_BITS = 64
# the offered payload is summed in float32 over the groups: a few ulp
BITS_TOL = 1e-5


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

    def scheme(self) -> convex.Scheme:
        return convex.Scheme(self.rho, self.tau0, self.xi, self.b0,
                             self.omega, self.b_max)


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def loss_grads(th: Leaves, tokens: torch.Tensor, labels: torch.Tensor,
               losses: LossFn, act: Act) -> Leaves:
    """Each worker's gradient of its own loss on its rows."""
    leaves = {p: x.detach().requires_grad_(True) for p, x in th.items()}
    with torch.enable_grad():
        total = losses(leaves, tokens, labels, act).sum()
        grads = torch.autograd.grad(total, list(leaves.values()))
    return dict(zip(leaves, grads))


def adam_step(th: Leaves, mu: Leaves, nu: Leaves, g: Leaves, v: Leaves,
              quad: torch.Tensor, i: int, s: Settings
              ) -> Tuple[Leaves, Leaves, Leaves]:
    """Local step ``i`` of the solve: Adam on the gradient ``g`` of the
    loss plus the augmented terms ``v + quad theta``."""
    b1c, b2c = 1.0 - s.b1 ** (i + 1), 1.0 - s.b2 ** (i + 1)
    out_th, out_mu, out_nu = {}, {}, {}
    for p in th:
        aug = g[p].float() + v[p] + _per_row(quad, th[p]) * th[p]
        out_mu[p] = s.b1 * mu[p] + (1 - s.b1) * aug
        out_nu[p] = s.b2 * nu[p] + (1 - s.b2) * aug.square()
        out_th[p] = th[p] - s.lr * (out_mu[p] / b1c) / (
            torch.sqrt(out_nu[p] / b2c) + s.eps)
    return out_th, out_mu, out_nu


def to_host(flat: Leaves) -> Leaves:
    return {p: x.detach().to("cpu", copy=True) for p, x in flat.items()}


class Recorder:
    """While ``on``, keeps each call of a local solve's gradient function
    in host memory: the parameters it was handed (after a solve's first
    call, which gets the state's) and the gradient it gave back."""

    def __init__(self, local_steps: int):
        self.local_steps = local_steps
        self.on = False
        self.calls: List[Tuple[Optional[Leaves], Leaves]] = []
        self.seconds = 0.0            # spent copying

    def wrap(self, grad_fn: Callable, flatten: Callable[..., Leaves]
             ) -> Callable:
        def recorded(theta, batch):
            g = grad_fn(theta, batch)
            if self.on:
                _sync(next(iter(flatten(g).values())))
                t0 = time.perf_counter()
                th = (None if len(self.calls) % self.local_steps == 0
                      else to_host(flatten(theta)))
                self.calls.append((th, to_host(flatten(g))))
                self.seconds += time.perf_counter() - t0
            return g
        return recorded

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def snapshot(state: dict) -> dict:
    """A state as the judge reads it (``TREES`` by path, ``SIDES``, ``k``),
    copied to host memory."""
    out = {name: to_host(state[name]) for name in TREES}
    out.update({name: state[name].detach().to("cpu", torch.float64,
                                              copy=True)
                for name in SIDES})
    out["k"] = int(state["k"])
    return out


def initial_state(params0: Leaves, n: int, n_groups: int, b0: int) -> dict:
    """The state before the first step, as views of ``params0``: every
    worker at the shared model, the rest 0, b0 bits."""
    zero = torch.zeros((), device=next(iter(params0.values())).device)
    out = {"theta": {p: x[None].expand((n,) + x.shape)
                     for p, x in params0.items()}}
    for name in TREES[1:]:
        out[name] = {p: zero.expand((n,) + x.shape)
                     for p, x in params0.items()}
    side = torch.zeros((n, n_groups), dtype=torch.float64,
                       device=zero.device)
    out.update(range=side, bits=side + b0, delta=side, init=side, k=0)
    return out


def state_before(records: Sequence[dict], step: int, start: dict,
                 snap: Callable[[], dict]) -> dict:
    """The state before ``step`` for its record: the last record's state
    after it where that was the step before, ``start`` before the first
    step, else a fresh ``snap()``."""
    if records and records[-1]["step"] == step - 1:
        return records[-1]["after"]
    return start if step == 0 else snap()


def state_errors(state: dict, want: dict) -> int:
    """Entries of a state (as :func:`snapshot` lays it out, on any device)
    that differ from ``want``."""
    errors = int(state["k"] != want["k"])
    for name in TREES:
        for p, x in want[name].items():
            errors += int((state[name][p] != x.to(state[name][p].device))
                          .sum())
    for name in SIDES:
        errors += int((state[name].to(torch.float64)
                       != want[name].to(state[name].device)).sum())
    return errors


def buffer_snapshot(held: Leaves, bits: torch.Tensor,
                    timer: torch.Tensor) -> dict:
    """A fleet's delivery buffer as the judge reads it, copied to host
    memory: the parked reconstruction of each worker with a packet in
    flight (``timer > 0``; the other rows hold nothing), the parked bits
    and the timers."""
    timer = timer.detach().to("cpu", torch.int64).numpy()
    return {"held": {int(n): {p: x[int(n)].detach().to("cpu", copy=True)
                              for p, x in held.items()}
                     for n in np.nonzero(timer > 0)[0]},
            "bits": bits.detach().to("cpu", torch.float64).numpy(),
            "timer": timer}


def empty_buffer(n: int) -> dict:
    """The delivery buffer before the first round."""
    return {"held": {}, "bits": np.zeros(n), "timer": np.zeros(n, np.int64)}


class Trainer:
    """The whole consensus state and its steps: the control runs this in
    the program's place, with its gradient function recorded as the
    program's is. With ``faults`` (a seed and a
    ``reference.fleet.Faults``) each step is a fleet round: the round's
    draw decides who acts, a late packet is parked and delivered, and
    ``reported`` holds the round's masks and bits as the program reports
    them."""

    def __init__(self, params0: Leaves, n: int, graph, losses: LossFn,
                 s: Settings, act: Act,
                 recorder: Optional[Recorder] = None,
                 faults: Optional[Tuple[int, fleet_ref.Faults]] = None):
        self.s, self.losses, self.act, self.graph = s, losses, act, graph
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
        self.sizes = [int(np.prod(x.shape)) for x in params0.values()]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()
        self.faults = faults
        self.timer = np.zeros(n, np.int64)
        self.held: Dict[int, Leaves] = {}
        self.held_bits = np.zeros(n)
        self.reported: Optional[Dict[str, np.ndarray]] = None

        def grad_fn(th, batch):
            return loss_grads(th, *batch, losses, act)
        self.grad_fn = (recorder.wrap(grad_fn, dict) if recorder is not None
                        else grad_fn)

    def snapshot(self) -> dict:
        return snapshot({"theta": self.theta, "theta_hat": self.hat,
                         "alpha": self.alpha, "q_hat": self.q,
                         "mu": self.mu, "nu": self.nu, "range": self.r_prev,
                         "bits": self.bits, "delta": self.delta,
                         "init": self.init, "k": self.k})

    def buffer(self) -> dict:
        return {"held": {n: to_host(x) for n, x in self.held.items()},
                "bits": self.held_bits.copy(), "timer": self.timer.copy()}

    def _mix(self, tree):
        return {p: torch.einsum("nm,m...->n...", self.adj, x)
                for p, x in tree.items()}

    def _solve(self, rows, v, tokens, labels):
        quad = self.s.rho * self.deg[rows]
        th = {p: x[rows] for p, x in self.theta.items()}
        mu = {p: x[rows] for p, x in self.mu.items()}
        nu = {p: x[rows] for p, x in self.nu.items()}
        vr = {p: x[rows] for p, x in v.items()}
        for i in range(self.s.local_steps):
            g = self.grad_fn(th, (tokens[rows], labels[rows]))
            th, mu, nu = adam_step(th, mu, nu, g, vr, quad, i, self.s)
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
        dev = self.adj.device
        head = torch.as_tensor(self.graph.head_mask, device=dev)
        n = head.numel()
        tau = s.tau0 * s.xi ** (self.k + 1)
        acts = torch.ones(n, dtype=torch.bool, device=dev)
        if self.faults is not None:
            drop, lag = self.faults[1].draw(self.faults[0], self.k, range(n))
            acts = torch.as_tensor(fleet_ref.advance(
                self.timer, drop, lag, np.zeros(n, bool))
                ["fleet_participation"], device=dev)
        censor = torch.zeros(n, dtype=torch.bool, device=dev)
        for mask, u in ((head, u0), (~head, u1)):
            rows = torch.nonzero(mask)[:, 0]
            neigh = self._mix(self.hat)
            v = {p: self.alpha[p] - s.rho * neigh[p] for p in neigh}
            self._solve(rows, v, tokens, labels)
            q_new = self._quantize(rows, u)
            change = torch.sqrt(sum(
                (q_new[p] - self.hat[p][rows]).reshape(len(rows), -1)
                .square().sum(dim=1) for p in self.paths))
            censor[rows] = change >= tau
            tx = censor[rows] & acts[rows]
            for p in self.paths:
                keep = _per_row(tx, q_new[p])
                self.hat[p][rows] = torch.where(keep, q_new[p],
                                                self.hat[p][rows])
                self.q[p][rows] = q_new[p]
        neigh = self._mix(self.hat)
        for p in self.paths:
            self.alpha[p] = self.alpha[p] + s.rho * (
                _per_row(self.deg, self.hat[p]) * self.hat[p] - neigh[p])
        if self.faults is not None:
            self._deliver(drop, lag, censor.cpu().numpy())
        self.k += 1
        with torch.no_grad():
            return float(self.losses(self.theta, tokens, labels,
                                     self.act).mean())

    def _deliver(self, drop, lag, censor) -> None:
        """The fleet's buffer after the round's dual update: deliveries
        land, packets that passed their censor test are parked."""
        want = fleet_ref.advance(self.timer, drop, lag, censor)
        offered = np.where(censor, self.bits.cpu().numpy() @ np.asarray(
            self.sizes, np.float64) + OVERHEAD_BITS * len(self.paths), 0.0)
        deliver, parked = want["fleet_deliver"], want["fleet_start"]
        acted = censor & want["fleet_participation"]
        self.reported = {
            "fleet_participation": want["fleet_participation"],
            "fleet_start": parked, "fleet_deliver": deliver,
            "fleet_timer": want["fleet_timer"], "tx_mask": acted | deliver,
            "payload_bits": (np.where(acted, offered, 0.0)
                             + np.where(deliver, self.held_bits, 0.0)),
            "censor_mask": censor, "offered_payload_bits": offered}
        for n in np.nonzero(deliver)[0]:
            for p, x in self.held.pop(int(n)).items():
                self.hat[p][n] = x
        for n in np.nonzero(parked)[0]:
            self.held[int(n)] = {p: self.q[p][n].clone() for p in self.paths}
        self.held_bits = np.where(parked, offered,
                                  np.where(deliver, 0.0, self.held_bits))
        self.timer = want["fleet_timer"]


# ------------------------------------------------------------ the judge --
def _take(x: torch.Tensor, rows: torch.Tensor, dev) -> torch.Tensor:
    return x[rows.to(x.device)].to(dev, torch.float32)


def worst_rel(got: Leaves, want: Leaves, base: Optional[Leaves] = None
              ) -> Tuple[float, int, Path]:
    """The worst (worker, leaf) of ||got - want|| against the larger of
    ||base|| (``want`` by default) on that leaf and on the worker's median
    leaf (some leaves' gradients are all but zero): the ratio, the row and
    the leaf's path."""
    base = want if base is None else base
    num, den = [], []
    for p in want:
        diff = got[p].double() - want[p].double()
        num.append(torch.linalg.vector_norm(diff.flatten(1), dim=1))
        den.append(torch.linalg.vector_norm(base[p].double().flatten(1),
                                            dim=1))
    num, den = torch.stack(num, dim=1), torch.stack(den, dim=1)
    floor = torch.maximum(den, den.median(dim=1, keepdim=True).values)
    ratio = torch.where(num == 0, torch.zeros_like(num),
                        num / torch.clamp_min(floor, 1e-300))
    at = int(ratio.argmax())
    worst = float(ratio.flatten()[at])
    return ((worst if math.isfinite(worst) else math.inf),
            at // len(want), list(want)[at % len(want)])


def whole_rel(got: Leaves, want: Leaves) -> Tuple[float, int, None]:
    """The worst worker's ||got - want|| over ||want||, all leaves one
    vector: the ratio and the row."""
    num = sum(torch.linalg.vector_norm(
        (got[p].double() - want[p].double()).flatten(1), dim=1).square()
        for p in want)
    den = sum(torch.linalg.vector_norm(want[p].double().flatten(1),
                                       dim=1).square() for p in want)
    ratio = torch.sqrt(num / torch.clamp_min(den, 1e-300))
    at = int(ratio.argmax())
    worst = float(ratio[at])
    return (worst if math.isfinite(worst) else math.inf), at, None


def check_step(before: dict, after: dict, calls: Sequence, loss: float,
               tokens: torch.Tensor, labels: torch.Tensor, u0: torch.Tensor,
               u1: torch.Tensor, graph, losses: LossFn, s: Settings,
               dev, fleet: Optional[dict] = None) -> Dict[str, float]:
    """Judge one step ``before -> after`` of the program (states as
    :func:`snapshot` keeps them; ``calls`` its gradient function's, as the
    :class:`Recorder` keeps them, heads' then tails'; ``loss`` the loss it
    reported) against the float32 reference, stage by stage, a phase's
    workers at a time. Returns

    * ``grad_rel_err``: each gradient the program's optimizer got against
      the reference's at the parameters the program handed over, on the
      worker's rows, all leaves one vector (:func:`whole_rel`; the worst
      leaf, :func:`worst_rel`, is printed beside it as ``grad_leaf``: in
      bfloat16 the mLSTM input gate's gradient alone is the noisiest);
    * ``update_rel_err``: the parameters each local step hands on, and the
      moments and parameters after the solve, against Adam worked out from
      the program's own gradients and the ``v`` of the program's duals and
      replicas (the parameters as the step's change);
    * ``quant_errors`` and ``censor_errors``: wrong outcomes of each
      group's quantization of the program's parameters and of the transmit
      decisions (``reference/convex.py``'s counts, group by group);
    * ``dual_rel_err``: the duals against Eq. 23 on the program's
      replicas, relative to the norms of the terms the update sums;
    * ``loss_gap``: the reported loss against the reference's at the
      program's parameters after the step, relative.

    A fleet round (``fleet``: the delivery buffer ``before`` and ``after``
    it, as :func:`buffer_snapshot` keeps them, the round's ``reported``
    masks and bits, the masks the reference's draw and buffer ``want``,
    ``reference/fleet.check_rounds``, and the wrong entries of the rounds
    it answers for, ``round_errors``) is judged under those masks: the
    phases mix, and the dual takes, the replicas before this round's
    deliveries; a worker that does not act and changed its replica, and
    a reported censor decision that is wrong away from a tie, are censor
    errors; and ``fleet_errors`` counts a parked packet that is not the
    worker's new reconstruction or its offered bits, a packet in flight
    that changed, a delivery that did not land the parked packet or keeps
    its bits, and offered bits that are not the worker's payload (its
    groups' widths times their sizes, plus each group's range and width),
    besides ``round_errors``."""
    f64 = torch.float64
    k_steps = s.local_steps
    scheme = s.scheme()
    paths = list(after["theta"])
    head = torch.as_tensor(graph.head_mask)
    adj = torch.as_tensor(graph.adjacency, device=dev).to(f64)
    deg = torch.as_tensor(graph.degrees, device=dev).to(f64)
    tau = scheme.tau(before["k"] + 1)
    acts, hat_mid = None, after["theta_hat"]
    if fleet is not None:
        acts = torch.as_tensor(fleet["want"]["fleet_participation"])
        hat_mid = _before_deliveries(before["theta_hat"], after["theta_hat"],
                                     fleet["want"]["fleet_deliver"])
    recorded = len(calls) == 2 * k_steps
    out = {"grad_rel_err": 0.0 if recorded else math.inf,
           "update_rel_err": 0.0 if recorded else math.inf,
           "quant_errors": 0,
           "censor_errors": int(after["k"] != before["k"] + 1)}
    where: Dict[str, tuple] = {}

    def note(name: str, reading: Tuple[float, int, Path], rows, phase):
        if name not in where or reading[0] > where[name][0]:
            where[name] = (reading[0], phase, int(rows[reading[1]]),
                           reading[2])

    def keep(name: str, reading: Tuple[float, int, Path], rows, phase):
        out[name] = max(out[name], reading[0])
        note(name, reading, rows, phase)

    sizes = [int(np.prod(after["theta"][p].shape[1:])) for p in paths]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    loss_sum = 0.0
    for phase, (mask, u, hat_src) in enumerate(((head, u0,
                                                 before["theta_hat"]),
                                                (~head, u1, hat_mid))):
        rows = torch.nonzero(mask)[:, 0]
        rd = rows.to(dev)
        tok, lab = tokens[rd], labels[rd]
        quad = (s.rho * deg[rd]).float()
        th = {p: _take(before["theta"][p], rows, dev) for p in paths}
        theta = {p: _take(after["theta"][p], rows, dev) for p in paths}
        if recorded:
            v = {p: (_take(before["alpha"][p], rows, dev).to(f64)
                     - s.rho * torch.einsum(
                         "rm,m...->r...", adj[rd],
                         hat_src[p].to(dev, f64))).float()
                 for p in paths}
            mu = {p: _take(before["mu"][p], rows, dev) for p in paths}
            nu = {p: _take(before["nu"][p], rows, dev) for p in paths}
            start = th
            for i in range(k_steps):
                given, g = calls[phase * k_steps + i]
                if given is not None:
                    given = {p: given[p].to(dev) for p in paths}
                    keep("update_rel_err", _step_err(given, th, start), rows,
                         phase)
                    th = given
                g = {p: g[p].to(dev) for p in paths}
                want = loss_grads(th, tok, lab, losses, lambda t: t)
                keep("grad_rel_err", whole_rel(g, want), rows, phase)
                note("grad_leaf", worst_rel(g, want), rows, phase)
                del want
                start = th
                th, mu, nu = adam_step(th, mu, nu, g, v, quad, i, s)
            keep("update_rel_err", _step_err(theta, th, start), rows, phase)
            for name, want in (("mu", mu), ("nu", nu)):
                keep("update_rel_err", worst_rel(
                    {p: _take(after[name][p], rows, dev) for p in paths},
                    want), rows, phase)
            del v, mu, nu, start
        for g, p in enumerate(paths):
            out["quant_errors"] += _group_quant_errors(
                before, after, rows, g, p, theta[p].to(f64),
                u[rd, offsets[g]:offsets[g + 1]].to(f64), scheme, dev)
        out["censor_errors"] += _censor_errors(
            before["theta_hat"], hat_mid, after["q_hat"], rows, paths, tau,
            dev, None if acts is None else acts[rows],
            None if fleet is None else fleet["reported"]["censor_mask"])
        with torch.no_grad():
            loss_sum += float(losses(theta, tok, lab, lambda t: t).sum())
        del theta, th
    out["dual_rel_err"] = _dual_rel_err(before, after, hat_mid, adj, deg,
                                        s.rho, paths, dev)
    loss_ref = loss_sum / head.numel()
    out["loss_gap"] = abs(loss - loss_ref) / abs(loss_ref)
    if fleet is not None:
        out["fleet_errors"] = (_buffer_errors(after, fleet, sizes)
                               + fleet.get("round_errors", 0))
    print(f"[perfbench] worst (reading, phase, worker, leaf): {where}; "
          f"loss {loss!r}, reference {loss_ref!r}", file=sys.stderr)
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: (v if math.isfinite(v) else math.inf)
               for k, v in out.items()}
    return out


def _step_err(got: Leaves, want: Leaves, start: Leaves
              ) -> Tuple[float, int, Path]:
    """Parameters after a local step against the expected ones, as the
    step's change from ``start``."""
    return worst_rel(got, want, {p: want[p] - start[p] for p in want})


def _group_quant_errors(before, after, rows, g: int, p: Path, theta, u,
                        scheme: convex.Scheme, dev) -> int:
    """``convex.quant_errors`` on group ``g`` (the leaf ``p``) of the
    phase's workers."""
    r = len(rows)

    def side(state, names):
        return {k: state[k][rows, g].to(dev) for k in names}
    b = dict(side(before, ("range", "bits", "init")),
             q_hat=_take(before["q_hat"][p], rows, dev).reshape(r, -1))
    a = dict(side(after, ("range", "bits", "delta")),
             q_hat=_take(after["q_hat"][p], rows, dev).reshape(r, -1))
    return convex.quant_errors(b, a, torch.arange(r, device=dev),
                               theta.reshape(r, -1), u, scheme)


def _censor_errors(hat0: Leaves, hat1: Leaves, q1: Leaves, rows, paths,
                   tau: float, dev, acts: Optional[torch.Tensor] = None,
                   reported: Optional[np.ndarray] = None) -> int:
    """``convex.censor_errors`` on the phase's workers that act (all of
    them without ``acts``), all leaves one vector (global censoring), from
    the replicas before the phase (``hat0``) and after it (``hat1``) and
    the new reconstructions ``q1``; a worker that does not act and changed
    its replica, and a ``reported`` censor decision (the program's, by
    worker) that is wrong away from a tie, count too."""
    def packed(tree):
        return torch.cat([_take(tree[p], rows, dev).flatten(1)
                          for p in paths], dim=1)
    h0, h1, q = packed(hat0), packed(hat1), packed(q1)
    on = (torch.ones(len(rows), dtype=torch.bool) if acts is None
          else acts.to(torch.bool))
    errors = convex.censor_errors({"theta_hat": h0},
                                  {"q_hat": q, "theta_hat": h1},
                                  torch.nonzero(on)[:, 0].to(dev), tau)
    errors += int((~torch.all(h1 == h0, dim=1).cpu() & ~on).sum())
    if reported is not None:
        change = torch.linalg.vector_norm(q.to(torch.float64)
                                          - h0.to(torch.float64), dim=1)
        tie = (change - tau).abs() <= convex.CENSOR_TIE * tau
        said = torch.as_tensor(np.asarray(reported)[rows.cpu().numpy()] > 0,
                               device=change.device)
        errors += int(((said != (change >= tau)) & ~tie).sum())
    return errors


def _before_deliveries(hat0: Leaves, hat1: Leaves, deliver) -> Leaves:
    """The replicas after a fleet round's phases and before its
    deliveries: ``hat1`` with each delivering worker's row as it was before
    the round (a worker with a packet in flight does not act)."""
    rows = np.nonzero(np.asarray(deliver))[0]
    if not rows.size:
        return hat1
    out = {}
    for p, x in hat1.items():
        out[p] = x.clone()
        out[p][rows] = hat0[p][rows].to(x.device, x.dtype)
    return out


def _buffer_errors(after: dict, fleet: dict, sizes: Sequence[int]) -> int:
    """Wrong entries of a fleet round's delivery buffer and deliveries
    (:func:`check_step`'s ``fleet_errors``)."""
    b0, b1, got, want = (fleet["before"], fleet["after"], fleet["reported"],
                         fleet["want"])
    offered = np.asarray(got["offered_payload_bits"], np.float64)
    said = np.asarray(got["censor_mask"]) > 0
    payload = (after["bits"].numpy() @ np.asarray(sizes, np.float64)
               + OVERHEAD_BITS * len(sizes))
    errors = int(np.sum(np.abs(offered - np.where(said, payload, 0.0))
                        > BITS_TOL * payload))

    def equal(a: Optional[Leaves], b: Optional[Leaves]) -> bool:
        return a is not None and b is not None and all(
            torch.equal(a[p], b[p].to(a[p].device, a[p].dtype)) for p in b)

    def row(tree: Leaves, n: int) -> Leaves:
        return {p: x[n] for p, x in tree.items()}

    for n in range(len(offered)):
        held0, held1 = b0["held"].get(n), b1["held"].get(n)
        if want["fleet_start"][n]:
            errors += int(not equal(held1, row(after["q_hat"], n)))
            errors += int(b1["bits"][n] != offered[n])
        elif want["in_flight"][n] and not want["fleet_deliver"][n]:
            errors += int(not equal(held1, held0))
            errors += int(b1["bits"][n] != b0["bits"][n])
        if want["fleet_deliver"][n]:
            errors += int(not equal(row(after["theta_hat"], n), held0))
            errors += int(b1["bits"][n] != 0.0)
    return errors


def _dual_rel_err(before, after, hats: Leaves, adj, deg, rho: float, paths,
                  dev) -> float:
    """The duals after the step against alpha + rho (D - A) theta_hat, the
    replicas ``hats`` the update took, relative to the norms of the terms
    the update sums (near consensus D theta_hat and A theta_hat
    cancel)."""
    f64 = torch.float64
    sq = {"diff": 0.0, "alpha": 0.0, "own": 0.0, "neigh": 0.0}
    for p in paths:
        a0 = before["alpha"][p].to(dev, f64)
        hat = hats[p].to(dev, f64)
        own = _per_row(deg, hat) * hat
        neigh = torch.einsum("nm,m...->n...", adj, hat)
        want = a0 + rho * (own - neigh)
        got = after["alpha"][p].to(dev, f64)
        for key, x in (("diff", got - want), ("alpha", a0), ("own", own),
                       ("neigh", neigh)):
            sq[key] += float(x.square().sum())
        del a0, hat, own, neigh, want, got
    scale = math.sqrt(sq["alpha"]) + rho * (math.sqrt(sq["own"])
                                            + math.sqrt(sq["neigh"]))
    diff = math.sqrt(sq["diff"])
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def judge_steps(records: Sequence[dict], inputs_of: Callable,
                graph, losses: LossFn, s: Settings, dev,
                start_errors: int = 0):
    """Every recorded step judged. Each record holds ``step``, ``before``,
    ``after``, ``calls`` and ``loss``, and in a fleet round ``fleet``
    (:func:`check_step`'s); ``inputs_of(record)`` gives that step's
    (tokens, labels, u0, u1) on ``dev``. ``start_errors`` (the program's
    state before its first step against :func:`initial_state`) count as
    quantizer errors of the first record. Returns the worst readings and
    each step's."""
    readings = []
    for rec in records:
        tokens, labels, u0, u1 = inputs_of(rec)
        readings.append(check_step(rec["before"], rec["after"],
                                   rec["calls"], rec["loss"], tokens, labels,
                                   u0, u1, graph, losses, s, dev,
                                   rec.get("fleet")))
        del tokens, labels, u0, u1
    if readings:
        readings[0]["quant_errors"] += start_errors
    return convex.max_readings(readings), readings
