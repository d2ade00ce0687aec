"""CQ-GGADMM consensus engine, one-leaf flat path (paper Algorithms 1 and 2).

The port of ``repro.core.engine`` for a flat ``(N, d)`` parameter tensor:
GGADMM / C-GGADMM / Q-GGADMM / CQ-GGADMM and the Jacobian C-ADMM baseline.
Per iteration, over the leading worker axis N:

  phase 1 (heads):  theta_H <- exact local argmin of the augmented Lagrangian
                    quantize -> candidate, censor -> theta_hat_H
  phase 2 (tails):  same, neighbors see the fresh head theta_hat
  dual:             alpha += rho * (D - A) theta_hat            (Eq. 23)

The quantizer is the ``stoch_quantize`` kernel and every neighbour mix (two
phase mixes and the Laplacian of the dual update) is the ``bipartite_mix``
kernel when the tensors are on the card (``kernels.ops``); a CPU tensor
takes their plain versions. The quantizer side information ``(R, b, Δ)`` is
``(N, G)`` with G=1, the paper's whole-model mode; censoring runs in global
or group mode (identical at G=1 up to the norm's rounding).

Not ported yet (ROADMAP.md): multi-leaf trees and their group specs, the
sparse and sharded topologies, narrowed ``hat_dtype`` replicas, inexact
(Adam) local solvers and the fleet ``participation`` hook.

The stochastic-rounding uniforms come from ``torch.rand`` with one
``torch.Generator`` seeded by ``run(seed=...)``; ``run(uniforms=...)``
injects them instead, so a test can feed the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import censoring as censor_lib
from repro_torch.core import quantization as quant_lib
from repro_torch.core import topology as topo_lib
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import WorkerGraph
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops

_EPS = 1e-12

Metrics = Dict[str, torch.Tensor]
MetricsFn = Callable[["EngineState"], Metrics]
Uniforms = Callable[[int, int], torch.Tensor]   # (iteration, phase) -> (N, d)


# ------------------------------------------------------------- config --
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Hyperparameters of the stepper: the JAX ``EngineConfig``'s fields
    and defaults. ``use_pallas_mix``/``use_pallas_quant`` are kept so a
    config reads the same in both packages; the port always routes a CUDA
    tensor through its kernels."""

    rho: float = 1.0
    alternating: bool = True          # GADMM grouping; False => Jacobian ADMM
    censor: CensorConfig = dataclasses.field(default_factory=CensorConfig)
    quantize: Optional[QuantConfig] = None
    groups: Any = "model"             # one leaf: "model" and "leaf" are G=1
    censor_mode: str = "global"       # "global" (paper) | "group"
    mix_backend: str = "dense"        # only "dense" is ported
    use_pallas_mix: bool = False
    use_pallas_quant: bool = False
    hat_dtype: Optional[str] = None   # narrowed replicas: not ported
    regroup_every: int = 0            # auto:K re-clustering: not ported

    def __post_init__(self):
        if self.censor_mode not in ("global", "group"):
            raise ValueError(f"censor_mode must be 'global' or 'group', got "
                             f"{self.censor_mode!r}")
        if self.mix_backend not in topo_lib.BACKENDS:
            raise ValueError(f"unknown mix backend {self.mix_backend!r}")
        if self.mix_backend != "dense":
            raise NotImplementedError(
                f"mix_backend={self.mix_backend!r} is not ported yet "
                f"(ROADMAP.md queue A items 9 and 14)")
        if self.groups not in ("model", "leaf"):
            raise NotImplementedError(
                f"groups={self.groups!r}: multi-leaf group specs are not "
                f"ported yet (ROADMAP.md queue A item 8)")
        if self.hat_dtype is not None:
            raise NotImplementedError("hat_dtype is not ported yet")
        if self.regroup_every != 0:
            raise NotImplementedError("regroup_every (auto:K) is not ported "
                                      "yet")

    @property
    def name(self) -> str:
        if not self.alternating:
            return "c-admm" if self.censor.enabled else "jacobian-admm"
        tag = "ggadmm"
        if self.censor.enabled:
            tag = "c-" + tag
        if self.quantize is not None:
            tag = ("cq-" + tag[2:]) if tag.startswith("c-") else "q-" + tag
        return tag


# -------------------------------------------------------------- state --
@dataclasses.dataclass(frozen=True)
class GroupQuantState:
    """Quantizer state: ``q_hat`` (N, d) is the receivers' replica;
    ``(R, b, Δ)`` and the first-round flag are (N, G) float32, G=1."""

    q_hat: torch.Tensor
    range_prev: torch.Tensor
    bits_prev: torch.Tensor
    delta_prev: torch.Tensor
    initialized: torch.Tensor

    @property
    def n_groups(self) -> int:
        return int(self.range_prev.shape[-1])

    @staticmethod
    def create(theta: torch.Tensor, n_groups: int = 1,
               b0: int = 2) -> "GroupQuantState":
        n = theta.shape[0]
        side = dict(dtype=torch.float32, device=theta.device)
        return GroupQuantState(
            q_hat=torch.zeros_like(theta),
            range_prev=torch.zeros((n, n_groups), **side),
            bits_prev=torch.full((n, n_groups), float(b0), **side),
            delta_prev=torch.zeros((n, n_groups), **side),
            initialized=torch.zeros((n, n_groups), **side),
        )


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Every per-worker quantity with leading axis N; ``k`` is the
    iteration counter."""

    theta: torch.Tensor          # per-worker primal theta_n^k
    theta_hat: torch.Tensor      # last *transmitted* value per worker
    alpha: torch.Tensor          # duals alpha_n^k
    quant: GroupQuantState
    k: int = 0


def init_state(theta: torch.Tensor, cfg: EngineConfig) -> EngineState:
    """Engine state from per-worker initial parameters (N, d)."""
    qcfg = cfg.quantize or QuantConfig()
    return EngineState(
        theta=theta,
        theta_hat=torch.zeros_like(theta),
        alpha=torch.zeros_like(theta),            # alpha^0 in col(M_-)
        quant=GroupQuantState.create(theta, 1, b0=qcfg.b0),
        k=0,
    )


# --------------------------------------------------------- quantizers --
def grouped_quantize_step_unfused(
    state: GroupQuantState, theta: torch.Tensor, uniforms: torch.Tensor,
    cfg: QuantConfig,
) -> Tuple[GroupQuantState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stochastic-quantization round (Eqs. 14-20) of a one-leaf tree
    at G=1, through ``ops.stoch_quantize``.

    Returns ``(new_state, candidate (N, d), bits (N, 1), payload (N,))``
    with payload = b d + overhead. A worker whose range is degenerate
    (nothing moved) keeps its old reconstruction."""
    q = state.q_hat
    dim = theta.shape[1]
    range_new = torch.amax(torch.abs(theta.to(torch.float32)
                                     - q.to(torch.float32)),
                           dim=-1, keepdim=True)                 # (N, 1)
    bits, delta, degen = quant_lib.bit_schedule(
        state.bits_prev, range_new, state.range_prev, state.initialized,
        cfg.omega, cfg.b0, cfg.b_max)
    fresh = ops.stoch_quantize(
        theta.to(torch.float32).contiguous(),
        q.to(torch.float32).contiguous(), uniforms.contiguous(),
        torch.clamp_min(delta[:, 0], _EPS).contiguous(),
        range_new[:, 0].contiguous()).to(q.dtype)
    q_hat_new = torch.where(degen, q, fresh)
    new_state = GroupQuantState(
        q_hat=q_hat_new,
        range_prev=torch.where(degen, state.range_prev, range_new),
        bits_prev=bits,
        delta_prev=torch.where(degen, state.delta_prev, delta),
        initialized=torch.ones_like(state.initialized),
    )
    payload = torch.sum(bits * float(dim), dim=-1) \
        + float(state.n_groups * cfg.b_overhead)
    return new_state, q_hat_new, bits, payload


def identity_quantize_step(
    state: GroupQuantState, theta: torch.Tensor,
) -> Tuple[GroupQuantState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unquantized pass-through with 32-bit payload accounting (GGADMM)."""
    n, dim = theta.shape
    new_state = dataclasses.replace(
        state, q_hat=theta.to(state.q_hat.dtype),
        initialized=torch.ones_like(state.initialized))
    bits = torch.full_like(state.bits_prev, 32.0)
    payload = torch.full((n,), 32.0 * dim, dtype=torch.float32,
                         device=theta.device)
    return new_state, theta, bits, payload


# ------------------------------------------------------------ solvers --
@dataclasses.dataclass(frozen=True)
class ExactSolver:
    """A flat ``primal_solve(v, rho_d, theta_init)`` problem (closed form or
    Newton, ``core/solvers.py``) as the engine's local solver."""

    problem: Any

    def solve(self, theta0: torch.Tensor, v: torch.Tensor,
              quad: torch.Tensor) -> torch.Tensor:
        return self.problem.primal_solve(v, quad, theta_init=theta0)


# -------------------------------------------------------------- steps --
def _censor_masks(state: EngineState, candidate: torch.Tensor,
                  cfg: EngineConfig, k_next: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(worker_mask (N,), group_mask (N, 1))``."""
    n = candidate.shape[0]
    if not cfg.censor.enabled:
        ones = torch.ones(n, dtype=torch.float32, device=candidate.device)
        return ones, ones[:, None]
    diff = candidate.to(torch.float32) - state.theta_hat.to(torch.float32)
    tau = censor_lib.threshold(cfg.censor, k_next, candidate.device)
    if cfg.censor_mode == "global":
        change = torch.linalg.vector_norm(diff, dim=-1)
        cmask = (change >= tau).to(torch.float32)
        return cmask, cmask[:, None]
    change_g = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True))
    tau_g = censor_lib.group_thresholds(tau, (diff.shape[1],), diff.shape[1])
    gmask = censor_lib.group_censor_mask(change_g, tau_g)
    return torch.amax(gmask, dim=-1), gmask


def _phase(state: EngineState, phase_mask: torch.Tensor, solver: ExactSolver,
           topo: topo_lib.Topology, rho_d: torch.Tensor, cfg: EngineConfig,
           uniforms: Optional[torch.Tensor]) -> Tuple[EngineState, Metrics]:
    """One group's primal update + quantize + censor + commit. The
    returned metrics are restricted to ``phase_mask`` (zeros elsewhere);
    ``payload_bits`` counts only bits put on the wire (zero when censored),
    ``candidate_payload_bits`` what the round would have cost uncensored."""
    rho = cfg.rho
    neigh = topo.mix(state.theta_hat)
    if cfg.alternating:
        # GGADMM primal, Eqs. (11)/(12)/(21)/(22)
        v = state.alpha.to(torch.float32) - rho * neigh.to(torch.float32)
        quad = rho_d
    else:
        # Jacobian C-ADMM primal (Liu et al., 2019b): proximal self-anchor
        v = (state.alpha.to(torch.float32)
             - rho_d[:, None] * state.theta_hat.to(torch.float32)
             - rho * neigh.to(torch.float32))
        quad = 2.0 * rho_d

    pm = phase_mask[:, None] > 0
    theta = torch.where(pm, solver.solve(state.theta, v, quad), state.theta)

    if cfg.quantize is not None:
        quant_new, candidate, bits, payload = grouped_quantize_step_unfused(
            state.quant, theta, uniforms, cfg.quantize)
    else:
        quant_new, candidate, bits, payload = identity_quantize_step(
            state.quant, theta)

    cmask, gmask = _censor_masks(state, candidate, cfg, state.k + 1)
    tx_mask = cmask * phase_mask
    group_tx = gmask * phase_mask[:, None]
    candidate_payload = payload * phase_mask
    if cfg.censor_mode == "group" and cfg.censor.enabled:
        overhead = float(cfg.quantize.b_overhead) \
            if cfg.quantize is not None else 0.0
        per_group = bits * float(theta.shape[1]) + overhead
        payload_tx = torch.sum(per_group * group_tx, dim=-1)
    else:
        payload_tx = payload * tx_mask

    theta_hat = torch.where(group_tx > 0,
                            candidate.to(state.theta_hat.dtype),
                            state.theta_hat)
    q_old = state.quant
    quant = GroupQuantState(
        q_hat=torch.where(pm, quant_new.q_hat, q_old.q_hat),
        range_prev=torch.where(pm, quant_new.range_prev, q_old.range_prev),
        bits_prev=torch.where(pm, quant_new.bits_prev, q_old.bits_prev),
        delta_prev=torch.where(pm, quant_new.delta_prev, q_old.delta_prev),
        initialized=torch.where(pm, quant_new.initialized,
                                q_old.initialized),
    )
    new_state = dataclasses.replace(state, theta=theta, theta_hat=theta_hat,
                                    quant=quant)
    return new_state, {
        "tx_mask": tx_mask,
        "payload_bits": payload_tx,
        "candidate_payload_bits": candidate_payload,
        "bits_per_group": bits * phase_mask[:, None],
        "group_tx": group_tx,
    }


def make_step(graph: WorkerGraph, cfg: EngineConfig, solver: ExactSolver,
              extra_metrics: Optional[MetricsFn] = None, *,
              topology: Optional[topo_lib.Topology] = None,
              device: Optional[Union[str, torch.device]] = None):
    """Build the per-iteration step ``step(state, draw) -> (state,
    metrics)``. ``draw(phase)`` returns the (N, d) float32 uniforms of
    phase 0 (heads, or the single Jacobian phase) or 1 (tails); it is
    called only when the config quantizes. Metrics carry per-worker
    ``tx_mask``, ``payload_bits``, ``candidate_payload_bits``,
    ``bits_per_group``, ``group_tx`` and ``dual_residual``
    ``||rho (D - A) theta_hat||²``, plus ``extra_metrics(state)``."""
    topo = topology if topology is not None else topo_lib.build(
        graph, cfg.mix_backend, device=device)
    dev = topo.degrees.device
    head = torch.as_tensor(graph.head_mask, dtype=torch.float32, device=dev)
    tail = 1.0 - head
    rho_d = cfg.rho * topo.degrees

    def step(state: EngineState, draw: Callable[[int], torch.Tensor]):
        def uniforms(phase: int) -> Optional[torch.Tensor]:
            return draw(phase) if cfg.quantize is not None else None

        if cfg.alternating:
            state, m_h = _phase(state, head, solver, topo, rho_d, cfg,
                                uniforms(0))
            state, m_t = _phase(state, tail, solver, topo, rho_d, cfg,
                                uniforms(1))
            metrics = {k: m_h[k] + m_t[k] for k in m_h}
        else:
            state, metrics = _phase(state, torch.ones_like(head), solver,
                                    topo, rho_d, cfg, uniforms(0))

        # Dual update, Eq. (23): alpha += rho * (D - A) theta_hat, through
        # the same topology (and mix kernel) as the phase mixes.
        lap = topo.laplacian(state.theta_hat)
        alpha = (state.alpha.to(torch.float32)
                 + cfg.rho * lap).to(state.alpha.dtype)
        state = dataclasses.replace(state, alpha=alpha, k=state.k + 1)
        metrics["dual_residual"] = (cfg.rho ** 2) * topo.dual_residual(lap)
        if extra_metrics is not None:
            metrics.update(extra_metrics(state))
        return state, metrics

    return step


def flat_metrics(graph: WorkerGraph,
                 mix_backend: Union[str, topo_lib.Topology] = "dense", *,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> MetricsFn:
    """Flat-stepper diagnostics: the pairwise primal residual (Eq. 28) and
    the theta trajectory (for objective / distance-to-optimum curves).
    ``mix_backend`` may be an already-built topology."""
    topo = (mix_backend if isinstance(mix_backend, topo_lib.Topology)
            else topo_lib.build(graph, mix_backend, device=device))

    def fn(state: EngineState) -> Metrics:
        return {"primal_residual": topo.primal_residual(state.theta),
                "theta": state.theta}

    return fn


def run(graph: WorkerGraph, cfg: EngineConfig, solver: ExactSolver,
        theta0: torch.Tensor, iters: int, seed: int = 0,
        extra_metrics: Optional[MetricsFn] = None,
        topology: Optional[topo_lib.Topology] = None,
        uniforms: Optional[Uniforms] = None,
        ) -> Tuple[EngineState, Metrics]:
    """Run ``iters`` iterations from ``theta0`` on ``theta0``'s device and
    return the final state plus per-iteration metrics stacked on a leading
    axis. The uniforms come from a ``torch.Generator`` seeded with
    ``seed``, or from ``uniforms(iteration, phase)`` when given."""
    dev = theta0.device
    state = init_state(theta0, cfg)
    step = make_step(graph, cfg, solver, extra_metrics, topology=topology,
                     device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw_for(it: int) -> Callable[[int], torch.Tensor]:
        def draw(phase: int) -> torch.Tensor:
            if uniforms is not None:
                return uniforms(it, phase).to(device=dev, dtype=torch.float32)
            return torch.rand(theta0.shape, generator=gen, device=dev)
        return draw

    history: List[Metrics] = []
    for it in range(iters):
        state, m = step(state, draw_for(it))
        history.append(m)
    stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return state, stacked
