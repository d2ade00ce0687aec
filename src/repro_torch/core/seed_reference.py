"""FROZEN seed flat stepper: the golden reference of the engine.

The port of ``repro.core.seed_reference``: the original flat ``(N, d)``
CQ-GGADMM stepper from before the engine refactor, kept so that the tests
and the engine-smoke campaign (``bench/engine.py``) can hold the unified
engine (``core/engine.py``) against it. Its contract: the engine with a
one-leaf tree at G=1 reproduces it bit for bit, given the same uniforms;
and the walltime stage times the engine against this hot path.

It reads only the fields of the config that the seed's ``ADMMConfig`` had
(rho, alternating, censor, quantize). Its payload is the seed's: the
phase's workers are charged the full candidate payload, censored or not,
which is the engine's ``candidate_payload_bits``. The stochastic-rounding
uniforms are ``(N, d)`` per phase from ``uniforms(iteration, phase)``, or
from a ``torch.Generator`` seeded with ``seed``, drawn in the engine's
order. Each neighbour sum is ``ops.bipartite_mix`` and each quantize
``ops.stoch_quantize``: the kernels on a CUDA tensor, their plain versions
on a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.censoring import censor_mask
from repro_torch.core.graph import WorkerGraph
from repro_torch.core.quantization import QuantConfig, bit_schedule
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_EPS = 1e-12

Uniforms = Callable[[int, int], torch.Tensor]   # (iteration, phase) -> (N, d)


@dataclasses.dataclass(frozen=True)
class QuantizerState:
    """Per-worker quantizer state: ``q_hat`` (N, d), the receivers'
    replica; range, bit width, step size and first-round flag (N,)."""

    q_hat: torch.Tensor
    range_prev: torch.Tensor
    bits_prev: torch.Tensor
    delta_prev: torch.Tensor
    initialized: torch.Tensor

    @staticmethod
    def create(n_workers: int, dim: int, b0: int = 2,
               device=None) -> "QuantizerState":
        side = dict(dtype=torch.float32, device=device)
        return QuantizerState(
            q_hat=torch.zeros((n_workers, dim), **side),
            range_prev=torch.zeros((n_workers,), **side),
            bits_prev=torch.full((n_workers,), float(b0), **side),
            delta_prev=torch.zeros((n_workers,), **side),
            initialized=torch.zeros((n_workers,), **side),
        )


@dataclasses.dataclass(frozen=True)
class SeedState:
    theta: torch.Tensor        # (N, d) primal variables theta_n^k
    theta_hat: torch.Tensor    # (N, d) last *transmitted* value
    alpha: torch.Tensor        # (N, d) duals
    quant: QuantizerState      # quantizer replicas (inert when unquantized)
    k: int                     # iteration counter


def init_state(n_workers: int, dim: int, cfg, device=None) -> SeedState:
    qcfg = cfg.quantize or QuantConfig()
    dev = resolve_device(device)
    zeros = torch.zeros((n_workers, dim), dtype=torch.float32, device=dev)
    return SeedState(theta=zeros, theta_hat=zeros.clone(),
                     alpha=zeros.clone(),
                     quant=QuantizerState.create(n_workers, dim, qcfg.b0,
                                                 dev),
                     k=0)


def quantize_step(state: QuantizerState, theta: torch.Tensor,
                  uniforms: torch.Tensor, cfg: QuantConfig
                  ) -> Tuple[QuantizerState, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One quantization round for all workers (Eqs. 14-20) through
    ``ops.stoch_quantize``. Returns ``(new_state, q_hat_new, bits,
    payload_bits)``, payload ``b_n d + overhead``."""
    d = theta.shape[1]
    range_new = torch.amax(torch.abs(theta - state.q_hat), dim=-1)  # (N,)
    bits, delta, degen = bit_schedule(
        state.bits_prev, range_new, state.range_prev, state.initialized,
        cfg.omega, cfg.b0, cfg.b_max)
    fresh = ops.stoch_quantize(theta.contiguous(), state.q_hat.contiguous(),
                               uniforms.contiguous(), delta.contiguous(),
                               range_new.contiguous())
    q_hat_new = torch.where(degen[:, None], state.q_hat, fresh)
    new_state = QuantizerState(
        q_hat=q_hat_new,
        range_prev=torch.where(degen, state.range_prev, range_new),
        bits_prev=bits,
        delta_prev=torch.where(degen, state.delta_prev, delta),
        initialized=torch.ones_like(state.initialized),
    )
    return new_state, q_hat_new, bits, bits * float(d) + float(
        cfg.b_overhead)


def identity_quantize_step(state: QuantizerState, theta: torch.Tensor
                           ) -> Tuple[QuantizerState, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Unquantized pass-through with 32-bit payload accounting (GGADMM)."""
    n, d = theta.shape
    new_state = dataclasses.replace(
        state, q_hat=theta, initialized=torch.ones_like(state.initialized))
    full = dict(dtype=torch.float32, device=theta.device)
    return (new_state, theta, torch.full((n,), 32.0, **full),
            torch.full((n,), 32.0 * d, **full))


def _phase(state: SeedState, group_mask: torch.Tensor, solver,
           adjacency: torch.Tensor, rho_d: torch.Tensor, cfg,
           uniforms: Optional[torch.Tensor]
           ) -> Tuple[SeedState, torch.Tensor, torch.Tensor]:
    rho = cfg.rho
    neigh = ops.bipartite_mix(adjacency, state.theta_hat.contiguous())
    if cfg.alternating:
        v = state.alpha - rho * neigh
        quad = rho_d
    else:
        v = state.alpha - rho_d[:, None] * state.theta_hat - rho * neigh
        quad = 2.0 * rho_d
    theta_new_full = solver.primal_solve(v, quad, theta_init=state.theta)
    gm = group_mask[:, None]
    theta = torch.where(gm > 0, theta_new_full, state.theta)

    if cfg.quantize is not None:
        quant_new, candidate, _, payload = quantize_step(
            state.quant, theta, uniforms, cfg.quantize)
    else:
        quant_new, candidate, _, payload = identity_quantize_step(
            state.quant, theta)

    cmask = censor_mask(state.theta_hat, candidate, cfg.censor, state.k + 1)
    tx_mask = cmask * group_mask
    theta_hat = torch.where(tx_mask[:, None] > 0, candidate, state.theta_hat)

    def commit(new, old):
        return torch.where((gm if new.dim() == 2 else group_mask) > 0,
                           new, old)

    quant = QuantizerState(*(commit(getattr(quant_new, f.name),
                                    getattr(state.quant, f.name))
                             for f in dataclasses.fields(QuantizerState)))
    new_state = dataclasses.replace(state, theta=theta, theta_hat=theta_hat,
                                    quant=quant)
    return new_state, tx_mask, payload * group_mask


def make_step(graph: WorkerGraph, solver, cfg, device=None):
    """``step(state, draw) -> (state, metrics)``; ``draw(phase)`` returns
    the (N, d) uniforms of phase 0 (heads, or the Jacobian phase) or 1
    (tails) and is called only when the config quantizes."""
    dev = resolve_device(device)
    adjacency = torch.as_tensor(graph.adjacency, dtype=torch.float32,
                                device=dev).contiguous()
    degrees = torch.as_tensor(graph.degrees, dtype=torch.float32,
                              device=dev)
    head = torch.as_tensor(graph.head_mask, dtype=torch.float32, device=dev)
    tail = 1.0 - head
    rho_d = cfg.rho * degrees

    def step(state: SeedState, draw: Callable[[int], torch.Tensor]):
        def uniforms(phase: int) -> Optional[torch.Tensor]:
            return draw(phase) if cfg.quantize is not None else None

        if cfg.alternating:
            state, tx_h, pay_h = _phase(state, head, solver, adjacency,
                                        rho_d, cfg, uniforms(0))
            state, tx_t, pay_t = _phase(state, tail, solver, adjacency,
                                        rho_d, cfg, uniforms(1))
            tx_mask = tx_h + tx_t
            payload = pay_h + pay_t
        else:
            state, tx_mask, payload = _phase(state, torch.ones_like(head),
                                             solver, adjacency, rho_d, cfg,
                                             uniforms(0))

        lap = (degrees[:, None] * state.theta_hat
               - ops.bipartite_mix(adjacency, state.theta_hat.contiguous()))
        alpha = state.alpha + cfg.rho * lap
        state = dataclasses.replace(state, alpha=alpha, k=state.k + 1)

        diffs = state.theta[:, None, :] - state.theta[None, :, :]
        primal_res = torch.sum(adjacency
                               * torch.sum(diffs ** 2, dim=-1)) / 2.0
        return state, {"tx_mask": tx_mask, "payload_bits": payload,
                       "primal_residual": primal_res, "theta": state.theta}

    return step


def run(graph: WorkerGraph, solver, cfg, dim: int, iters: int,
        seed: int = 0, theta_star: Optional[torch.Tensor] = None,
        local_loss: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        uniforms: Optional[Uniforms] = None,
        device: Optional[Union[str, torch.device]] = None,
        ) -> Tuple[SeedState, Dict[str, Any]]:
    """``iters`` iterations from zero on ``device`` (the card unless the
    caller asks for the CPU); returns the final state and numpy
    per-iteration metrics (tx_mask, payload_bits, primal_residual, and
    objective / dist_to_opt when ``local_loss`` / ``theta_star`` are
    given)."""
    dev = resolve_device(device)
    state = init_state(graph.n, dim, cfg, dev)
    step = make_step(graph, solver, cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    history: List[Dict[str, torch.Tensor]] = []
    for it in range(iters):
        def draw(phase: int, it=it) -> torch.Tensor:
            if uniforms is not None:
                return uniforms(it, phase).to(device=dev,
                                              dtype=torch.float32)
            return torch.rand((graph.n, dim), generator=gen, device=dev)
        state, m = step(state, draw)
        history.append(m)
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    out = {k: metrics[k] for k in ("tx_mask", "payload_bits",
                                   "primal_residual")}
    thetas = metrics["theta"]                       # (K, N, d)
    if local_loss is not None:
        out["objective"] = torch.stack(
            [torch.sum(local_loss(th)) for th in thetas])
    if theta_star is not None:
        err = thetas - theta_star[None, None, :]
        out["dist_to_opt"] = torch.sum(err ** 2, dim=(1, 2))
    return state, {k: v.cpu().numpy() for k, v in out.items()}
