"""GGADMM / C-GGADMM / CQ-GGADMM — the paper's Algorithms 1 and 2.

Flat-vector adapter over the engine (``core/engine.py``) with the JAX
package's surface: :class:`ADMMConfig` (the engine config),
``init_state(n_workers, dim, cfg)``, ``make_step(graph, solver, cfg)`` and
``run(graph, solver, cfg, dim, iters, ...)`` with the same metrics
(tx_mask, payload_bits, primal_residual, objective, dist_to_opt). The
solver's tensors fix the device; ``device`` defaults to the CUDA card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import engine as E
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ExactSolver
from repro_torch.device import resolve_device

ADMMConfig = E.EngineConfig
ADMMState = E.EngineState
Device = Optional[Union[str, torch.device]]


def init_state(n_workers: int, dim: int, cfg: ADMMConfig,
               device: Device = None) -> ADMMState:
    return E.init_state(torch.zeros((n_workers, dim), dtype=torch.float32,
                                    device=resolve_device(device)), cfg)


def make_step(graph, solver, cfg: ADMMConfig, device: Device = None):
    """The per-iteration step ``step(state, draw) -> (state, metrics)``
    (see ``engine.make_step``), with the flat diagnostics."""
    topo = topo_lib.build(graph, cfg.mix_backend, device=device)
    return E.make_step(graph, cfg, ExactSolver(solver),
                       extra_metrics=E.flat_metrics(graph, topo),
                       topology=topo)


def run(graph, solver, cfg: ADMMConfig, dim: int, iters: int, seed: int = 0,
        theta_star: Optional[torch.Tensor] = None,
        local_loss: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        uniforms: Optional[E.Uniforms] = None, device: Device = None,
        ) -> Tuple[ADMMState, Dict[str, Any]]:
    """Run ``iters`` iterations and return the final state plus numpy
    per-iteration metrics. With ``local_loss`` ((N, d) -> (N,)) and/or
    ``theta_star`` the objective and distance-to-optimum trajectories are
    included. ``payload_bits`` counts only transmitted bits."""
    dev = resolve_device(device)
    theta0 = torch.zeros((graph.n, dim), dtype=torch.float32, device=dev)
    topo = topo_lib.build(graph, cfg.mix_backend, device=dev)
    final_state, metrics = E.run(
        graph, cfg, ExactSolver(solver), theta0, iters, seed=seed,
        extra_metrics=E.flat_metrics(graph, topo), topology=topo,
        uniforms=uniforms)
    out: Dict[str, Any] = {
        "tx_mask": metrics["tx_mask"],
        "payload_bits": metrics["payload_bits"],
        "candidate_payload_bits": metrics["candidate_payload_bits"],
        "primal_residual": metrics["primal_residual"],
    }
    thetas = metrics["theta"]                      # (K, N, d)
    if local_loss is not None:
        out["objective"] = torch.stack(
            [torch.sum(local_loss(th)) for th in thetas])
    if theta_star is not None:
        err = thetas - theta_star[None, None, :]
        out["dist_to_opt"] = torch.sum(err ** 2, dim=(1, 2))
    return final_state, {k: v.cpu().numpy() for k, v in out.items()}
