"""D-GGADMM: (CQ-)GGADMM under a time-varying bipartite topology.

The port of ``repro.core.dynamic``. Every ``refresh_every`` iterations a
new random connected bipartite graph is drawn and the duals are
re-initialized to lie in the column space of the new signed incidence
matrix (the Thm-3 initialization condition; alpha = 0, the paper's own
choice). Censoring state (last transmitted values) and quantizer replicas
survive the switch. Each refresh builds the topology backend of
``cfg.mix_backend`` anew (for the sparse backend, a new neighbor table on
the host, moved to the device once).

An extension beyond the reproduced paper (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import topology as topology_backend
from repro_torch.core import tree as T
from repro_torch.core.graph import WorkerGraph, random_bipartite_graph
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DynamicTopology:
    n_workers: int
    p: float = 0.35
    refresh_every: int = 50
    seed: int = 0

    def graph_at(self, phase: int) -> WorkerGraph:
        return random_bipartite_graph(self.n_workers, self.p,
                                      seed=self.seed + phase)


# ---------------------------------------------- dual column-space helpers --
def project_duals(alpha: E.Tree, graph: WorkerGraph) -> E.Tree:
    """Orthogonal projection of the duals onto ``col(M_-)`` of ``graph``.

    For a connected graph ``col(M_-) = col(L) = 1^⊥``, the vectors whose
    per-coordinate sum over workers vanishes, so the projection is
    per-coordinate mean subtraction over the worker axis, leaf-wise. The
    Eq. (23) dual update maps into 1^⊥, so one projection after a change
    keeps the Thm-3 condition for the rest of the run."""
    del graph

    def proj(a):
        a32 = a.to(torch.float32)
        return (a32 - torch.mean(a32, dim=0, keepdim=True)).to(a.dtype)
    return T.tree_map(proj, alpha)


def reinit_duals(alpha: E.Tree, graph: WorkerGraph,
                 mode: str = "zero") -> E.Tree:
    """Re-initialize duals after a topology refresh or membership change so
    that ``alpha^0 ∈ col(M_-)`` of the new graph: ``"zero"`` (the paper's
    choice) or ``"project"`` (keep the survivors' dual momentum)."""
    if mode == "zero":
        return T.tree_map(torch.zeros_like, alpha)
    if mode == "project":
        return project_duals(alpha, graph)
    raise ValueError(f"unknown dual reinit mode {mode!r}")


def dual_in_col_space(alpha: E.Tree, graph: WorkerGraph,
                      atol: float = 1e-4) -> bool:
    """Host-side check of the Thm-3 condition: every coordinate of the
    stacked dual tree lies in ``col(M_-)`` of ``graph`` (least-squares
    residual against the signed incidence matrix below ``atol`` relative
    to the dual's norm). The runtime paths use the closed form above."""
    m = np.asarray(graph.signed_incidence, np.float64)              # (N, E)
    flat = E._flatten_worker(alpha).detach().cpu().numpy().astype(np.float64)
    sol, *_ = np.linalg.lstsq(m, flat, rcond=None)
    resid = m @ sol - flat
    scale = max(float(np.linalg.norm(flat)), 1.0)
    return float(np.linalg.norm(resid)) <= atol * scale


def run_dynamic(topology: DynamicTopology, solver, cfg: E.EngineConfig,
                dim: int, iters: int, seed: int = 0,
                theta_star: Optional[torch.Tensor] = None,
                local_loss=None, *,
                uniforms: Optional[E.Uniforms] = None,
                device: Optional[Union[str, torch.device]] = None,
                ) -> Tuple[E.EngineState, Dict[str, Any]]:
    """Run (CQ-G)GADMM with the topology redrawn every ``refresh_every``
    iterations; ``solver`` is the flat problem (``core/solvers.py``).
    Metrics are those of ``cq_ggadmm.run`` (numpy). The (N, dim) rounding
    draws come from a ``torch.Generator`` seeded with ``seed``, or from
    ``uniforms(iteration, phase)`` (iterations counted over the whole
    run) when given."""
    dev = resolve_device(device)
    state = E.init_state(torch.zeros((topology.n_workers, dim),
                                     dtype=torch.float32, device=dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (topology.n_workers, dim)

    def draw_for(it: int):
        def draw(phase: int) -> torch.Tensor:
            if uniforms is not None:
                return uniforms(it, phase).to(device=dev, dtype=torch.float32)
            return torch.rand(shape, generator=gen, device=dev)
        return draw

    history = []
    n_phases = -(-iters // topology.refresh_every)
    for phase in range(n_phases):
        graph = topology.graph_at(phase)
        topo = topology_backend.build(graph, cfg.mix_backend, device=dev)
        step = E.make_step(graph, cfg, E.ExactSolver(solver),
                           extra_metrics=E.flat_metrics(graph, topo),
                           topology=topo)
        # alpha = 0 lies in col(M_-) of any graph
        state = dataclasses.replace(
            state, alpha=reinit_duals(state.alpha, graph, mode="zero"))
        start = phase * topology.refresh_every
        for it in range(start, min(start + topology.refresh_every, iters)):
            state, m = step(state, draw_for(it))
            history.append(m)

    stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    out: Dict[str, Any] = {k: stacked[k] for k in (
        "tx_mask", "payload_bits", "candidate_payload_bits",
        "primal_residual")}
    thetas = stacked["theta"]                        # (K, N, d)
    if local_loss is not None:
        out["objective"] = torch.stack(
            [torch.sum(local_loss(th)) for th in thetas])
    if theta_star is not None:
        err = thetas - theta_star[None, None, :]
        out["dist_to_opt"] = torch.sum(err ** 2, dim=(1, 2))
    return state, {k: v.cpu().numpy() for k, v in out.items()}
