"""CQ-GGADMM over model parameter trees: decentralized training.

The port of ``repro.core.consensus``: a thin adapter over the engine
(``core/engine.py``) with the JAX package's training API,
:class:`ConsensusConfig`, :func:`init_consensus_state` and
:func:`make_consensus_step`. The exact local argmin (Eqs. 21/22) is
replaced by ``local_steps`` Adam iterations on the augmented Lagrangian
(inexact ADMM, as in the JAX package). ``payload_bits`` counts only
transmitted bits; ``candidate_payload_bits`` is the uncensored cost.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import engine as E
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.quantization import QuantConfig

Tree = Any


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Hyperparameters of tree CQ-GGADMM (the engine config plus the
    inexact local solver)."""

    rho: float = 0.01
    censor: CensorConfig = dataclasses.field(default_factory=CensorConfig)
    quantize: Optional[QuantConfig] = None
    local_steps: int = 4          # inexact-argmin Adam iterations
    local_lr: float = 1e-3
    use_adam: bool = True         # False: plain SGD, no moments
    hat_dtype: Optional[str] = None  # narrowed replicas: not ported
    groups: E.GroupSpec = "model"    # "leaf" => L-FGADMM layer-wise mode
    censor_mode: str = "global"      # "group" => per-group censoring

    def engine_config(self) -> E.EngineConfig:
        return E.EngineConfig(
            rho=self.rho, alternating=True, censor=self.censor,
            quantize=self.quantize, groups=self.groups,
            censor_mode=self.censor_mode, hat_dtype=self.hat_dtype)

    def solver(self, grad_fn: Optional[Callable] = None) -> E.InexactSolver:
        return E.InexactSolver(grad_fn=grad_fn,
                               local_steps=self.local_steps,
                               local_lr=self.local_lr,
                               use_adam=self.use_adam)


ConsensusState = E.EngineState


def init_consensus_state(theta: Tree, cfg: ConsensusConfig) -> ConsensusState:
    return E.init_state(theta, cfg.engine_config(), cfg.solver())


def make_consensus_step(graph, cfg: ConsensusConfig,
                        grad_fn: Callable[[Tree, Any], Tree],
                        loss_fn: Optional[Callable] = None, *, device=None):
    """The training step ``step(state, draw, batch) -> (state, metrics)``.

    ``grad_fn(theta, batch)`` returns the per-worker gradient tree; every
    leaf of ``theta`` and ``batch`` carries the leading worker axis N.
    ``draw(phase)`` returns the phase's (N, D) rounding uniforms."""
    return E.make_step(graph, cfg.engine_config(), cfg.solver(grad_fn),
                       extra_metrics=E.consensus_metrics(loss_fn),
                       device=device)
