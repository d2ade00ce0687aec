"""Carry state and problem data across from the JAX package as numpy.

The JAX ``EngineState`` of a one-leaf run, flattened to numpy, uses the
keys ``theta``, ``theta_hat``, ``alpha``, ``quant.q_hat``,
``quant.range_prev``, ``quant.bits_prev``, ``quant.delta_prev``,
``quant.initialized`` and ``k``. This module turns such a mapping into the
port's :class:`~repro_torch.core.engine.EngineState` on a device, and back.
It imports neither JAX nor the JAX package: the caller hands it arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core.engine import EngineState, GroupQuantState
from repro_torch.core.solvers import (LinearRegressionProblem,
                                      LogisticRegressionProblem)
from repro_torch.device import resolve_device

Device = Optional[Union[str, torch.device]]
QUANT_FIELDS = ("q_hat", "range_prev", "bits_prev", "delta_prev",
                "initialized")


def _tensor(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32:
        raise ValueError(f"expected float32 arrays, got {arr.dtype}")
    return torch.as_tensor(arr.copy(), device=dev)


def engine_state_from_numpy(d: Mapping[str, np.ndarray],
                            device: Device = None) -> EngineState:
    """The port's engine state from a flattened JAX one-leaf state."""
    dev = resolve_device(device)
    theta = _tensor(d["theta"], dev)
    if theta.dim() != 2:
        raise ValueError(f"theta must be (N, d), got {tuple(theta.shape)}")
    quant = GroupQuantState(**{f: _tensor(d[f"quant.{f}"], dev)
                               for f in QUANT_FIELDS})
    if quant.range_prev.shape != (theta.shape[0], 1):
        raise ValueError("only one-group (G=1) quantizer state is ported, got "
                         f"side information of shape "
                         f"{tuple(quant.range_prev.shape)}")
    return EngineState(theta=theta, theta_hat=_tensor(d["theta_hat"], dev),
                       alpha=_tensor(d["alpha"], dev), quant=quant,
                       k=int(np.asarray(d["k"])))


def engine_state_to_numpy(state: EngineState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`engine_state_from_numpy`."""
    out = {name: getattr(state, name).cpu().numpy()
           for name in ("theta", "theta_hat", "alpha")}
    out.update({f"quant.{f}": getattr(state.quant, f).cpu().numpy()
                for f in QUANT_FIELDS})
    out["k"] = np.asarray(state.k, np.int32)
    return out


def problem_from_numpy(x: np.ndarray, y: np.ndarray, task: str,
                       device: Device = None):
    """Per-worker data x (N, s, d), y (N, s) as the port's problem object
    for ``task`` "linear" (closed form) or "logistic" (Newton)."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.ascontiguousarray(y, np.float32), device=dev)
    if task == "linear":
        return LinearRegressionProblem(xt, yt)
    if task == "logistic":
        return LogisticRegressionProblem(xt, yt)
    raise ValueError(f"unknown task {task!r}; expected 'linear' or "
                     f"'logistic'")
