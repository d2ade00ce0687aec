"""Carry parameters, engine state and problem data across from the JAX
package as numpy.

Trees travel as keystr-path -> array mappings, the layout of the JAX
package's checkpoints: ``['stack']['units']['p0']['cell']['q']['w']``.
A JAX ``EngineState`` flattens to the keys ``theta<path>``,
``theta_hat<path>``, ``alpha<path>``, ``quant.q_hat<path>``,
``opt_mu<path>``, ``opt_nu<path>`` (one key per leaf; ``<path>`` is empty
for a bare (N, d) array), the (N, G) side information
``quant.range_prev``, ``quant.bits_prev``, ``quant.delta_prev``,
``quant.initialized`` and ``k``. This module turns such mappings into the
port's trees and :class:`~repro_torch.core.engine.EngineState` on a
device, and back. It imports neither JAX nor the JAX package: the caller
hands it arrays.

Leaves are float32, or narrowed replicas (``hat_dtype``) in float16 or
bfloat16. ``np.asarray`` of a JAX bfloat16 array is an ``ml_dtypes``
bfloat16 array, which ``torch.from_numpy`` refuses: its bits cross as a
``uint16`` view (as the serving swap payload's do), and a bfloat16 leaf
goes back the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.engine import EngineState, GroupQuantState
from repro_torch.core.solvers import (LinearRegressionProblem,
                                      LogisticRegressionProblem)
from repro_torch.device import resolve_device

Device = Optional[Union[str, torch.device]]
QUANT_FIELDS = ("q_hat", "range_prev", "bits_prev", "delta_prev",
                "initialized")
TREE_FIELDS = ("theta", "theta_hat", "alpha", "quant.q_hat", "opt_mu",
               "opt_nu")
SIDE_FIELDS = ("range_prev", "bits_prev", "delta_prev", "initialized")


def tensor_from_numpy(a, device: Device = None) -> torch.Tensor:
    """One float32, float16 or bfloat16 array (a JAX array, or its numpy
    copy) as a tensor on ``device``."""
    dev = resolve_device(device)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    if arr.dtype not in (np.float32, np.float16):
        raise ValueError(f"expected float32, float16 or bfloat16 arrays, "
                         f"got {arr.dtype}")
    return torch.as_tensor(arr.copy(), device=dev)


def _array(x: torch.Tensor) -> np.ndarray:
    """A leaf as numpy; bfloat16 as its bits in an ``ml_dtypes`` bfloat16
    array (the dtype JAX hands out)."""
    x = x.detach().cpu()
    if x.dtype != torch.bfloat16:
        return x.numpy()
    import ml_dtypes  # numpy's bfloat16; imported only for such a leaf

    return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)


def tree_from_numpy(flat: Mapping[str, np.ndarray],
                    device: Device = None) -> Any:
    """A keystr-path -> array mapping (e.g. a JAX params tree flattened
    with ``jax.tree_util.keystr``) as the port's tree."""
    dev = resolve_device(device)
    return T.from_paths({k: tensor_from_numpy(v, dev) for k, v in flat.items()})


def model_params_from_numpy(flat: Mapping[str, np.ndarray], cfg,
                            device: Device = None) -> Any:
    """One model's parameters (no worker axis) from the JAX package's
    ``registry.init_params(cfg, key)`` tree flattened to keystr paths, e.g.
    ``['stack']['units']['p0']['attn']['q']['w']`` (22, 2048, 2048) for
    tinyllama-1.1b, or whisper's ``['encoder']...`` and
    ``['enc_final_norm']['scale']`` leaves beside its "xattn" stack. Every
    leaf must have the port's shape for ``cfg``."""
    from repro_torch.models import registry

    want = T.to_paths(registry.init_params(cfg, None, device="meta"))
    if set(flat) != set(want):
        raise ValueError(f"parameter paths differ from {cfg.name}'s: "
                         f"missing {sorted(set(want) - set(flat))}, extra "
                         f"{sorted(set(flat) - set(want))}")
    for path, leaf in want.items():
        if tuple(np.shape(flat[path])) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {np.shape(flat[path])}, "
                             f"expected {tuple(leaf.shape)}")
    params = tree_from_numpy(flat, device)
    params["stack"].setdefault("rem", {})
    params["stack"].setdefault("units", {})
    return params


def tree_to_numpy(tree: Any) -> Dict[str, np.ndarray]:
    """keystr path -> numpy array, the inverse of :func:`tree_from_numpy`."""
    return {k: _array(v) for k, v in T.to_paths(tree).items()}


def _field(d: Mapping[str, np.ndarray], name: str) -> Dict[str, Any]:
    """The sub-mapping of ``name<path>`` keys, keyed by ``<path>``."""
    return {k[len(name):]: v for k, v in d.items()
            if k == name or k.startswith(name + "[")}


def engine_state_from_numpy(d: Mapping[str, np.ndarray],
                            device: Device = None) -> EngineState:
    """The port's engine state from a flattened JAX one- or multi-leaf
    state."""
    dev = resolve_device(device)
    trees = {}
    for name in TREE_FIELDS:
        sub = _field(d, name)
        trees[name] = (T.from_paths({k: tensor_from_numpy(v, dev)
                                     for k, v in sub.items()})
                       if sub else ())
    first = T.leaves(trees["theta"])[0]
    if first.dim() < 2 and not isinstance(trees["theta"], dict):
        raise ValueError(f"theta must be (N, d), got {tuple(first.shape)}")
    side = {f: tensor_from_numpy(d[f"quant.{f}"], dev) for f in SIDE_FIELDS}
    n = first.shape[0]
    for f, x in side.items():
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"quant.{f} must be (N, G) with N={n}, got "
                             f"{tuple(x.shape)}")
    quant = GroupQuantState(q_hat=trees["quant.q_hat"], **side)
    return EngineState(theta=trees["theta"], theta_hat=trees["theta_hat"],
                       alpha=trees["alpha"], quant=quant,
                       opt_mu=trees["opt_mu"], opt_nu=trees["opt_nu"],
                       k=int(np.asarray(d["k"])))


def engine_state_to_numpy(state: EngineState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`engine_state_from_numpy`."""
    out: Dict[str, np.ndarray] = {}
    trees = {"theta": state.theta, "theta_hat": state.theta_hat,
             "alpha": state.alpha, "quant.q_hat": state.quant.q_hat,
             "opt_mu": state.opt_mu, "opt_nu": state.opt_nu}
    for name, tree in trees.items():
        if isinstance(tree, tuple):         # a solver without moments
            continue
        for path, leaf in T.to_paths(tree).items():
            out[name + path] = _array(leaf)
    out.update({f"quant.{f}": getattr(state.quant, f).cpu().numpy()
                for f in SIDE_FIELDS})
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
