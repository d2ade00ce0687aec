"""AdamW and SGD over the port's dict trees (the port of
``repro.optim.adamw``), for the FSDP-Adam baseline trainer
(``launch/train.py --mode fsdp``).

The update is the JAX package's float32 evaluation as XLA compiles it,
operation for operation: the bias corrections ``1 - b**count`` with
``count`` and the power in float32; ``m``, ``v`` and the step in float32
whatever the parameter dtype; ``step = (m/b1c) / (sqrt(v/b2c) + eps) +
wd·p32``, which XLA rewrites as ``m / (b1c·(sqrt(v/b2c) + eps))``; the
parameter written back as ``(p32 - lr·step).to(p.dtype)``. XLA contracts
each ``a·x + y`` of the update into one fused multiply-add (one rounding);
:func:`_fma` evaluates those in float64, where a float32 product is exact,
and rounds once to float32; the square root is taken there too (PyTorch's
vectorized float32 ``sqrt`` on the CPU can be an ulp off). Divisions take
the corrections as tensors on the leaf's device (PyTorch turns a division
by a host scalar on the card into a multiply by its reciprocal, another
rounding). The same formula in plain float32 operations misses the jitted
update by up to 8 ulp in the parameters and 446 in the moments, where
``b1·m + (1-b1)·g`` cancels (``tests/test_torch_fsdp.py``,
``test_plain_float32_update_is_further_than_two_ulp_from_jax``).

It is not ``torch.optim.AdamW``, which puts ``eps`` after
``sqrt(v)/sqrt(b2c)`` and applies the decay as a separate multiply
(another function at ``wd != 0``, other roundings at ``wd = 0``). Plain
PyTorch: the JAX package has no kernel here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def adamw_init(params) -> AdamWState:
    """Float32 zero moments shaped like ``params``, count 0."""
    zeros = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    return AdamWState(mu=zeros, nu=T.tree_map(torch.clone, zeros), count=0)


def bias_corrections(count: int, cfg: AdamWConfig) -> Tuple[float, float]:
    """(1 - b1**count, 1 - b2**count) in float32, as the JAX package casts
    ``count`` to float32 before the power: the power of the float32 base
    correctly rounded to float32, which is what XLA's ``pow`` returns
    (numpy's float32 ``power`` is an ulp off at some counts)."""
    def corr(b):
        power = np.float32(np.float64(np.float32(b)) ** np.float64(count))
        return float(np.float32(1.0) - power)
    return corr(cfg.b1), corr(cfg.b2)


def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32(a·x + y) rounded once, ``a`` taken at float32: the fused
    multiply-add XLA emits (float64 holds the float32 product exactly; the
    sum's rounding to float64 first differs from one rounding only at
    rare ties)."""
    a32 = float(np.float32(a))
    return (x.to(torch.float64) * a32 + y.to(torch.float64)).to(
        torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (PyTorch's vectorized CPU
    ``sqrt`` can be an ulp off; the float64 root rounds to the float32
    one)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def adamw_update(grads, state: AdamWState, params,
                 cfg: AdamWConfig) -> Tuple[Any, AdamWState]:
    """One AdamW step. Returns ``(new params, new state)``; the inputs are
    left as they are."""
    count = state.count + 1
    b1c, b2c = bias_corrections(count, cfg)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(T.leaves(grads), T.leaves(state.mu),
                          T.leaves(state.nu), T.leaves(params)):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        c1, c2 = (torch.tensor(c, dtype=torch.float32, device=p.device)
                  for c in (b1c, b2c))
        m = _fma(cfg.b1, m, (1 - cfg.b1) * g32)
        v = _fma(cfg.b2, v, (1 - cfg.b2) * torch.square(g32))
        step = m / (c1 * (_sqrt(v / c2) + cfg.eps))
        step = _fma(cfg.weight_decay, p32, step)
        new_p.append(_fma(-cfg.lr, step, p32).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (T.unflatten(params, new_p),
            AdamWState(T.unflatten(params, new_m),
                       T.unflatten(params, new_v), count))


def sgd_update(grads, params, lr: float):
    """``p - lr·g`` in float32 (one fused multiply-add, as XLA emits it),
    written back in the parameter's dtype."""
    return T.tree_map(lambda p, g: _fma(-lr, g.to(torch.float32),
                                        p.to(torch.float32)).to(p.dtype),
                      params, grads)
