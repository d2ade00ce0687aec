"""Mixture-of-Experts MLP with scatter-based token dispatch (the port of
``repro.models.moe``).

Top-k token-choice routing with a static per-expert capacity
``C = max(int(T * k / E * capacity_factor), k)`` over the ``T`` tokens of
one call, computed in Python floats as the JAX package does. The dispatch
follows the JAX code step for step and never builds a ``(T, E, C)``
one-hot:

* router logits in x's dtype, softmax in float32;
* the k largest probabilities, renormalised, cast to x's dtype;
* each assignment's rank within its expert by an exclusive cumulative
  count in ``(T·k)`` order; assignments at rank >= C are dropped;
* an ``(E·C, D)`` buffer filled by ``index_add_`` of the masked rows;
* the gated expert products as batched matmuls (the JAX package computes
  them outside any Pallas kernel too);
* a gather of each assignment's row, weighted by its gate, summed over k.

It also returns the load-balancing auxiliary loss (``E · sum_e
frac_tokens_e · mean_prob_e``) that ``registry.lm_loss`` adds at weight
0.01.

Two layouts, as ``layers.dense``: serving ``x (B, S, D)`` with one model's
weights; consensus training ``x (W, B, S, D)`` with a leading worker axis
on every weight, where each worker routes its own ``T = B·S`` tokens with
its own capacity and gets its own aux (the JAX package's ``vmap`` over
workers): aux is then ``(W,)``.

**Ties.** ``jax.lax.top_k`` returns equal values lowest index first;
``torch.topk`` promises no order among ties, and on the card the order
varies. The order within the k picks decides the ranks (so which tokens
are dropped) and the order of the sum over k, and ties are common where
the router logits are bf16 (64 experts). The picks are therefore the first
k of a stable descending sort, which keeps the lowest index first.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def moe_init(gen, d_model: int, d_ff: int, num_experts: int, device):
    e, d, f = num_experts, d_model, d_ff
    return {
        "router": layers.dense_init(gen, d, e, device),
        "wi_gate": {"w": layers.normal(gen, (e, d, f), device)
                    / math.sqrt(d)},
        "wi_up": {"w": layers.normal(gen, (e, d, f), device)
                  / math.sqrt(d)},
        "wo": {"w": layers.normal(gen, (e, f, d), device) / math.sqrt(f)},
    }


def capacity(tokens: int, num_experts: int, experts_per_token: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call over ``tokens`` tokens, in Python floats
    as the JAX package computes it."""
    k = experts_per_token
    return max(int(tokens * k / num_experts * capacity_factor), k)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of ``probs`` (..., E) and their expert ids,
    ties lowest index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x: torch.Tensor, *, num_experts: int,
              experts_per_token: int, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux scalar), or x (W, B, S, D) with
    per-worker weights -> (out (W, B, S, D), aux (W,)); aux float32."""
    workers = x.dim() == 4
    lead = x.shape[0] if workers else 1
    d = x.shape[-1]
    t = math.prod(x.shape[-3:-1])
    e, k = num_experts, experts_per_token
    cap = capacity(t, e, k, capacity_factor)

    xf = x.reshape(lead, t, d)
    logits = layers.dense(params["router"], x).to(torch.float32).reshape(
        lead, t, e)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(probs, k)                     # (L, T, k)
    gate_vals = (gate_vals / torch.sum(gate_vals, -1, keepdim=True)
                 ).to(x.dtype)

    # ---- load balance aux (Shazeer-style): exact integer counts ---------
    flat_e = expert_idx.reshape(lead, t * k)
    onehot = F.one_hot(flat_e, e).to(torch.int32)               # (L, Tk, E)
    counts = onehot.sum(dim=1).to(torch.float32)
    frac_tokens = counts / t
    mean_probs = torch.mean(probs, dim=1)
    aux = torch.sum(frac_tokens * mean_probs, dim=-1) * e       # (L,)

    # ---- dispatch: rank of each assignment within its expert -----------
    ranks = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.gather(ranks, 2, flat_e[..., None])[..., 0]    # (L, Tk)
    valid = rank < cap
    slot = flat_e * cap + torch.where(valid, rank, 0)
    # one buffer for all L: worker w's slots start at w * E * C
    gslot = (slot + (torch.arange(lead, device=x.device) * e * cap)[:, None]
             ).reshape(-1)
    validx = valid.to(x.dtype)[..., None]
    x_rep = torch.repeat_interleave(xf, k, dim=1)               # (L, Tk, D)
    buf = torch.zeros((lead * e * cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, gslot, (x_rep * validx).reshape(-1, d))
    h = buf.reshape(lead, e, cap, d)

    # ---- expert FFN (gated) -----------------------------------------------
    def expert(name):
        w = params[name]["w"].to(x.dtype)
        return w if workers else w[None]

    gate = torch.matmul(h, expert("wi_gate"))
    up = torch.matmul(h, expert("wi_up"))
    out_e = torch.matmul(F.silu(gate) * up, expert("wo"))       # (L,E,C,D)

    # ---- combine ------------------------------------------------------
    gathered = out_e.reshape(lead * e * cap, d)[gslot].reshape(lead, t * k, d)
    gathered = gathered * (gate_vals.reshape(lead, t * k)[..., None]
                           * validx)
    y = torch.sum(gathered.reshape(lead, t, k, d), dim=2)
    if workers:
        return y.reshape(x.shape), aux
    return y.reshape(x.shape), aux[0]
