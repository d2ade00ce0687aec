"""Shared layers of the ported models: dense projection, RMSNorm, tied
embedding / unembedding and the gated MLP (the port of the corresponding
parts of ``repro.models.layers``; attention is not on the ported path).

Functional style over nested dicts of tensors. Every parameter leaf
carries a leading **worker axis** W (the consensus engine trains W models
side by side), activations are ``(W, B, S, ...)``, and each layer contracts
each worker's activations with that worker's weights: the JAX package's
``vmap`` over workers, written out as batched matrix products. Weights are
float32 and cast to the activation dtype at use, as in the JAX package.

``*_init`` functions build ONE model's parameters (no worker axis) from a
``torch.Generator``; on the ``meta`` device they allocate nothing (shapes
only, for bucket names and parameter counts).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal float32 draws (shape only on the meta device)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------- basics --
def dense_init(gen, in_dim: int, out_dim: int, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": normal(gen, (in_dim, out_dim), device) * scale}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """x (W, ..., d) @ w (W, d, f) -> (W, ..., f) in x's dtype."""
    w = params["w"]
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    out = torch.matmul(flat, w.to(x.dtype))
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def rmsnorm_init(dim: int, device):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def _per_worker(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """(W, ...) parameter -> broadcastable against a (W, ..., last) tensor
    of ``ndim`` dims."""
    return p.reshape((p.shape[0],) + (1,) * (ndim - p.dim()) + p.shape[1:])


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * _per_worker(params["scale"], x.dim())).to(x.dtype)


def embed_init(gen, vocab: int, dim: int, device):
    return {"table": normal(gen, (vocab, dim), device) * 0.02}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (W, B, S) -> (W, B, S, D) rows of each worker's table."""
    table = params["table"]
    w = torch.arange(table.shape[0], device=tokens.device)
    return table[w.reshape((-1,) + (1,) * (tokens.dim() - 1)), tokens.long()]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T, (W, B, S, V)."""
    table = params["table"].to(x.dtype)
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    out = torch.matmul(flat, table.transpose(1, 2))
    return out.reshape(x.shape[:-1] + (table.shape[1],))


# -------------------------------------------------------------------- MLP --
def mlp_init(gen, d_model: int, d_ff: int, device):
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, device),
        "wi_up": dense_init(gen, d_model, d_ff, device),
        "wo": dense_init(gen, d_ff, d_model, device,
                         scale=1.0 / math.sqrt(d_ff)),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    gate = dense(params["wi_gate"], x)
    up = dense(params["wi_up"], x)
    return dense(params["wo"], F.silu(gate) * up)
