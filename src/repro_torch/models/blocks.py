"""Block interface of the ported models (the port of the mLSTM and sLSTM
parts of ``repro.models.blocks``):

    init(kind, gen, cfg, device)   -> one block's parameters
    apply(kind, params, cfg, x)    -> x_new       (x: (W, B, S, D))

Residual connections and pre-norms live here. The other block kinds of the
JAX package (attention, sliding-window attention, MoE, Mamba2, cross
attention) are not ported yet and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, xlstm

PORTED_KINDS = ("mlstm", "slstm")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP.md queue A: "
        f"attention models); ported kinds: {PORTED_KINDS}")


def init(kind: str, gen, cfg, device):
    if kind == "mlstm":
        return {"ln": layers.rmsnorm_init(cfg.d_model, device),
                "cell": xlstm.mlstm_init(gen, cfg, device)}
    if kind == "slstm":
        d_ff = int(4 * cfg.d_model / 3)
        return {"ln": layers.rmsnorm_init(cfg.d_model, device),
                "cell": xlstm.slstm_init(gen, cfg, device),
                "ln2": layers.rmsnorm_init(cfg.d_model, device),
                "mlp": layers.mlp_init(gen, cfg.d_model, d_ff, device)}
    raise _not_ported(kind)


def apply(kind: str, params, cfg, x: torch.Tensor) -> torch.Tensor:
    if kind == "mlstm":
        h = xlstm.mlstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps))
        return x + h
    if kind == "slstm":
        h = xlstm.slstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps))
        x = x + h
        y = layers.mlp_apply(params["mlp"],
                             layers.rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x + y
    raise _not_ported(kind)
