"""Block interface of the ported models (the port of the mLSTM, sLSTM,
full-attention and sliding-window attention parts of
``repro.models.blocks``):

    init(kind, gen, cfg, device)              -> one block's parameters
    apply(kind, params, cfg, x, ctx=None)     -> x_new
    make_cache(kind, cfg, batch, cache_len)   -> the block's decode cache

x is (W, B, S, D) in consensus training and (B, S, D) in serving (every
kind); ``ctx`` carries the positions, the cache, which the block writes in
place, and ``window_override`` (a window for every attention layer, the
JAX package's long-context variant). "swa" is "attn" with the config's
``sliding_window`` as its attention window; its contiguous cache is a ring
of ``min(cache_len, window)`` slots. A cached sLSTM forward (serving)
takes the fused cell, ``use_kernel=True``, as the JAX package's kernel
route; training keeps the autograd time loop. Residual connections and
pre-norms live here.
The other block kinds of the JAX package (MoE, Mamba2, shared and cross
attention) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import layers, xlstm

PORTED_KINDS = ("mlstm", "slstm", "attn", "swa")
ATTN_KINDS = ("attn", "swa")


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    positions: Optional[torch.Tensor]      # (B, S) absolute positions
    cache: Optional[dict] = None
    window_override: Optional[int] = None  # long-context SWA variant


def _attn_dims(cfg) -> layers.AttnDims:
    return layers.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP.md queue A: "
        f"attention models); ported kinds: {PORTED_KINDS}")


def init(kind: str, gen, cfg, device):
    if kind in ATTN_KINDS:
        return {"ln1": layers.rmsnorm_init(cfg.d_model, device),
                "attn": layers.attention_init(gen, _attn_dims(cfg), device),
                "ln2": layers.rmsnorm_init(cfg.d_model, device),
                "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, device)}
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


def _window_for(kind: str, cfg, ctx: Optional[BlockCtx]) -> Optional[int]:
    if ctx is not None and ctx.window_override is not None:
        return ctx.window_override
    if kind == "swa":
        return cfg.sliding_window
    return None


def apply(kind: str, params, cfg, x: torch.Tensor,
          ctx: Optional[BlockCtx] = None) -> torch.Tensor:
    if kind in ATTN_KINDS:
        h, _ = layers.attention_apply(
            params["attn"], _attn_dims(cfg),
            layers.rmsnorm(params["ln1"], x, cfg.norm_eps), ctx.positions,
            window=_window_for(kind, cfg, ctx), rope_theta=cfg.rope_theta,
            use_rope=cfg.pos_embedding == "rope", cache=ctx.cache)
        x = x + h
        y = layers.mlp_apply(params["mlp"],
                             layers.rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x + y
    cache = None if ctx is None else ctx.cache
    if kind == "mlstm":
        h = xlstm.mlstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps),
                              cache=cache)
        return x + h
    if kind == "slstm":
        h = xlstm.slstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps),
                              cache=cache, use_kernel=cache is not None)
        x = x + h
        y = layers.mlp_apply(params["mlp"],
                             layers.rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x + y
    raise _not_ported(kind)


def make_cache(kind: str, cfg, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu",
               window_override: Optional[int] = None):
    """Decode cache of one block: a contiguous K/V ring for the attention
    kinds, of ``min(cache_len, window)`` slots where the layer has a window
    (``window_override``, else the config's for "swa"), the float32
    recurrent state (fresh, m at -1e30) for the xLSTM kinds, whose size
    does not grow with ``cache_len``."""
    if kind in ATTN_KINDS:
        window = window_override if window_override is not None else (
            cfg.sliding_window if kind == "swa" else None)
        eff = min(cache_len, window) if window else cache_len
        return layers.init_kv_cache(batch, eff, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, dtype, device)
    if kind == "mlstm":
        return xlstm.mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.slstm_cache(cfg, batch, device)
    raise _not_ported(kind)
