"""Block interface of the ported models (the port of
``repro.models.blocks``):

    init(kind, gen, cfg, device)              -> one block's parameters
    apply(kind, params, cfg, x, ctx=None)     -> (x_new, aux)
    make_cache(kind, cfg, batch, cache_len)   -> the block's decode cache

x is (W, B, S, D) in consensus training and (B, S, D) in serving (every
kind); ``ctx`` carries the positions ((B, S), or (B, S, 3) for M-RoPE), the
cache, which the block writes in place, whether self-attention is causal,
the encoder output a cross-attention block attends to, and
``window_override`` (a window for every attention layer, the JAX package's
long-context variant). "swa" is "attn" with the config's
``sliding_window`` as its attention window; its contiguous cache is a ring
of ``min(cache_len, window)`` slots. A cached sLSTM forward (serving)
takes the fused cell, ``use_kernel=True``, as the JAX package's kernel
route; training keeps the autograd time loop. "moe" is attention followed
by the mixture-of-experts MLP (``models/moe.py``), "mamba2" the SSD block
(``models/ssm.py``), and "shared_attn" an "attn" block whose one set of
weights the registry hands to every occurrence (zamba2). "xattn" is
whisper's decoder block: causal self-attention (cached under
``cache["self"]``), cross-attention to the encoder output (its K/V
projected from ``ctx.cross_kv`` in training and prefill, read from
``cache["cross_k"/"cross_v"]`` when cached) and a gelu MLP. ``aux`` is the
block's side loss: the router's load-balance term for "moe" (per worker
under a worker axis), 0.0 for every other kind. Residual connections and
pre-norms live here. An unknown kind raises ``ValueError``, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import layers, moe, ssm, xlstm

PORTED_KINDS = ("mlstm", "slstm", "attn", "swa", "moe", "mamba2",
                "shared_attn", "xattn")
# the self-attention kinds whose cache is one K/V pool (contiguous or paged)
ATTN_KINDS = ("attn", "swa", "moe", "shared_attn")


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    positions: Optional[torch.Tensor]      # (B, S) or (B, S, 3) positions
    cache: Optional[dict] = None
    window_override: Optional[int] = None  # long-context SWA variant
    causal: bool = True
    cross_kv: Optional[torch.Tensor] = None  # encoder output, (B, S_enc, D)


def _attn_dims(cfg) -> layers.AttnDims:
    return layers.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim)


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind {kind!r}")


def init(kind: str, gen, cfg, device):
    if kind in ATTN_KINDS:
        p = {"ln1": layers.rmsnorm_init(cfg.d_model, device),
             "attn": layers.attention_init(gen, _attn_dims(cfg), device),
             "ln2": layers.rmsnorm_init(cfg.d_model, device)}
        if kind == "moe":
            p["moe"] = moe.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.num_experts, device)
        else:
            p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, device)
        return p
    if kind == "xattn":                    # decoder block with cross-attn
        return {"ln1": layers.rmsnorm_init(cfg.d_model, device),
                "attn": layers.attention_init(gen, _attn_dims(cfg), device),
                "lnx": layers.rmsnorm_init(cfg.d_model, device),
                "xattn": layers.attention_init(gen, _attn_dims(cfg), device),
                "ln2": layers.rmsnorm_init(cfg.d_model, device),
                "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, device)}
    if kind == "mamba2":
        return {"ln": layers.rmsnorm_init(cfg.d_model, device),
                "mamba": ssm.mamba2_init(gen, cfg, device)}
    if kind == "mlstm":
        return {"ln": layers.rmsnorm_init(cfg.d_model, device),
                "cell": xlstm.mlstm_init(gen, cfg, device)}
    if kind == "slstm":
        d_ff = int(4 * cfg.d_model / 3)
        return {"ln": layers.rmsnorm_init(cfg.d_model, device),
                "cell": xlstm.slstm_init(gen, cfg, device),
                "ln2": layers.rmsnorm_init(cfg.d_model, device),
                "mlp": layers.mlp_init(gen, cfg.d_model, d_ff, device)}
    raise _unknown(kind)


def _window_for(kind: str, cfg, ctx: Optional[BlockCtx]) -> Optional[int]:
    if ctx is not None and ctx.window_override is not None:
        return ctx.window_override
    if kind == "swa":
        return cfg.sliding_window
    return None


def apply(kind: str, params, cfg, x: torch.Tensor,
          ctx: Optional[BlockCtx] = None):
    """One block: ``(x_new, aux)``. aux is the router's float32 aux loss
    for "moe" (a scalar, or (W,) under a worker axis) and the Python float
    0.0 for every other kind, so that a stack without experts adds no
    device work for it."""
    zero = 0.0
    use_rope = cfg.pos_embedding == "rope"
    if kind in ATTN_KINDS:
        h, _ = layers.attention_apply(
            params["attn"], _attn_dims(cfg),
            layers.rmsnorm(params["ln1"], x, cfg.norm_eps), ctx.positions,
            causal=ctx.causal, window=_window_for(kind, cfg, ctx),
            rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections if use_rope else None,
            use_rope=use_rope, cache=ctx.cache)
        x = x + h
        xn = layers.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            y, aux = moe.moe_apply(
                params["moe"], xn, num_experts=cfg.num_experts,
                experts_per_token=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor)
            return x + y, aux
        return x + layers.mlp_apply(params["mlp"], xn), zero
    if kind == "xattn":
        return _xattn_apply(params, cfg, x, ctx, use_rope), zero
    cache = None if ctx is None else ctx.cache
    if kind == "mamba2":
        h = ssm.mamba2_apply(params["mamba"], cfg,
                             layers.rmsnorm(params["ln"], x, cfg.norm_eps),
                             cache=cache)
        return x + h, zero
    if kind == "mlstm":
        h = xlstm.mlstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps),
                              cache=cache)
        return x + h, zero
    if kind == "slstm":
        h = xlstm.slstm_apply(params["cell"], cfg,
                              layers.rmsnorm(params["ln"], x, cfg.norm_eps),
                              cache=cache, use_kernel=cache is not None)
        x = x + h
        y = layers.mlp_apply(params["mlp"],
                             layers.rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x + y, zero
    raise _unknown(kind)


def _xattn_apply(params, cfg, x: torch.Tensor, ctx: BlockCtx,
                 use_rope: bool) -> torch.Tensor:
    """Whisper's decoder block: causal self-attention, cross-attention to
    the encoder output, a gelu MLP, each pre-normed with a residual."""
    dims = _attn_dims(cfg)
    cache = ctx.cache
    h, _ = layers.attention_apply(
        params["attn"], dims, layers.rmsnorm(params["ln1"], x, cfg.norm_eps),
        ctx.positions, causal=True, use_rope=use_rope,
        cache=None if cache is None else cache["self"])
    x = x + h
    if cache is not None and "cross_k" in cache:
        cross_kv = (cache["cross_k"], cache["cross_v"])
    else:
        enc = ctx.cross_kv                  # raw encoder output
        shape = enc.shape[:-1] + (dims.num_kv_heads, dims.head_dim)
        cross_kv = (layers.dense(params["xattn"]["k"], enc).reshape(shape),
                    layers.dense(params["xattn"]["v"], enc).reshape(shape))
    h, _ = layers.attention_apply(
        params["xattn"], dims, layers.rmsnorm(params["lnx"], x, cfg.norm_eps),
        ctx.positions, kv_override=cross_kv)
    x = x + h
    return x + layers.mlp_apply(
        params["mlp"], layers.rmsnorm(params["ln2"], x, cfg.norm_eps),
        activation="gelu")


def make_cache(kind: str, cfg, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu",
               window_override: Optional[int] = None):
    """Decode cache of one block: a contiguous K/V ring for the attention
    kinds, of ``min(cache_len, window)`` slots where the layer has a window
    (``window_override``, else the config's for "swa"), a K/V cache of
    ``cache_len`` slots under "self" for "xattn" (the registry adds the
    cross K/V; the JAX package's decoder takes no window either), the float32
    recurrent state (fresh, m at -1e30) for the xLSTM kinds and the SSD
    state and conv tail (in ``dtype``) for "mamba2", whose size does not
    grow with ``cache_len``."""
    if kind in ATTN_KINDS:
        window = window_override if window_override is not None else (
            cfg.sliding_window if kind == "swa" else None)
        eff = min(cache_len, window) if window else cache_len
        return layers.init_kv_cache(batch, eff, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, dtype, device)
    if kind == "xattn":
        return {"self": layers.init_kv_cache(batch, cache_len,
                                             cfg.num_kv_heads,
                                             cfg.resolved_head_dim, dtype,
                                             device)}
    if kind == "mamba2":
        return ssm.mamba2_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.slstm_cache(cfg, batch, device)
    raise _unknown(kind)
