"""Model assembly, forward pass, loss and decode caches (the port of
``repro.models.registry``, every block kind).

Two architectures take stub inputs beside the tokens (``data.lm.model_batch``
makes them). qwen2-vl-7b: M-RoPE positions ``(B, S, 3)``
(:func:`build_positions` makes them for serving) and ``vision_embeds``
``(B, V, D)``, which replace the first V token embeddings. whisper-small,
the encoder-decoder: ``frames`` ``(B, S_enc, D)``, which :func:`_encode`
runs through ``encoder_layers`` non-causal "attn" blocks (sinusoidal
positions, no rotary embedding) to the encoder output every decoder
("xattn") block attends to; the decoder adds sinusoidal positions to its
embeddings. Its tree holds the encoder under ``encoder`` and
``enc_final_norm`` and the decoder's "xattn" blocks under
``stack.units.p0``; its decode cache holds, per layer, the self-attention
K/V under ``self`` and the cross K/V that :func:`prefill_cross_cache`
writes once per request. Both take the worker axis in training: the
encoder runs once per worker, on that worker's weights.

``window_override`` (``init_cache``, ``apply_model``, ``lm_loss``,
``lm_loss_tokens``, ``decode_step``) gives every attention layer that
window, as the JAX package's long-context variant does
(``ModelConfig.for_long_context``); "swa" layers otherwise take the
config's ``sliding_window``.

A config's layer stack is its ``block_unit`` repeated. As in the JAX
package, the parameters of all full unit repetitions are **stacked**: one
leaf per unit position with a leading depth axis (``(6, ...)`` for
xlstm-125m), looped over in :func:`_run_stack`; leftover layers sit under
``stack.rem``. A weight-shared block (zamba2's "shared_attn") is stored
once under ``stack.shared`` and handed to every occurrence, so its
gradient sums over them. The tree therefore has the JAX package's leaves,
shapes, keystr paths and packed offsets (19 leaves, 134,277,912
parameters for xlstm-125m; dicts flatten by sorted key, so ``rem`` <
``shared`` < ``units``).

Consensus training (:func:`lm_loss`) takes the worker-stacked tree
(leading worker axis W on every leaf) and a batch of ``tokens`` /
``labels`` shaped ``(W, B, S)``, and returns one loss per worker; the
FSDP-Adam baseline (:func:`lm_loss_tokens`) takes one model and ``(B,
S)`` and returns the JAX package's token-weighted scalar. Both add 0.01
times the routers' load-balance loss summed over the "moe" blocks, as the
JAX package's ``lm_loss`` does. Serving takes
the tree of one model as :func:`init_params` makes it, tokens ``(B, S)``
at absolute ``positions`` and a decode cache (:func:`init_cache`, or the
paged one of ``serving.paging``), which the blocks write in place: K/V
for attention, the recurrent state (stacked on the depth axis like the
parameters) for mLSTM, sLSTM and Mamba2.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.models import blocks, layers


def segments(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    unit = cfg.block_unit
    n_full = cfg.num_layers // len(unit)
    rem = cfg.block_kinds[n_full * len(unit):]
    return unit, n_full, rem


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(...) int positions -> (..., dim) float32 sinusoidal embeddings,
    sines then cosines."""
    half = dim // 2
    scale = torch.tensor(-np.log(10000.0), dtype=torch.float32,
                         device=positions.device)
    freqs = torch.exp(scale * torch.arange(half, dtype=torch.float32,
                                           device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _decoder_segments(cfg):
    """``segments`` of the decoder stack: an encoder-decoder's layers are
    all "xattn" blocks, stacked under ``units.p0``."""
    if cfg.is_encoder_decoder:
        return ("xattn",), cfg.num_layers, ()
    return segments(cfg)


def _stacked(make, n: int):
    return T.tree_map(lambda *xs: torch.stack(xs), *[make() for _ in range(n)])


def init_params(cfg, gen: Optional[torch.Generator] = None,
                device="cpu") -> Dict[str, Any]:
    """One model's parameters drawn from ``gen`` with the JAX package's
    distributions and scales (not its bits: ``jax.random`` is another
    generator, so parity tests carry weights across with ``interop``). On
    the ``meta`` device only shapes are made. A weight-shared block
    ("shared_attn", zamba2) is stored once, under ``stack.shared``, and
    has no entry in ``units`` or ``rem``."""
    unit, n_full, rem = _decoder_segments(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device),
    }
    stack: Dict[str, Any] = {"units": {}, "rem": {}}
    if "shared_attn" in cfg.block_kinds:
        stack["shared"] = blocks.init("shared_attn", gen, cfg, device)
    if n_full > 0:
        for i, kind in enumerate(unit):
            if kind == "shared_attn":
                continue
            stack["units"][f"p{i}"] = _stacked(
                lambda kind=kind: blocks.init(kind, gen, cfg, device), n_full)
    for i, kind in enumerate(rem):
        if kind == "shared_attn":
            continue
        stack["rem"][f"p{i}"] = blocks.init(kind, gen, cfg, device)
    params["stack"] = stack
    if cfg.is_encoder_decoder:
        params["encoder"] = _stacked(
            lambda: blocks.init("attn", gen, cfg, device), cfg.encoder_layers)
        params["enc_final_norm"] = layers.rmsnorm_init(cfg.d_model, device)
    return params


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cpu", window_override: Optional[int] = None
               ) -> Dict[str, Any]:
    """Contiguous decode caches in the parameter tree's structure: a
    leading depth axis on the unit positions, one cache per leftover
    layer (windowed layers hold a ring of ``min(cache_len, window)``
    slots). An encoder-decoder's layers each hold their self-attention
    cache under ``self`` and zeroed ``cross_k`` / ``cross_v`` of
    ``(batch, source_positions, KV, hd)`` for :func:`prefill_cross_cache`
    to fill."""
    unit, n_full, rem = _decoder_segments(cfg)
    caches: Dict[str, Any] = {"units": {}, "rem": {}}

    def one(kind):
        c = blocks.make_cache(kind, cfg, batch, cache_len, dtype, device,
                              window_override=window_override)
        if kind == "xattn":
            shape = (batch, cfg.source_positions, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return c

    if n_full > 0:
        for i, kind in enumerate(unit):
            caches["units"][f"p{i}"] = _stacked(lambda kind=kind: one(kind),
                                                n_full)
    for i, kind in enumerate(rem):
        caches["rem"][f"p{i}"] = one(kind)
    return caches


def _depth_axis(params) -> int:
    """Depth is axis 1 of a stacked leaf under a worker axis (training),
    axis 0 without (serving); caches never have a worker axis."""
    return 1 if params["embed"]["table"].dim() == 3 else 0


def _run_stack(params, cfg, x: torch.Tensor, positions=None,
               caches=None, window_override=None, cross_kv=None):
    """The block stack over x: ``(x, aux)``, aux the blocks' side losses
    summed (a float32 tensor, (W,) under a worker axis, where the stack
    has "moe" blocks; the Python float 0.0 where it has none).
    "shared_attn" takes ``stack.shared`` at every occurrence (no depth
    axis: one set of weights); its caches are per occurrence. ``cross_kv``
    is the encoder output the "xattn" blocks attend to (None where they
    read cached cross K/V)."""
    unit, n_full, rem = _decoder_segments(cfg)
    stack = params["stack"]
    shared = stack.get("shared")
    depth_axis = _depth_axis(params)
    aux = 0.0

    def ctx(cache):
        return (None if positions is None and cache is None
                else blocks.BlockCtx(positions=positions, cache=cache,
                                     window_override=window_override,
                                     cross_kv=cross_kv))

    for r in range(n_full):
        for i, kind in enumerate(unit):
            p = (shared if kind == "shared_attn" else
                 T.tree_map(lambda t, r=r: t.select(depth_axis, r),
                            stack["units"][f"p{i}"]))
            c = (None if caches is None else
                 T.tree_map(lambda t, r=r: t[r], caches["units"][f"p{i}"]))
            x, a = blocks.apply(kind, p, cfg, x, ctx(c))
            aux = aux + a
    for i, kind in enumerate(rem):
        p = shared if kind == "shared_attn" else stack["rem"][f"p{i}"]
        c = None if caches is None else caches["rem"][f"p{i}"]
        x, a = blocks.apply(kind, p, cfg, x, ctx(c))
        aux = aux + a
    return x, aux


def activation_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, S_enc, D), or
    (W, B, S_enc, D) with each worker's own weights: sinusoidal positions
    added, ``encoder_layers`` non-causal "attn" blocks (no rotary
    embedding: the positions are sinusoidal), then ``enc_final_norm``."""
    b, s_enc = frames.shape[-3:-1]
    pos = torch.broadcast_to(
        torch.arange(s_enc, device=frames.device)[None], (b, s_enc))
    x = frames + sinusoidal_positions(pos, cfg.d_model).to(frames.dtype)
    depth_axis = _depth_axis(params)
    ctx = blocks.BlockCtx(positions=pos, causal=False)
    enc = params["encoder"]
    for r in range(cfg.encoder_layers):
        p = T.tree_map(lambda t, r=r: t.select(depth_axis, r), enc)
        x, _ = blocks.apply("attn", p, cfg, x, ctx)
    return layers.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps)


def _forward(params, cfg, batch: Dict[str, torch.Tensor], caches=None,
             window_override: Optional[int] = None):
    """:func:`apply_model` with the stack's summed aux: ``(logits, aux)``."""
    act = activation_dtype(cfg)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None and set(blocks.ATTN_KINDS) & set(cfg.block_kinds):
        b, s = tokens.shape[-2:]
        positions = torch.broadcast_to(
            torch.arange(s, device=tokens.device)[None], (b, s))
    x = layers.embed(params["embed"], tokens).to(act)
    if cfg.vision_tokens and "vision_embeds" in batch:
        # stub layout: the patch embeddings take the first V slots
        v = batch["vision_embeds"].to(act)
        nv, s = v.shape[-2], x.shape[-2]
        x = (torch.cat([v, x[..., nv:, :]], dim=-2) if nv < s
             else v[..., :s, :])
    if cfg.pos_embedding == "sinusoidal":
        pos = positions[..., 0] if positions.dim() > tokens.dim() \
            else positions
        x = x + sinusoidal_positions(pos, cfg.d_model).to(act)
    cross_kv = None
    if cfg.is_encoder_decoder and caches is None:
        cross_kv = _encode(params, cfg, batch["frames"].to(act))
    x, aux = _run_stack(params, cfg, x, positions, caches, window_override,
                        cross_kv)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["embed"], x), aux


def apply_model(params, cfg, batch: Dict[str, torch.Tensor], *,
                caches=None, window_override: Optional[int] = None
                ) -> torch.Tensor:
    """Forward pass: tokens (W, B, S) -> logits (W, B, S, V) for training,
    or tokens (B, S) -> logits (B, S, V) for serving, in the activation
    dtype (``cfg.dtype``). ``batch["positions"]`` (B, S) defaults to
    0..S-1 (M-RoPE takes no default: its (B, S, 3) planes are given);
    ``vision_embeds`` and ``frames`` are the stub inputs of qwen2-vl and
    whisper (the latter read on the uncached path only: a cached decoder
    reads its cross K/V); ``caches`` are written in place."""
    return _forward(params, cfg, batch, caches, window_override)[0]


def decode_step(params, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                caches, *, window_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One serving step: tokens (B, S) appended at ``positions`` (B, S)
    (-1 = padding or an inactive slot, whose writes are dropped). Returns
    ``(logits (B, S, V), caches)``; the caches are updated in place."""
    logits = apply_model(params, cfg, {"tokens": tokens,
                                       "positions": positions},
                         caches=caches, window_override=window_override)
    return logits, caches


def prefill_cross_cache(params, cfg, frames: torch.Tensor, cache):
    """Encoder pass over ``frames`` (B, S_enc, D) and every decoder
    layer's cross K/V projection, written into ``cache``'s ``cross_k`` /
    ``cross_v`` in place (in the cache's dtype); returns the cache. The
    frames enter at the activation dtype, as on :func:`apply_model`'s
    uncached path, so a cached decoder attends to the encoder output the
    uncached forward computes. (The JAX package runs this encoder at the
    frames' own dtype, bf16 from its engine, also under a float32 config:
    ROADMAP C20.)"""
    enc = _encode(params, cfg, frames.to(activation_dtype(cfg)))
    b, s_enc, _ = enc.shape
    shape = (cfg.num_layers, b, s_enc, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    xattn = params["stack"]["units"]["p0"]["xattn"]       # (L, D, F)
    unit = cache["units"]["p0"]
    for name, proj in (("cross_k", "k"), ("cross_v", "v")):
        w = xattn[proj]["w"].to(enc.dtype)[:, None]       # (L, 1, D, F)
        unit[name].copy_(torch.matmul(enc[None], w).reshape(shape))
    return cache


def build_positions(cfg, positions) -> torch.Tensor:
    """Serving positions for this architecture from (B, S) int32 absolute
    positions (-1 = padding / inactive): the array itself for scalar RoPE,
    or, for M-RoPE, the scalar on all three (temporal, height, width)
    planes, (B, S, 3) (the text-only case). The one place serving builds
    positions: the lockstep engine's prefill and decode and the
    scheduler's all call it."""
    positions = torch.as_tensor(positions, dtype=torch.int32)
    if cfg.mrope_sections is not None:
        return positions[..., None].expand(
            tuple(positions.shape) + (3,)).contiguous()
    return positions


AUX_WEIGHT = 0.01      # the router's load-balance term in the loss


def _token_ce(params, cfg, batch, window_override=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token next-token cross entropy and its mask (labels >= 0), in
    the labels' shape, float32, and the stack's aux."""
    logits, aux = _forward(params, cfg, batch,
                           window_override=window_override)
    logits = logits.to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1,
                               torch.clamp_min(labels, 0)[..., None])[..., 0]
    return logz - label_logit, (labels >= 0).to(torch.float32), aux


def lm_loss(params, cfg, batch, *, window_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The JAX package's ``lm_loss`` per worker, (W,), of the
    worker-stacked tree of the consensus engine: each worker's next-token
    cross entropy over the labels >= 0 of its rows plus 0.01 times its
    aux (the router's load-balance loss summed over the blocks; 0 without
    "moe" blocks). Returns ``(loss, {"ce", "aux"})``, each (W,)."""
    ce, mask, aux = _token_ce(params, cfg, batch, window_override)
    dims = tuple(range(1, mask.dim()))
    ce = (torch.sum(ce * mask, dim=dims)
          / torch.clamp_min(torch.sum(mask, dim=dims), 1.0))
    aux = torch.broadcast_to(torch.as_tensor(aux, dtype=torch.float32,
                                             device=ce.device), ce.shape)
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def lm_loss_tokens(params, cfg, batch, *,
                   window_override: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``lm_loss`` of one unstacked model: the cross
    entropy summed over every valid label of the batch over their count,
    plus 0.01 times the aux, a scalar. The mean of per-row means equals
    the cross entropy only when every row has as many valid labels."""
    ce, mask, aux = _token_ce(params, cfg, batch, window_override)
    ce = torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce + AUX_WEIGHT * aux


# ------------------------------------------------------------ accounting --
@functools.lru_cache(maxsize=16)
def _param_tree_shapes(cfg):
    return init_params(cfg, None, device="meta")


def param_bucket_names(cfg) -> Tuple[str, ...]:
    """Canonical block-bucket names present in this architecture's tree,
    the vocabulary of a ``groups="block:..."`` spec."""
    return packing.tree_bucket_names(_param_tree_shapes(cfg))


def param_buckets(cfg) -> Dict[str, Tuple[str, ...]]:
    """Bucket name -> the leaf paths it claims."""
    out: Dict[str, list] = {}
    for path in packing.leaf_paths(_param_tree_shapes(cfg)):
        out.setdefault(packing.bucket_of(path), []).append(path)
    return {k: tuple(v) for k, v in sorted(out.items())}


def count_params(cfg, active_only: bool = False) -> int:
    """Parameters of one model; with ``active_only`` the expert stacks
    count at k/E (those a token runs through), as in the JAX package."""
    total = 0
    for path, leaf in T.to_paths(_param_tree_shapes(cfg)).items():
        n = int(np.prod(leaf.shape))
        if active_only and "'moe'" in path and "'router'" not in path:
            n = int(n * cfg.experts_per_token / max(cfg.num_experts, 1))
        total += n
    return total
