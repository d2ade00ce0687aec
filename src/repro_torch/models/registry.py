"""Model assembly, forward pass, loss and decode caches (the port of
``repro.models.registry`` for the ported block kinds).

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


def init_params(cfg, gen: Optional[torch.Generator] = None,
                device="cpu") -> Dict[str, Any]:
    """One model's parameters drawn from ``gen`` with the JAX package's
    distributions and scales (not its bits: ``jax.random`` is another
    generator, so parity tests carry weights across with ``interop``). On
    the ``meta`` device only shapes are made. A weight-shared block
    ("shared_attn", zamba2) is stored once, under ``stack.shared``, and
    has no entry in ``units`` or ``rem``."""
    unit, n_full, rem = segments(cfg)
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
            reps = [blocks.init(kind, gen, cfg, device)
                    for _ in range(n_full)]
            stack["units"][f"p{i}"] = T.tree_map(
                lambda *xs: torch.stack(xs), *reps)
    for i, kind in enumerate(rem):
        if kind == "shared_attn":
            continue
        stack["rem"][f"p{i}"] = blocks.init(kind, gen, cfg, device)
    params["stack"] = stack
    return params


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cpu", window_override: Optional[int] = None
               ) -> Dict[str, Any]:
    """Contiguous decode caches in the parameter tree's structure: a
    leading depth axis on the unit positions, one cache per leftover
    layer (windowed layers hold a ring of ``min(cache_len, window)``
    slots)."""
    unit, n_full, rem = segments(cfg)
    caches: Dict[str, Any] = {"units": {}, "rem": {}}

    def one(kind):
        return blocks.make_cache(kind, cfg, batch, cache_len, dtype, device,
                                 window_override=window_override)

    if n_full > 0:
        for i, kind in enumerate(unit):
            caches["units"][f"p{i}"] = T.tree_map(
                lambda *xs: torch.stack(xs),
                *[one(kind) for _ in range(n_full)])
    for i, kind in enumerate(rem):
        caches["rem"][f"p{i}"] = one(kind)
    return caches


def _run_stack(params, cfg, x: torch.Tensor, positions=None,
               caches=None, window_override=None):
    """The block stack over x: ``(x, aux)``, aux the blocks' side losses
    summed (a float32 tensor, (W,) under a worker axis, where the stack
    has "moe" blocks; the Python float 0.0 where it has none).
    "shared_attn" takes ``stack.shared`` at every occurrence (no depth
    axis: one set of weights); its caches are per occurrence."""
    unit, n_full, rem = segments(cfg)
    stack = params["stack"]
    shared = stack.get("shared")
    # depth is axis 1 under a worker axis (training), axis 0 without
    # (serving); caches never have a worker axis
    depth_axis = 1 if params["embed"]["table"].dim() == 3 else 0
    aux = 0.0

    def ctx(cache):
        return (None if positions is None and cache is None
                else blocks.BlockCtx(positions=positions, cache=cache,
                                     window_override=window_override))

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


def _forward(params, cfg, batch: Dict[str, torch.Tensor], caches=None,
             window_override: Optional[int] = None):
    """:func:`apply_model` with the stack's summed aux: ``(logits, aux)``."""
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None and set(blocks.ATTN_KINDS) & set(cfg.block_kinds):
        b, s = tokens.shape[-2:]
        positions = torch.broadcast_to(
            torch.arange(s, device=tokens.device)[None], (b, s))
    x = layers.embed(params["embed"], tokens).to(act)
    x, aux = _run_stack(params, cfg, x, positions, caches, window_override)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["embed"], x), aux


def apply_model(params, cfg, batch: Dict[str, torch.Tensor], *,
                caches=None, window_override: Optional[int] = None
                ) -> torch.Tensor:
    """Forward pass: tokens (W, B, S) -> logits (W, B, S, V) for training,
    or tokens (B, S) -> logits (B, S, V) for serving, in the activation
    dtype (``cfg.dtype``). ``batch["positions"]`` (B, S) defaults to
    0..S-1; ``caches`` are written in place."""
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


def build_positions(cfg, positions) -> torch.Tensor:
    """Serving positions for this architecture: (B, S) int32 absolute
    positions (-1 = padding / inactive). The ported architectures use
    scalar RoPE, so this is the array itself (the JAX package broadcasts
    it to three planes for M-RoPE, not ported)."""
    return torch.as_tensor(positions, dtype=torch.int32)


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
