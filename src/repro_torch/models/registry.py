"""Model assembly, forward pass, loss and decode caches (the port of
``repro.models.registry`` for the ported block kinds).

A config's layer stack is its ``block_unit`` repeated. As in the JAX
package, the parameters of all full unit repetitions are **stacked**: one
leaf per unit position with a leading depth axis (``(6, ...)`` for
xlstm-125m), looped over in :func:`_run_stack`; leftover layers sit under
``stack.rem``. The tree therefore has the JAX package's leaves, shapes,
keystr paths and packed offsets (19 leaves, 134,277,912 parameters for
xlstm-125m).

Training (:func:`lm_loss`) takes the worker-stacked tree (leading worker
axis W on every leaf) and a batch of ``tokens`` / ``labels`` shaped
``(W, B, S)``, and returns one loss per worker. Serving takes the tree of
one model as :func:`init_params` makes it, tokens ``(B, S)`` at absolute
``positions`` and a decode cache (:func:`init_cache`, or the paged one of
``serving.paging``), which the blocks write in place: K/V for attention,
the recurrent state (stacked on the depth axis like the parameters) for
mLSTM and sLSTM.
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
    the ``meta`` device only shapes are made."""
    unit, n_full, rem = segments(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device),
    }
    stack: Dict[str, Any] = {"units": {}, "rem": {}}
    if n_full > 0:
        for i, kind in enumerate(unit):
            reps = [blocks.init(kind, gen, cfg, device)
                    for _ in range(n_full)]
            stack["units"][f"p{i}"] = T.tree_map(
                lambda *xs: torch.stack(xs), *reps)
    for i, kind in enumerate(rem):
        stack["rem"][f"p{i}"] = blocks.init(kind, gen, cfg, device)
    params["stack"] = stack
    return params


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cpu") -> Dict[str, Any]:
    """Contiguous decode caches in the parameter tree's structure: a
    leading depth axis on the unit positions, one cache per leftover
    layer."""
    unit, n_full, rem = segments(cfg)
    caches: Dict[str, Any] = {"units": {}, "rem": {}}
    if n_full > 0:
        for i, kind in enumerate(unit):
            caches["units"][f"p{i}"] = T.tree_map(
                lambda *xs: torch.stack(xs),
                *[blocks.make_cache(kind, cfg, batch, cache_len, dtype,
                                    device) for _ in range(n_full)])
    for i, kind in enumerate(rem):
        caches["rem"][f"p{i}"] = blocks.make_cache(kind, cfg, batch,
                                                   cache_len, dtype, device)
    return caches


def _run_stack(params, cfg, x: torch.Tensor, positions=None,
               caches=None) -> torch.Tensor:
    unit, n_full, rem = segments(cfg)
    stack = params["stack"]
    # depth is axis 1 under a worker axis (training), axis 0 without
    # (serving); caches never have a worker axis
    depth_axis = 1 if params["embed"]["table"].dim() == 3 else 0

    def ctx(cache):
        return (None if positions is None and cache is None
                else blocks.BlockCtx(positions=positions, cache=cache))

    for r in range(n_full):
        for i, kind in enumerate(unit):
            p = T.tree_map(lambda t, r=r: t.select(depth_axis, r),
                           stack["units"][f"p{i}"])
            c = (None if caches is None else
                 T.tree_map(lambda t, r=r: t[r], caches["units"][f"p{i}"]))
            x = blocks.apply(kind, p, cfg, x, ctx(c))
    for i, kind in enumerate(rem):
        c = None if caches is None else caches["rem"][f"p{i}"]
        x = blocks.apply(kind, stack["rem"][f"p{i}"], cfg, x, ctx(c))
    return x


def apply_model(params, cfg, batch: Dict[str, torch.Tensor], *,
                caches=None) -> torch.Tensor:
    """Forward pass: tokens (W, B, S) -> logits (W, B, S, V) for training,
    or tokens (B, S) -> logits (B, S, V) for serving, in the activation
    dtype (``cfg.dtype``). ``batch["positions"]`` (B, S) defaults to
    0..S-1; ``caches`` are written in place."""
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None and "attn" in cfg.block_kinds:
        b, s = tokens.shape[-2:]
        positions = torch.broadcast_to(
            torch.arange(s, device=tokens.device)[None], (b, s))
    x = layers.embed(params["embed"], tokens).to(act)
    x = _run_stack(params, cfg, x, positions, caches)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["embed"], x)


def decode_step(params, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                caches) -> Tuple[torch.Tensor, Any]:
    """One serving step: tokens (B, S) appended at ``positions`` (B, S)
    (-1 = padding or an inactive slot, whose writes are dropped). Returns
    ``(logits (B, S, V), caches)``; the caches are updated in place."""
    logits = apply_model(params, cfg, {"tokens": tokens,
                                       "positions": positions},
                         caches=caches)
    return logits, caches


def build_positions(cfg, positions) -> torch.Tensor:
    """Serving positions for this architecture: (B, S) int32 absolute
    positions (-1 = padding / inactive). The ported architectures use
    scalar RoPE, so this is the array itself (the JAX package broadcasts
    it to three planes for M-RoPE, not ported)."""
    return torch.as_tensor(positions, dtype=torch.int32)


def lm_loss(params, cfg, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy per worker, (W,), over the labels >= 0."""
    logits = apply_model(params, cfg, batch).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1,
                               torch.clamp_min(labels, 0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    dims = tuple(range(1, labels.dim()))
    ce = (torch.sum((logz - label_logit) * mask, dim=dims)
          / torch.clamp_min(torch.sum(mask, dim=dims), 1.0))
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "aux": aux}


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


def count_params(cfg) -> int:
    return int(sum(np.prod(x.shape) for x in
                   T.leaves(_param_tree_shapes(cfg))))
