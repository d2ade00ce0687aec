"""Model assembly, forward pass and loss (the port of
``repro.models.registry`` for training the ported block kinds).

A config's layer stack is its ``block_unit`` repeated. As in the JAX
package, the parameters of all full unit repetitions are **stacked**: one
leaf per unit position with a leading depth axis (``(6, ...)`` for
xlstm-125m), looped over in :func:`_run_stack`; leftover layers sit under
``stack.rem``. The tree therefore has the JAX package's leaves, shapes,
keystr paths and packed offsets (19 leaves, 134,277,912 parameters for
xlstm-125m).

Every function past :func:`init_params` takes the worker-stacked tree
(leading worker axis W on every leaf) and a batch of ``tokens`` /
``labels`` shaped ``(W, B, S)``; :func:`lm_loss` returns one loss per
worker.
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


def _run_stack(params, cfg, x: torch.Tensor) -> torch.Tensor:
    unit, n_full, rem = segments(cfg)
    stack = params["stack"]
    for r in range(n_full):
        for i, kind in enumerate(unit):
            p = T.tree_map(lambda t, r=r: t[:, r], stack["units"][f"p{i}"])
            x = blocks.apply(kind, p, cfg, x)
    for i, kind in enumerate(rem):
        x = blocks.apply(kind, stack["rem"][f"p{i}"], cfg, x)
    return x


def apply_model(params, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Forward pass: tokens (W, B, S) -> logits (W, B, S, V) in the
    activation dtype (``cfg.dtype``)."""
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = layers.embed(params["embed"], batch["tokens"]).to(act)
    x = _run_stack(params, cfg, x)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["embed"], x)


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
