"""Synthetic-but-learnable LM token stream with per-worker shards (a copy
of ``repro.data.lm``: numpy, so both packages draw identical batches).

The stream is a noisy affine recurrence over the vocabulary,

    t_{i+1} = (a * t_i + b) mod V        with prob 1 - eps
              uniform(V)                 otherwise,

which a causal LM can learn. Batches are deterministic in (seed, step,
worker): every worker of a decentralized run draws a disjoint shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    mult: int = 31
    add: int = 17
    noise: float = 0.1
    seed: int = 0


class SyntheticLM:
    """Deterministic synthetic token stream."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        if not (np.gcd(cfg.mult, v) == 1 or v % cfg.mult):
            raise ValueError("mult should not collapse the vocabulary")

    def _seq(self, rng: np.random.Generator, n: int) -> np.ndarray:
        c = self.cfg
        t = np.empty(n + 1, dtype=np.int64)
        t[0] = rng.integers(0, c.vocab_size)
        for i in range(n):
            if rng.uniform() < c.noise:
                t[i + 1] = rng.integers(0, c.vocab_size)
            else:
                t[i + 1] = (t[i] * c.mult + c.add) % c.vocab_size
        return t

    def batch(self, step: int, batch_size: int,
              worker: int = 0) -> Dict[str, np.ndarray]:
        """(batch, seq) tokens + next-token labels, deterministic in
        (seed, step, worker)."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, worker, step]))
        toks = np.empty((batch_size, c.seq_len + 1), dtype=np.int32)
        for b in range(batch_size):
            toks[b] = self._seq(rng, c.seq_len)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def worker_batch(self, step: int, n_workers: int,
                     per_worker: int) -> Dict[str, np.ndarray]:
        """Stacked per-worker batches: leading axis = worker."""
        parts = [self.batch(step, per_worker, worker=w)
                 for w in range(n_workers)]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def model_batch(cfg, data: Dict[str, np.ndarray], device, *, step: int = 0,
                stubs: Optional[Dict[str, Any]] = None
                ) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``, with the stub inputs the
    architecture reads (the backbone is real, the frontend is not):
    M-RoPE positions 0..S-1 on all three planes, ``(..., S, 3)``
    (qwen2-vl); patch embeddings ``vision_embeds`` ``(..., V, D)``
    (qwen2-vl) and audio frame embeddings ``frames`` ``(..., S_enc, D)``
    (whisper), 0.02 times standard normal draws in bf16 from a
    ``torch.Generator`` on ``device`` seeded with ``step`` (the JAX package
    keys them with ``PRNGKey(step)``; threefry's bits are not
    reproducible here). ``stubs`` (name -> tensor) replaces those draws,
    so that parity tests can pass in the JAX package's
    (``interop.tensor_from_numpy``). ``cfg`` None
    converts the arrays only."""
    out = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
           for k, v in data.items()}
    if cfg is None:
        return out
    tokens = out["tokens"]
    lead, s = tuple(tokens.shape[:-1]), tokens.shape[-1]
    if cfg.mrope_sections is not None:
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
        out["positions"] = pos[:, None].expand(
            lead + (s, 3)).contiguous()
    shapes = {}
    if cfg.vision_tokens:
        shapes["vision_embeds"] = lead + (cfg.vision_tokens, cfg.d_model)
    if cfg.is_encoder_decoder:
        shapes["frames"] = lead + (cfg.source_positions, cfg.d_model)
    for name, shape in shapes.items():
        if stubs is not None and name in stubs:
            out[name] = stubs[name].to(tokens.device)
        else:
            gen = torch.Generator(device=tokens.device).manual_seed(step)
            out[name] = 0.02 * torch.randn(shape, generator=gen,
                                           dtype=torch.bfloat16,
                                           device=tokens.device)
        if tuple(out[name].shape) != shape:
            raise ValueError(f"stub {name}: shape {tuple(out[name].shape)},"
                             f" expected {shape}")
    return out

