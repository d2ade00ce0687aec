"""Inputs the benchmark makes from ``--seed`` and hands to the program and
to the reference alike.

Least-squares data follows the synthetic recipe of the paper's linear task
(Chen et al. 2018, "LAG"; the program's ``synth_linear``): Gaussian
features with their scales spread geometrically from 1 to 1/cond over the
columns, a Gaussian ground truth, Gaussian noise on the targets. It is
drawn on the device, in a few large calls from one ``torch.Generator``,
directly in the per-worker layout (rows are i.i.d., so a uniform partition
is a reshape).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# offsets that keep the streams of one seed apart
DATA_STREAM, DRAW_STREAM = 0, 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of one benchmark seed."""
    mixed = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(mixed.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def linreg_data(cfg: dict, seed: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x (N, s, d) and y (N, s), float32, on ``device``."""
    n, s, d = cfg["workers"], cfg["rows_per_worker"], cfg["n_features"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, DATA_STREAM))
    scales = torch.logspace(0.0, -math.log10(cfg["feature_cond"]), d,
                            dtype=torch.float32, device=device)
    x = torch.randn((n, s, d), generator=gen, device=device)
    x.mul_(scales)
    theta_true = torch.randn((d,), generator=gen, device=device)
    noise = torch.randn((n, s), generator=gen, device=device)
    y = torch.einsum("nsd,d->ns", x, theta_true) + cfg["noise"] * noise
    return x, y


def draw_generator(seed: int, device) -> torch.Generator:
    """The generator of the stochastic-rounding uniforms."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, DRAW_STREAM))
    return gen


PARAM_STREAM = 4


def lm_params(arch, model: dict, seed: int, device) -> dict:
    """One model's parameters by path, as the reference model ``arch``
    (a module of ``perfbench/reference/``) lays them out and draws them
    (``arch.layout``, ``arch.init_scales``): every normal leaf from one
    ``torch.randn`` over their total count, scaled leaf by leaf, the
    constants filled."""
    shapes, how = arch.layout(model), arch.init_scales(model)
    normal = [p for p in shapes if how[p][0] == "normal"]
    total = sum(math.prod(shapes[p]) for p in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, PARAM_STREAM))
    flat = torch.randn((total,), generator=gen, device=device)
    out, off = {}, 0
    for p, shape in shapes.items():
        kind, value = how[p]
        if kind == "const":
            out[p] = torch.full(shape, value, device=device)
            continue
        size = math.prod(shape)
        out[p] = flat[off:off + size].view(shape).mul_(value)
        off += size
    return out


def lm_tokens(mix: dict, vocab: int, seed: int, step: int, workers: int,
              per_worker: int, seq: int) -> Tuple[np.ndarray, np.ndarray]:
    """A step's (workers, per_worker, seq) tokens and next-token labels:
    the synthetic stream of the paper's LM extension, a noisy affine
    recurrence t' = (mult t + add) mod V, replaced by a uniform token with
    probability ``noise``; every (seed, step, worker) its own rows."""
    toks = np.empty((workers, per_worker, seq + 1), dtype=np.int64)
    for w in range(workers):
        rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed) % (1 << 64), step, w]))
        t = rng.integers(0, vocab, per_worker)
        toks[w, :, 0] = t
        for i in range(seq):
            fresh = rng.integers(0, vocab, per_worker)
            noisy = rng.uniform(size=per_worker) < mix["token_noise"]
            t = np.where(noisy, fresh, (t * mix["token_mult"]
                                        + mix["token_add"]) % vocab)
            toks[w, :, i + 1] = t
    return toks[..., :-1].astype(np.int32), toks[..., 1:].astype(np.int32)
