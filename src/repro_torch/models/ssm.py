"""Mamba2 (SSD) block: a chunked parallel scan for training and prefill, an
O(1)-state recurrent step for decode (the port of ``repro.models.ssm``).

The input projection emits (z gate, x, B, C, dt); (x, B, C) pass through a
short causal depthwise conv; the recurrence has a per-head scalar decay
``alpha_t = exp(-exp(A_log) * dt_t)``. A multi-token forward computes it in
chunks of ``CHUNK`` = 256 (an intra-chunk contraction over a (B, cs, cs, H)
decay tensor plus a carried (B, H, P, N) state); a one-token step with a
cache runs the recurrence itself. A serving chunk shorter than 256 tokens
is padded to 256, as in the JAX package (four times the SSD work of a
64-token chunk).

Two layouts: consensus training takes ``x (W, B, S, D)`` with a leading
worker axis on every parameter; serving takes ``x (B, S, D)``, one model's
parameters and optionally a decode cache (:func:`mamba2_cache`), whose
state and conv tail it **writes back in place**.

Where the JAX package's rounding is unusual, the port follows it:

* ``_causal_conv`` accumulates in x's dtype (bf16 in serving), one
  rounding per tap; ``F.conv1d`` would sum in float32 and round once;
* the inner RMSNorm of ``mamba2_apply`` takes the default eps 1e-6, not
  ``cfg.norm_eps``;

and where it is wrong, the port departs from it: ``_ssd_chunked`` of the
JAX package multiplies ``exp(seg)`` by the causal mask after the exp. Where
j > i, seg >= 0 is the decay summed between the two steps, and over a
256-token chunk it overflows float32's exp (past 88.7) as soon as the
mean dt passes ~0.35: at the initial ``dt_bias`` (-2) alone dt is
softplus(-2) = 0.127, but zamba2-7b's random ``in_proj`` adds a unit
normal to it, and with the mask after the exp a 300-token lockstep
prefill at full width gives inf * 0 = NaN logits (ROADMAP C19). The port masks
before the exp (``exp(-inf) = 0``): the same values wherever the JAX
package's are finite, finite where they are not. A paged prefill chunk of
64 tokens padded to 256 (the padding's log-decay is 0) stays finite in
both.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

CHUNK = 256


def dims(cfg) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def mamba2_init(gen, cfg, device):
    d_inner, nheads, n = dims(cfg)
    conv_ch = d_inner + 2 * n

    def const(value):
        return torch.full((nheads,), value, dtype=torch.float32,
                          device=device)

    return {
        "in_proj": layers.dense_init(gen, cfg.d_model,
                                     2 * d_inner + 2 * n + nheads, device),
        "conv": {"w": layers.normal(gen, (cfg.ssm_conv, conv_ch), device)
                 / cfg.ssm_conv},
        "a_log": const(0.0),                 # exp() = 1.0
        "d_skip": const(1.0),
        "dt_bias": const(-2.0),              # small initial dt
        "norm": layers.rmsnorm_init(d_inner, device),
        "out_proj": layers.dense_init(gen, d_inner, cfg.d_model, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor]):
    """Depthwise causal conv. x (..., S, C); w (K, C), or (W, K, C) under a
    worker axis (x (W, B, S, C)); tail (..., K-1, C) or None. Returns
    (y (..., S, C), new_tail (..., K-1, C)), each tap rounded to x's
    dtype."""
    k, s = w.shape[-2], x.shape[-2]
    if tail is None:
        tail = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    full = torch.cat([tail.to(x.dtype), x], dim=-2)       # (..., S+K-1, C)
    y = torch.zeros_like(x)
    for j in range(k):
        wj = layers._per_worker(w[..., j, :], x.dim())
        y = y + full[..., j:j + s, :] * wj
    new_tail = full[..., s:, :] if k > 1 else tail
    return y, new_tail


def _ssd_chunked(xbar, log_alpha, b_mat, c_mat, init_state, chunk: int):
    """Chunked SSD scan. xbar (B, S, H, P) inputs scaled by dt; log_alpha
    (B, S, H) <= 0 float32; b_mat, c_mat (B, S, N); init_state (B, H, P, N).
    Returns (y (B, S, H, P) in xbar's dtype, final state float32)."""
    bsz, s, h, p = xbar.shape
    pad = (-s) % chunk
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        log_alpha = F.pad(log_alpha, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = xbar.shape[1] // chunk
    idx = torch.arange(chunk, device=xbar.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    state = init_state.to(torch.float32)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, la, bm, cm = xbar[:, sl], log_alpha[:, sl], b_mat[:, sl], \
            c_mat[:, sl]
        la_cum = torch.cumsum(la, dim=1)                      # inclusive
        # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(la_i - la_j) xbar_j
        seg = la_cum[:, :, None, :] - la_cum[:, None, :, :]   # (B,i,j,H)
        # masked before the exp, not after it (ROADMAP C19)
        w = torch.exp(seg.masked_fill(~causal, float("-inf")))
        scores = torch.einsum("bin,bjn->bij", cm, bm)
        y_intra = torch.einsum(
            "bijh,bjhp->bihp",
            scores.to(torch.float32)[..., None] * w.to(torch.float32),
            xb.to(torch.float32))
        # inter-chunk: y_i += exp(la_i) * C_i . state
        y_inter = torch.einsum("bin,bhpn->bihp", cm.to(torch.float32),
                               state) * torch.exp(la_cum)[..., None]
        # state' = exp(la_tot) state + sum_j exp(la_tot - la_j) B_j xbar_j
        la_tot = la_cum[:, -1, :]                             # (B,H)
        decay_to_end = torch.exp(la_tot[:, None, :] - la_cum)  # (B,cs,H)
        state_inc = torch.einsum(
            "bjn,bjhp->bhpn", bm.to(torch.float32),
            (xb * decay_to_end[..., None]).to(torch.float32))
        state = state * torch.exp(la_tot)[:, :, None, None] + state_inc
        ys.append((y_intra + y_inter).to(xbar.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :s], state


def mamba2_apply(params, cfg, x: torch.Tensor,
                 cache: Optional[dict] = None,
                 chunk: int = CHUNK) -> torch.Tensor:
    """x (W, B, S, D) -> (W, B, S, D) (training), or x (B, S, D) ->
    (B, S, D) (serving). ``cache`` {"state": (B, H, P, N) float32, "conv":
    (B, K-1, C)} (serving only) is the incoming state, and the new state
    and conv tail are written into it. One token with a cache runs the
    recurrent step; anything else the chunked scan."""
    d_inner, nheads, n = dims(cfg)
    p = cfg.ssm_head_dim
    if x.dim() == 4 and cache is not None:
        raise ValueError("mamba2_apply: the training layout has no cache")
    lead, s = x.shape[:-2], x.shape[-2]
    nb = math.prod(lead)

    zxbcdt = layers.dense(params["in_proj"], x)
    z, xc, bmat, cmat, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, nheads], dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_out, new_tail = _causal_conv(
        conv_in, params["conv"]["w"].to(x.dtype),
        None if cache is None else cache["conv"])
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xc.reshape(lead + (s, nheads, p))

    dt32 = dt.to(torch.float32) + layers._per_worker(params["dt_bias"],
                                                     dt.dim())
    dt = torch.logaddexp(dt32, torch.zeros_like(dt32))       # softplus
    log_alpha = -layers._per_worker(torch.exp(params["a_log"]),
                                    dt.dim()) * dt
    xbar = xh * dt[..., None].to(x.dtype)

    init_state = (cache["state"] if cache is not None else
                  torch.zeros((nb, nheads, p, n), dtype=torch.float32,
                              device=x.device))
    if s == 1 and cache is not None:
        # pure recurrent decode step
        alpha = torch.exp(log_alpha[:, 0, :])                     # (B,H)
        inc = torch.einsum("bn,bhp->bhpn", bmat[:, 0].to(torch.float32),
                           xbar[:, 0].to(torch.float32))
        state = init_state * alpha[:, :, None, None] + inc
        y = torch.einsum("bhpn,bn->bhp", state,
                         cmat[:, 0].to(torch.float32))[:, None]
        final_state = state
        y = y.to(x.dtype)
    else:
        y, final_state = _ssd_chunked(
            xbar.reshape(nb, s, nheads, p), log_alpha.reshape(nb, s, nheads),
            bmat.reshape(nb, s, n), cmat.reshape(nb, s, n), init_state,
            chunk)
        y = y.reshape(lead + (s, nheads, p))
    d_skip = layers._per_worker(params["d_skip"], x.dim())[..., None]
    y = y + d_skip.to(x.dtype) * xh
    y = y.reshape(lead + (s, d_inner))
    y = layers.rmsnorm(params["norm"], y * F.silu(z))      # eps 1e-6
    out = layers.dense(params["out_proj"], y)
    if cache is not None:
        cache["state"].copy_(final_state)
        cache["conv"].copy_(new_tail)
    return out


def mamba2_cache(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """A fresh Mamba2 decode state: the SSD state (B, H, P, N) float32 and
    the conv tail (B, K-1, C) in the cache dtype, both zero."""
    d_inner, nheads, n = dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "state": torch.zeros((batch, nheads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }
