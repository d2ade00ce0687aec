"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), after arXiv:2405.04517 — the port of
``repro.models.xlstm`` for training (no decode cache).

* mLSTM runs in its chunkwise-parallel form (``_mlstm_chunked``), exact and
  max-stabilized, with the JAX package's chunk of 256 and its padding
  constants (``i_pre = -1e30`` and ``f_pre = 30`` past the sequence end).
* sLSTM runs its recurrence as a Python loop over time: the JAX package
  trains it through ``lax.scan`` (its fused Pallas cell is forward-only and
  not on this path; ROADMAP.md B9). Each step is a handful of small
  launches; the recurrent weights stay per worker, so the loop state is
  ``(W, H, B, dh)``.

Parameters carry the leading worker axis W (``models/layers.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

MLSTM_CHUNK = 256


# ------------------------------------------------------------------ mLSTM --
def mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model
    heads = cfg.lstm_heads
    return d_inner, heads, d_inner // heads


def mlstm_init(gen, cfg, device):
    d_inner, heads, _ = mlstm_dims(cfg)
    return {
        "up": layers.dense_init(gen, cfg.d_model, 2 * d_inner, device),
        "q": layers.dense_init(gen, d_inner, d_inner, device),
        "k": layers.dense_init(gen, d_inner, d_inner, device),
        "v": layers.dense_init(gen, d_inner, d_inner, device),
        "igate": layers.dense_init(gen, d_inner, heads, device, scale=0.01),
        "fgate": {"w": layers.normal(gen, (d_inner, heads), device) * 0.01,
                  "b": torch.full((heads,), 3.0, dtype=torch.float32,
                                  device=device)},
        "down": layers.dense_init(gen, d_inner, cfg.d_model, device),
    }


def _mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM. q/k/v: (B, S, H, D); i_pre/f_pre:
    (B, S, H); state: (Chat (B,H,D,D), nhat (B,H,D), m (B,H)). With
    F_t = cumsum(log f), a_j = i_j - F_j, g_t = max(m_in, cummax(a)_t):

      h_t = num_t / max(|den_t|, 1)
      num_t = u_t (q_t . Chat_in) + sum_{j<=t} w_tj (q_t . k_j) v_j
      den_t = u_t (q_t . nhat_in) + sum_{j<=t} w_tj (q_t . k_j)

    with w_tj = exp(a_j - g_t), u_t = exp(m_in - g_t): the sequential
    recurrence, stabilized as the JAX package's."""
    b, s, h, d = q.shape
    pad = (-s) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-1e30)  # padded i gate ~ 0
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)   # padded f gate ~ 1
    nc = q.shape[1] // chunk
    chat, nhat, m_in = state
    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc32, kc32, vc32 = (t[:, sl].to(torch.float32) for t in (q, k, v))
        ic, fc = i_pre[:, sl], f_pre[:, sl]
        log_f = F.logsigmoid(fc)                               # (B,L,H)
        big_f = torch.cumsum(log_f, dim=1)                     # inclusive
        a = ic - big_f
        g = torch.maximum(m_in[:, None, :], torch.cummax(a, dim=1).values)
        m_t = big_f + g
        w = torch.exp(a[:, None, :, :] - g[:, :, None, :])     # (B,t,j,H)
        w = w * causal.to(w.dtype)
        u = torch.exp(m_in[:, None, :] - g)                    # (B,L,H)

        scores = torch.einsum("bihk,bjhk->bijh", qc32, kc32)
        ws = w * scores
        num = (torch.einsum("bijh,bjhv->bihv", ws, vc32)
               + u[..., None] * torch.einsum("bihk,bhkv->bihv", qc32, chat))
        den = (torch.sum(ws, dim=2)
               + u * torch.einsum("bihk,bhk->bih", qc32, nhat))
        outs.append(num / torch.clamp_min(torch.abs(den), 1.0)[..., None])

        # chunk-final state, stabilized at m_out = m at the last position
        f_tot = big_f[:, -1, :]
        m_out = m_t[:, -1, :]
        decay_j = torch.exp(f_tot[:, None, :] - big_f + ic
                            - m_out[:, None, :])               # (B,L,H)
        carry = torch.exp(f_tot + m_in - m_out)
        chat = (carry[:, :, None, None] * chat
                + torch.einsum("bjh,bjhk,bjhv->bhkv", decay_j, kc32, vc32))
        nhat = (carry[:, :, None] * nhat
                + torch.einsum("bjh,bjhk->bhk", decay_j, kc32))
        m_in = m_out
    h_full = torch.cat(outs, dim=1)
    return h_full[:, :s], (chat, nhat, m_in)


def mlstm_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (W, B, S, D) -> (W, B, S, D)."""
    d_inner, heads, dh = mlstm_dims(cfg)
    wn, b, s, _ = x.shape
    up = layers.dense(params["up"], x)
    xin, z = torch.chunk(up, 2, dim=-1)
    # the JAX package divides by a weakly typed float32 sqrt(dh), which
    # takes the activations' dtype
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)

    def heads_of(t):
        return t.reshape(wn * b, s, heads, dh)

    q = heads_of(layers.dense(params["q"], xin) / scale.to(x.device))
    k = heads_of(layers.dense(params["k"], xin) / scale.to(x.device))
    v = heads_of(layers.dense(params["v"], xin))
    i_pre = layers.dense(params["igate"], xin).to(torch.float32)
    fg = params["fgate"]
    f_pre = (torch.matmul(xin.to(torch.float32).reshape(wn, -1, d_inner),
                          fg["w"]).reshape(wn, b, s, heads)
             + fg["b"][:, None, None, :])
    state = (torch.zeros((wn * b, heads, dh, dh), dtype=torch.float32,
                         device=x.device),
             torch.zeros((wn * b, heads, dh), dtype=torch.float32,
                         device=x.device),
             torch.full((wn * b, heads), -1e30, dtype=torch.float32,
                        device=x.device))
    hmat, _ = _mlstm_chunked(q, k, v, i_pre.reshape(wn * b, s, heads),
                             f_pre.reshape(wn * b, s, heads), state)
    hflat = hmat.to(x.dtype).reshape(wn, b, s, d_inner)
    return layers.dense(params["down"], hflat * F.silu(z))


# ------------------------------------------------------------------ sLSTM --
def slstm_dims(cfg) -> Tuple[int, int]:
    heads = cfg.lstm_heads
    return heads, cfg.d_model // heads


def slstm_init(gen, cfg, device):
    heads, dh = slstm_dims(cfg)
    d = cfg.d_model
    return {
        "wx": layers.dense_init(gen, d, 4 * d, device),
        "r": {"w": layers.normal(gen, (heads, dh, 4 * dh), device)
              / math.sqrt(dh)},
        "fbias": torch.full((heads, dh), 3.0, dtype=torch.float32,
                            device=device),
    }


def slstm_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (W, B, S, D) -> (W, B, S, D): the stabilized sLSTM recurrence,
    one time step per loop iteration."""
    heads, dh = slstm_dims(cfg)
    wn, b, s, d = x.shape
    wx = layers.dense(params["wx"], x).reshape(wn, b, s, heads, 4 * dh)
    xs = wx.permute(2, 0, 3, 1, 4)                       # (S, W, H, B, 4dh)
    r_w = params["r"]["w"]                               # (W, H, dh, 4dh)
    fbias = params["fbias"][:, :, None, :]               # (W, H, 1, dh)
    zero = torch.zeros((wn, heads, b, dh), dtype=torch.float32,
                       device=x.device)
    c, n, h = zero, zero, zero
    m = torch.full_like(zero, -1e30)
    hs = []
    for t in range(s):
        pre = xs[t].to(torch.float32) + torch.matmul(h, r_w)
        i_pre, f_pre, z_pre, o_pre = torch.split(pre, dh, dim=-1)
        log_f = F.logsigmoid(f_pre + fbias)
        m_new = torch.maximum(log_f + m, i_pre)
        i_sc = torch.exp(i_pre - m_new)
        f_sc = torch.exp(log_f + m - m_new)
        c = f_sc * c + i_sc * torch.tanh(z_pre)
        n = torch.clamp_min(f_sc * n + i_sc, 1e-6)
        h = torch.sigmoid(o_pre) * c / n
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=0).permute(1, 3, 0, 2, 4)  # (W, B, S, H, dh)
    return out.reshape(wn, b, s, d).to(x.dtype)
