"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), after arXiv:2405.04517 — the port of
``repro.models.xlstm``.

Two layouts. Training (consensus) takes ``x (W, B, S, D)`` with a leading
worker axis on the parameters too; serving takes ``x (B, S, D)``, one
model's parameters and optionally a decode ``cache`` (:func:`mlstm_cache`,
:func:`slstm_cache`) whose state it reads and **writes back in place**, as
the attention caches are written.

* mLSTM runs a multi-token forward in its chunkwise-parallel form
  (``_mlstm_chunked``), exact and max-stabilized, with the JAX package's
  chunk of 256 and its padding constants (``i_pre = -1e30`` and
  ``f_pre = 30`` past the sequence end), from the incoming state; a
  one-token serving step runs the recurrence itself.
* sLSTM in training runs its recurrence as a Python loop over time (the
  JAX package trains it through ``lax.scan``; its fused cell has no
  backward). In serving, ``use_kernel=True`` sends a multi-token forward
  through ``kernels.ops.slstm_cell`` (the CUDA kernel B9 on the card, its
  plain version on the CPU); one token, or ``use_kernel=False``, runs the
  same loop.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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
        # cummax(a) as a masked max over j <= t: the same values, and a
        # backward without atomics (torch.cummax's scatters into repeated
        # indices, so on the card its gradient changed from run to run)
        run_max = torch.where(causal, a[:, None, :, :],
                              float("-inf")).amax(dim=2)
        g = torch.maximum(m_in[:, None, :], run_max)
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


def _mlstm_steps(q, k, v, i_pre, f_pre, state):
    """The mLSTM recurrence one token at a time (a decode step). Shapes
    as :func:`_mlstm_chunked`; returns (h (B, S, H, D) float32, state)."""
    c_mat, n_vec, m = state
    outs = []
    for t in range(q.shape[1]):
        qt, kt, vt = (x[:, t].to(torch.float32) for x in (q, k, v))
        it, ft = i_pre[:, t], f_pre[:, t]
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_sc = torch.exp(it - m_new)[:, :, None]
        f_sc = torch.exp(log_f + m - m_new)[:, :, None]
        c_mat = f_sc[..., None] * c_mat + i_sc[..., None] * (
            kt[..., :, None] * vt[..., None, :])
        n_vec = f_sc * n_vec + i_sc * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, c_mat)
        den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", qt,
                                                     n_vec)), 1.0)[..., None]
        outs.append(num / den)
        m = m_new
    return torch.stack(outs, dim=1), (c_mat, n_vec, m)


def _fresh_mlstm_state(n: int, heads: int, dh: int, device):
    return (torch.zeros((n, heads, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((n, heads, dh), dtype=torch.float32, device=device),
            torch.full((n, heads), -1e30, dtype=torch.float32,
                       device=device))


def mlstm_apply(params, cfg, x: torch.Tensor,
                cache: Optional[dict] = None) -> torch.Tensor:
    """x (W, B, S, D) -> (W, B, S, D) (training), or x (B, S, D) ->
    (B, S, D) (serving). With a ``cache`` (serving only) the recurrence
    starts from its state and the new state is written into it."""
    d_inner, heads, dh = mlstm_dims(cfg)
    training = x.dim() == 4
    if training and cache is not None:
        raise ValueError("mlstm_apply: the training layout has no cache")
    lead, s = x.shape[:-2], x.shape[-2]
    n = math.prod(lead)
    up = layers.dense(params["up"], x)
    xin, z = torch.chunk(up, 2, dim=-1)
    # the JAX package divides by a weakly typed float32 sqrt(dh), which
    # takes the activations' dtype
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)

    def heads_of(t):
        return t.reshape(n, s, heads, dh)

    q = heads_of(layers.dense(params["q"], xin) / scale.to(x.device))
    k = heads_of(layers.dense(params["k"], xin) / scale.to(x.device))
    v = heads_of(layers.dense(params["v"], xin))
    i_pre = layers.dense(params["igate"], xin).to(torch.float32)
    fg = params["fgate"]
    if training:
        wn = x.shape[0]
        f_pre = (torch.matmul(xin.to(torch.float32).reshape(wn, -1, d_inner),
                              fg["w"]).reshape(x.shape[:-1] + (heads,))
                 + fg["b"][:, None, None, :])
    else:
        f_pre = torch.matmul(xin.to(torch.float32), fg["w"]) + fg["b"]
    i_pre, f_pre = i_pre.reshape(n, s, heads), f_pre.reshape(n, s, heads)
    state = (_fresh_mlstm_state(n, heads, dh, x.device) if cache is None
             else (cache["c"], cache["n"], cache["m"]))
    if s > 1:
        hmat, state = _mlstm_chunked(q, k, v, i_pre, f_pre, state)
    else:
        hmat, state = _mlstm_steps(q, k, v, i_pre, f_pre, state)
    if cache is not None:
        for name, new in zip(("c", "n", "m"), state):
            cache[name].copy_(new)
    hflat = hmat.to(x.dtype).reshape(lead + (s, d_inner))
    return layers.dense(params["down"], hflat * F.silu(z))


def mlstm_cache(cfg, batch: int, device="cpu") -> dict:
    """A fresh mLSTM decode state: C (B, H, dh, dh), n (B, H, dh) zero and
    the stabilizer m (B, H) at -1e30, all float32."""
    _, heads, dh = mlstm_dims(cfg)
    c, n, m = _fresh_mlstm_state(batch, heads, dh, device)
    return {"c": c, "n": n, "m": m}


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


def _slstm_loop(xs, r_w, fbias, state):
    """The stabilized sLSTM recurrence, one time step per loop iteration.
    xs (S, ..., H, B, 4dh); r_w (..., H, dh, 4dh); fbias (..., H, 1, dh);
    state (c, n, m, h) each (..., H, B, dh) float32, the leading axes the
    worker axis in training and none in serving. Returns (hs (S, ..., H,
    B, dh), final state)."""
    dh = r_w.shape[-2]
    c, n, m, h = state
    hs = []
    for t in range(xs.shape[0]):
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
    return torch.stack(hs, dim=0), (c, n, m, h)


def slstm_apply(params, cfg, x: torch.Tensor, cache: Optional[dict] = None,
                use_kernel: bool = False) -> torch.Tensor:
    """x (W, B, S, D) -> (W, B, S, D) (training: the time loop), or
    x (B, S, D) -> (B, S, D) (serving). In serving the recurrence starts
    from ``cache``'s state (a fresh one without) and the new state is
    written into it; with ``use_kernel`` a multi-token forward runs
    ``ops.slstm_cell``, as the JAX package's ``use_kernel`` route does."""
    heads, dh = slstm_dims(cfg)
    if x.dim() == 4:
        if cache is not None or use_kernel:
            raise ValueError("slstm_apply: the training layout takes neither "
                             "a cache nor the kernel (it has no backward)")
        wn, b, s, d = x.shape
        wx = layers.dense(params["wx"], x).reshape(wn, b, s, heads, 4 * dh)
        zero = torch.zeros((wn, heads, b, dh), dtype=torch.float32,
                           device=x.device)
        hs, _ = _slstm_loop(wx.permute(2, 0, 3, 1, 4), params["r"]["w"],
                            params["fbias"][:, :, None, :],
                            (zero, zero, torch.full_like(zero, -1e30), zero))
        out = hs.permute(1, 3, 0, 2, 4)                  # (W, B, S, H, dh)
        return out.reshape(wn, b, s, d).to(x.dtype)
    b, s, d = x.shape
    wx = layers.dense(params["wx"], x).reshape(b, s, heads, 4 * dh)
    if cache is not None:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        state = tuple(slstm_cache(cfg, b, x.device).values())
    if use_kernel and s > 1:
        hs, new = ops.slstm_cell(wx, params["r"]["w"], params["fbias"],
                                 *state)
    else:
        hs, new = _slstm_loop(wx.permute(1, 2, 0, 3), params["r"]["w"],
                              params["fbias"][:, None, :],
                              tuple(t.transpose(0, 1) for t in state))
        hs = hs.permute(2, 0, 1, 3)                      # (B, S, H, dh)
        new = tuple(t.transpose(0, 1) for t in new)
    if cache is not None:
        for name, t in zip(("c", "n", "m", "h"), new):
            cache[name].copy_(t)
    return hs.reshape(b, s, d).to(x.dtype)


def slstm_cache(cfg, batch: int, device="cpu") -> dict:
    """A fresh sLSTM decode state: c, n, h (B, H, dh) zero and the
    stabilizer m at -1e30, all float32."""
    heads, dh = slstm_dims(cfg)
    zero = torch.zeros((batch, heads, dh), dtype=torch.float32, device=device)
    return {"c": zero, "n": zero.clone(),
            "m": torch.full_like(zero, -1e30), "h": zero.clone()}
