"""A plain xLSTM language model (arXiv:2405.04517) for consensus training:
its parameter layout, forward pass and per-worker loss, in float32 plain
PyTorch, with a leading worker axis W on every parameter and batch.

The model is the one the benchmark's configuration names: ``layers``
blocks alternating mLSTM and sLSTM, each pre-normed (RMSNorm, eps 1e-6) in
a residual stream of width D, the sLSTM block followed by a gated SiLU MLP
of width int(4 D / 3); a tied embedding and a final RMSNorm.

* mLSTM (matrix memory), in its parallel stabilized form over the whole
  sequence from a zero state: up-projection to 2 x Di (Di = 2 D) split into
  the cell input and the output gate z; q and k projections divided by
  sqrt(dh), v; input gate pre-activations i from a projection, forget gate
  pre-activations f from a projection with a bias; with
  F_t = sum_{s<=t} log sigmoid(f_s), log D_tj = F_t - F_j + i_j (j <= t),
  m_t = max_j log D_tj and w_tj = exp(log D_tj - m_t):
  h_t = sum_j w_tj (q_t . k_j) v_j / max(|sum_j w_tj (q_t . k_j)|, 1).
  Departure from the paper, noted: the floor of the normalizer is 1 in the
  stabilized scale (the paper's is exp(-m_t)), as this repository's model
  defines it. Out: down-projection of h * silu(z).
* sLSTM (scalar memory, exponential gating), step by step: per head,
  pre-activations [i, f, z, o] (each dh wide, the projection's columns
  grouped by head) plus the recurrent h R; log f = log sigmoid(f + bias),
  m' = max(log f + m, i), c' = e^{log f + m - m'} c + e^{i - m'} tanh z,
  n' = max(e^{log f + m - m'} n + e^{i - m'}, 1e-6), h' = sigmoid(o) c'/n'.

``act`` rounds the activations where the model stores them (each
projection's operands, weights included, and output, the norms' outputs,
the residual stream, the cells' outputs, the logits); the identity for the
float32 reference, a lower precision for the control.

A configuration names this module as its ``reference``; the LM harness
reads the model through the names every reference model exports:
``MODEL_KEYS``, ``layout``, ``init_scales``, ``losses``, ``Act``, ``fp8``
and ``token_flops``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Path = Tuple[str, ...]
Act = Callable[[torch.Tensor], torch.Tensor]
EPS = 1e-6
# the configuration's keys that size the model, handed to the program's
# ``ModelConfig.with_overrides`` and to every function here
MODEL_KEYS = ("d_model", "lstm_heads", "vocab_size", "num_layers")


def dims(c: dict) -> dict:
    d, h = c["d_model"], c["lstm_heads"]
    return {"d": d, "h": h, "di": 2 * d, "dhm": 2 * d // h, "dhs": d // h,
            "ff": int(4 * d / 3), "v": c["vocab_size"],
            "units": c["num_layers"] // 2}


def layout(c: dict) -> Dict[Path, Tuple[int, ...]]:
    """Every parameter's path and shape (no worker axis), in the order of
    their paths; a unit's parameters carry a leading depth axis."""
    k = dims(c)
    d, di, h, u = k["d"], k["di"], k["h"], k["units"]
    m = ("stack", "units", "p0")
    s = ("stack", "units", "p1")
    shapes = {
        ("embed", "table"): (k["v"], d),
        ("final_norm", "scale"): (d,),
        m + ("ln", "scale"): (u, d),
        m + ("cell", "up", "w"): (u, d, 2 * di),
        m + ("cell", "q", "w"): (u, di, di),
        m + ("cell", "k", "w"): (u, di, di),
        m + ("cell", "v", "w"): (u, di, di),
        m + ("cell", "igate", "w"): (u, di, h),
        m + ("cell", "fgate", "w"): (u, di, h),
        m + ("cell", "fgate", "b"): (u, h),
        m + ("cell", "down", "w"): (u, di, d),
        s + ("ln", "scale"): (u, d),
        s + ("cell", "wx", "w"): (u, d, 4 * d),
        s + ("cell", "r", "w"): (u, h, k["dhs"], 4 * k["dhs"]),
        s + ("cell", "fbias"): (u, h, k["dhs"]),
        s + ("ln2", "scale"): (u, d),
        s + ("mlp", "wi_gate", "w"): (u, d, k["ff"]),
        s + ("mlp", "wi_up", "w"): (u, d, k["ff"]),
        s + ("mlp", "wo", "w"): (u, k["ff"], d),
    }
    return dict(sorted(shapes.items()))


def init_scales(c: dict) -> Dict[Path, Tuple[str, float]]:
    """How the benchmark draws each parameter: ("normal", std) or
    ("const", value). Projections N(0, 1/fan_in), the gates' projections
    N(0, 0.01^2), the embedding N(0, 0.02^2), the sLSTM recurrence
    N(0, 1/dh); norms 1, forget-gate biases 3."""
    out = {}
    for path, shape in layout(c).items():
        if path[-1] == "scale":
            out[path] = ("const", 1.0)
        elif path[-1] in ("b", "fbias"):
            out[path] = ("const", 3.0)
        elif path == ("embed", "table"):
            out[path] = ("normal", 0.02)
        elif path[-2] in ("igate", "fgate"):
            out[path] = ("normal", 0.01)
        else:
            out[path] = ("normal", 1.0 / math.sqrt(shape[-2]))
    return out


def _rmsnorm(x, scale):
    """x (W, B, S, D), scale (W, D)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * scale[:, None, None, :]


def _proj(x, w, act: Act):
    """x (W, ..., i) @ w (W, i, o): the weights taken at the activations'
    precision, the product rounded."""
    lead = x.shape
    out = torch.bmm(x.reshape(lead[0], -1, lead[-1]), act(w))
    return act(out.reshape(lead[:-1] + (w.shape[-1],)))


def _mlstm(p, x, k, act: Act):
    wn, b, s, _ = x.shape
    h, dh = k["h"], k["dhm"]
    up = _proj(x, p["up"], act)
    xin, z = up[..., :k["di"]], up[..., k["di"]:]
    root = math.sqrt(dh)
    q = act(_proj(xin, p["q"], act) / root).reshape(wn, b, s, h, dh)
    kk = act(_proj(xin, p["k"], act) / root).reshape(wn, b, s, h, dh)
    v = _proj(xin, p["v"], act).reshape(wn, b, s, h, dh)
    i_pre = _proj(xin, p["igate"], act)                       # (W,B,S,H)
    f_pre = (torch.bmm(xin.reshape(wn, -1, k["di"]), p["fgate"])
             .reshape(wn, b, s, h) + p["fgate_b"][:, None, None, :])
    big_f = torch.cumsum(F.logsigmoid(f_pre), dim=2)
    log_d = (big_f[:, :, :, None, :] - big_f[:, :, None, :, :]
             + i_pre[:, :, None, :, :])                       # (W,B,t,j,H)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    log_d = log_d.masked_fill(~causal[None, None, :, :, None], -math.inf)
    w = torch.exp(log_d - log_d.amax(dim=3, keepdim=True))
    scores = torch.einsum("wbthk,wbjhk->wbtjh", q, kk) * w
    num = torch.einsum("wbtjh,wbjhv->wbthv", scores, v)
    den = scores.sum(dim=3)
    hmat = act(num / torch.clamp_min(den.abs(), 1.0)[..., None])
    out = act(hmat.reshape(wn, b, s, k["di"]) * act(F.silu(z)))
    return _proj(out, p["down"], act)


def _slstm(p, x, k, act: Act):
    wn, b, s, d = x.shape
    h, dh = k["h"], k["dhs"]
    pre_x = _proj(x, p["wx"], act).reshape(wn, b, s, h, 4 * dh)
    c = torch.zeros((wn, b, h, dh), device=x.device)
    n = torch.zeros_like(c)
    hid = torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    outs = []
    for t in range(s):
        pre = pre_x[:, :, t] + torch.einsum("wbhk,whkg->wbhg", hid, p["r"])
        i, f, z, o = pre.split(dh, dim=-1)
        log_f = F.logsigmoid(f + p["fbias"][:, None])
        m_new = torch.maximum(log_f + m, i)
        i_sc, f_sc = torch.exp(i - m_new), torch.exp(log_f + m - m_new)
        c = f_sc * c + i_sc * torch.tanh(z)
        n = torch.clamp_min(f_sc * n + i_sc, 1e-6)
        hid = torch.sigmoid(o) * c / n
        m = m_new
        outs.append(hid)
    return act(torch.stack(outs, dim=2).reshape(wn, b, s, d))


def _mlp(p, x, act: Act):
    gate = _proj(x, p["wi_gate"], act)
    up = _proj(x, p["wi_up"], act)
    return _proj(act(act(F.silu(gate)) * up), p["wo"], act)


def losses(params: Dict[Path, torch.Tensor], tokens: torch.Tensor,
           labels: torch.Tensor, c: dict, act: Act) -> torch.Tensor:
    """Each worker's mean next-token cross entropy, (W,): params (W, ...)
    by path, tokens and labels (W, B, S)."""
    k = dims(c)
    table = params[("embed", "table")]
    wn = table.shape[0]
    rows = torch.arange(wn, device=tokens.device)[:, None, None]
    x = act(table[rows, tokens.long()])
    m, s = ("stack", "units", "p0"), ("stack", "units", "p1")
    for r in range(k["units"]):
        def at(prefix, *name):
            return params[prefix + name][:, r]
        cell = {"up": at(m, "cell", "up", "w"), "q": at(m, "cell", "q", "w"),
                "k": at(m, "cell", "k", "w"), "v": at(m, "cell", "v", "w"),
                "igate": at(m, "cell", "igate", "w"),
                "fgate": at(m, "cell", "fgate", "w"),
                "fgate_b": at(m, "cell", "fgate", "b"),
                "down": at(m, "cell", "down", "w")}
        x = act(x + _mlstm(cell, act(_rmsnorm(x, at(m, "ln", "scale"))), k,
                           act))
        cell = {"wx": at(s, "cell", "wx", "w"), "r": at(s, "cell", "r", "w"),
                "fbias": at(s, "cell", "fbias")}
        x = act(x + _slstm(cell, act(_rmsnorm(x, at(s, "ln", "scale"))), k,
                           act))
        mlp = {"wi_gate": at(s, "mlp", "wi_gate", "w"),
               "wi_up": at(s, "mlp", "wi_up", "w"),
               "wo": at(s, "mlp", "wo", "w")}
        x = act(x + _mlp(mlp, act(_rmsnorm(x, at(s, "ln2", "scale"))), act))
    x = act(_rmsnorm(x, params[("final_norm", "scale")]))
    logits = _proj(x, table.transpose(1, 2), act)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - picked).mean(dim=(1, 2))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` as 8-bit floats (e4m3, scaled so that the tensor's largest
    magnitude is the format's largest, 448) carry it: the value of the
    forward pass; gradients pass straight through."""
    amax = x.detach().abs().amax()
    if not bool(amax > 0):
        return x
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def token_flops(c: dict, seq: int) -> float:
    """Forward matrix-product operations of one token at sequence length
    ``seq``: 2 per weight of every projection (the mLSTM's up, q, k, v,
    gates and down; the sLSTM's input and recurrent weights and its MLP;
    the tied unembedding), and the mLSTM's q.k and weighted sum over the
    t <= seq positions before the token (on average (seq + 1) / 2)."""
    d, h = c["d_model"], c["lstm_heads"]
    di, ff, dhs = 2 * d, int(4 * d / 3), d // h
    units = c["num_layers"] // 2
    mlstm = d * 2 * di + 3 * di * di + 2 * di * h + di * d
    slstm = d * 4 * d + h * dhs * 4 * dhs + 3 * d * ff
    weights = units * (mlstm + slstm) + d * c["vocab_size"]
    causal = units * 2 * 2 * di * (seq + 1) / 2.0
    return 2.0 * weights + causal
