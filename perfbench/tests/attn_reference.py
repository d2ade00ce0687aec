"""A plain reference model for the CPU tests: the program's "attn" decoder
(a llama-style block, ``models/blocks.py``) in float32 plain PyTorch, with
a leading worker axis W on every parameter and batch, and the interface
every reference model of ``perfbench/reference/`` exports. The tests put it
where a configuration's ``reference`` names it, to show that a second
model needs new files only.

``num_layers`` pre-normed blocks (RMSNorm) in a residual stream of width D:
causal self-attention with rotary positions (rotate-half, base 10,000) and
``num_kv_heads`` key/value heads shared by ``num_heads`` query heads of
width D / num_heads, scores scaled by 1/sqrt(head width); then a gated
SiLU MLP of width ``d_ff``; a final RMSNorm and a tied embedding. The loss
is each worker's mean next-token cross entropy: the program's ``lm_loss``
adds no other term for this block.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.xlstm import Act, Path, fp8  # noqa: F401

MODEL_KEYS = ("d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "num_layers")
EPS = 1e-6
ROPE_THETA = 10000.0


def layout(c: dict) -> Dict[Path, Tuple[int, ...]]:
    d, h, kv, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["d_ff"]
    hd, n = d // h, c["num_layers"]
    u = ("stack", "units", "p0")
    shapes = {
        ("embed", "table"): (c["vocab_size"], d),
        ("final_norm", "scale"): (d,),
        u + ("attn", "q", "w"): (n, d, h * hd),
        u + ("attn", "k", "w"): (n, d, kv * hd),
        u + ("attn", "v", "w"): (n, d, kv * hd),
        u + ("attn", "o", "w"): (n, h * hd, d),
        u + ("ln1", "scale"): (n, d),
        u + ("ln2", "scale"): (n, d),
        u + ("mlp", "wi_gate", "w"): (n, d, f),
        u + ("mlp", "wi_up", "w"): (n, d, f),
        u + ("mlp", "wo", "w"): (n, f, d),
    }
    return dict(sorted(shapes.items()))


def init_scales(c: dict) -> Dict[Path, Tuple[str, float]]:
    """Norms 1, the embedding N(0, 0.02^2), projections N(0, 1/fan_in)."""
    out = {}
    for path, shape in layout(c).items():
        if path[-1] == "scale":
            out[path] = ("const", 1.0)
        elif path == ("embed", "table"):
            out[path] = ("normal", 0.02)
        else:
            out[path] = ("normal", 1.0 / math.sqrt(shape[-2]))
    return out


def _rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * scale[:, None, None, :]


def _proj(x, w, act: Act):
    lead = x.shape
    out = torch.bmm(x.reshape(lead[0], -1, lead[-1]), act(w))
    return act(out.reshape(lead[:-1] + (w.shape[-1],)))


def _rope(x):
    """x (W, B, S, heads, hd) rotated by its positions 0..S-1."""
    s, hd = x.shape[2], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / ROPE_THETA ** (torch.arange(half, dtype=torch.float32)
                                 / half)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    cos, sin = (t.to(x.device)[None, None, :, None, :]
                for t in (torch.cos(ang), torch.sin(ang)))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p, x, c, act: Act):
    wn, b, s, d = x.shape
    h, kv = c["num_heads"], c["num_kv_heads"]
    hd = d // h
    q = act(_rope(_proj(x, p["q"], act).reshape(wn, b, s, h, hd)))
    k = act(_rope(_proj(x, p["k"], act).reshape(wn, b, s, kv, hd)))
    v = _proj(x, p["v"], act).reshape(wn, b, s, kv, hd)
    q = q.reshape(wn, b, s, kv, h // kv, hd)
    scores = torch.einsum("wbqkgd,wbskd->wbkgqs", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = act(torch.softmax(scores.masked_fill(~causal, -math.inf),
                              dim=-1))
    out = act(torch.einsum("wbkgqs,wbskd->wbqkgd", probs, v))
    return _proj(out.reshape(wn, b, s, h * hd), p["o"], act)


def _mlp(p, x, act: Act):
    gate = _proj(x, p["wi_gate"], act)
    up = _proj(x, p["wi_up"], act)
    return _proj(act(act(F.silu(gate)) * up), p["wo"], act)


def losses(params: Dict[Path, torch.Tensor], tokens: torch.Tensor,
           labels: torch.Tensor, c: dict, act: Act) -> torch.Tensor:
    """Each worker's mean next-token cross entropy, (W,)."""
    table = params[("embed", "table")]
    rows = torch.arange(table.shape[0], device=tokens.device)[:, None, None]
    x = act(table[rows, tokens.long()])
    u = ("stack", "units", "p0")
    for r in range(c["num_layers"]):
        def at(*name):
            return params[u + name][:, r]
        attn = {k: at("attn", k, "w") for k in ("q", "k", "v", "o")}
        x = act(x + _attention(attn, act(_rmsnorm(x, at("ln1", "scale"))),
                               c, act))
        mlp = {k: at("mlp", k, "w") for k in ("wi_gate", "wi_up", "wo")}
        x = act(x + _mlp(mlp, act(_rmsnorm(x, at("ln2", "scale"))), act))
    x = act(_rmsnorm(x, params[("final_norm", "scale")]))
    logits = _proj(x, table.transpose(1, 2), act)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - picked).mean(dim=(1, 2))


def token_flops(c: dict, seq: int) -> float:
    """Forward matrix-product operations of one token: 2 per weight of
    every projection and of the tied unembedding, and the q.k and weighted
    sum over the (seq + 1) / 2 positions before it on average."""
    d, h, kv, f = c["d_model"], c["num_heads"], c["num_kv_heads"], c["d_ff"]
    hd = d // h
    layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    weights = c["num_layers"] * layer + d * c["vocab_size"]
    return 2.0 * weights + c["num_layers"] * 2 * 2 * h * hd * (seq + 1) / 2.0
