"""Shared layers of the ported models: dense projection, RMSNorm, tied
embedding / unembedding, the gated MLP, rotary embeddings and GQA
attention with contiguous and paged KV caches (the port of
``repro.models.layers`` without cross-attention, M-RoPE and the mesh
constraints).

Functional style over nested dicts of tensors, in two layouts told apart
by the parameters' rank:

* **training** (consensus engine): every parameter leaf carries a leading
  worker axis W (W models side by side), activations are ``(W, B, S,
  ...)``, and each layer contracts each worker's activations with that
  worker's weights: the JAX package's ``vmap`` over workers, written out
  as batched matrix products;
* **serving**: one model, no worker axis, activations ``(B, S, ...)``.

Weights are float32 and cast to the activation dtype at use, as in the JAX
package. KV caches are updated **in place** (the JAX package returns new
arrays): the page pools are the largest tensors of a serving step, and a
copy per layer and step would double the step's memory traffic.

``*_init`` functions build ONE model's parameters (no worker axis) from a
``torch.Generator``; on the ``meta`` device they allocate nothing (shapes
only, for bucket names and parameter counts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref


def normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard normal float32 draws (shape only on the meta device)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------- basics --
def dense_init(gen, in_dim: int, out_dim: int, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return {"w": normal(gen, (in_dim, out_dim), device) * scale}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """x (W, ..., d) @ w (W, d, f) -> (W, ..., f), or x (..., d) @ w (d, f)
    -> (..., f) without a worker axis; in x's dtype."""
    w = params["w"]
    if w.dim() == 2:
        return torch.matmul(x, w.to(x.dtype))
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    out = torch.matmul(flat, w.to(x.dtype))
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def rmsnorm_init(dim: int, device):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def _per_worker(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """(W, ...) parameter -> broadcastable against a (W, ..., last) tensor
    of ``ndim`` dims; a 1-D parameter (no worker axis) as it is."""
    if p.dim() == 1:
        return p
    return p.reshape((p.shape[0],) + (1,) * (ndim - p.dim()) + p.shape[1:])


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * _per_worker(params["scale"], x.dim())).to(x.dtype)


def embed_init(gen, vocab: int, dim: int, device):
    return {"table": normal(gen, (vocab, dim), device) * 0.02}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (W, B, S) -> (W, B, S, D) rows of each worker's table, or
    tokens (B, S) -> (B, S, D) of the one table."""
    table = params["table"]
    if table.dim() == 2:
        return table[tokens.long()]
    w = torch.arange(table.shape[0], device=tokens.device)
    return table[w.reshape((-1,) + (1,) * (tokens.dim() - 1)), tokens.long()]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T, (W, B, S, V) or (B, S, V)."""
    table = params["table"].to(x.dtype)
    if table.dim() == 2:
        return torch.matmul(x, table.t())
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    out = torch.matmul(flat, table.transpose(1, 2))
    return out.reshape(x.shape[:-1] + (table.shape[1],))


# -------------------------------------------------------------------- MLP --
def mlp_init(gen, d_model: int, d_ff: int, device):
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, device),
        "wi_up": dense_init(gen, d_model, d_ff, device),
        "wo": dense_init(gen, d_ff, d_model, device,
                         scale=1.0 / math.sqrt(d_ff)),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    gate = dense(params["wi_gate"], x)
    up = dense(params["wi_up"], x)
    return dense(params["wo"], F.silu(gate) * up)


# ----------------------------------------------------------------- rotary --
def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """positions (...,) -> (..., head_dim/2) float32 angles."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exps)
    return positions.to(torch.float32)[..., None] * freqs


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles at positions (B, S), each
    (B, S, 1, head_dim/2) float32: computed once per layer for q and k."""
    angles = _rope_angles(positions, head_dim, theta)[:, :, None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) with :func:`rope_tables` of its
    positions, computed in float32 and returned in x's dtype
    (rotate-half layout)."""
    cos, sin = tables
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --
@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def attention_init(gen, dims: AttnDims, device):
    d, h, kv, hd = (dims.d_model, dims.num_heads, dims.num_kv_heads,
                    dims.head_dim)
    return {
        "q": dense_init(gen, d, h * hd, device),
        "k": dense_init(gen, d, kv * hd, device),
        "v": dense_init(gen, d, kv * hd, device),
        "o": dense_init(gen, h * hd, d, device, scale=1.0 / math.sqrt(h * hd)),
    }


def _attn_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
               causal: bool, window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Skv) boolean mask (True = attend); kv position -1 marks an
    unwritten slot."""
    q = q_positions[:, :, None]
    k = (kv_positions[:, None, :] if kv_positions.dim() == 2
         else kv_positions[None, None, :])
    mask = k >= 0
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & ((q - k) < window)
    return torch.broadcast_to(mask, (q.shape[0], q.shape[1], k.shape[-1]))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, KV, D), mask (B, Sq, Skv) ->
    (B, Sq, H, D), as the JAX package writes it: QK^T in the activation
    dtype, then a float32 softmax, probabilities cast back for the V
    product (no fused attention call: its numerics differ)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, sq, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                              device=q.device))
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


# Query-chunk threshold above which attention runs blockwise (exact: each
# query row's softmax still spans every key), so that only (B, H, BLOCK_Q,
# Skv) float32 logits are live at once.
MHA_BLOCKWISE_THRESHOLD = 2048
BLOCK_Q = 512


def mha_blockwise(q, k, v, q_positions, kv_positions, causal, window,
                  block_q: int = BLOCK_Q):
    """:func:`mha` over query chunks of ``block_q``, with each chunk's mask
    built from positions."""
    outs = [mha(q[:, i:i + block_q], k, v,
                _attn_mask(q_positions[:, i:i + block_q], kv_positions,
                           causal, window))
            for i in range(0, q.shape[1], block_q)]
    return torch.cat(outs, dim=1)


def init_kv_cache(batch: int, cache_len: int, num_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu"):
    """Ring-buffer KV cache: the entry for position p lives at slot
    p % cache_len; ``kv_pos`` holds each slot's position (-1 = empty)."""
    shape = (batch, cache_len, num_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                                 device=device)}


def _cache_write(cache, k, v, q_positions):
    """Write S new (k, v) entries at slots positions % cache_len, in
    place."""
    w = cache["k"].shape[1]
    slots = (q_positions % w).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["kv_pos"][bidx, slots] = q_positions.to(torch.int32)
    return cache


# ------------------------------------------------------- paged KV cache --
def init_paged_kv_cache(batch: int, num_pages: int, page_size: int,
                        pages_per_seq: int, num_kv: int, head_dim: int,
                        dtype=torch.bfloat16, kv_bits: int = 32,
                        device="cpu"):
    """Paged KV cache: a pool of ``num_pages`` pages of ``page_size`` slots
    shared by all sequences, and per-sequence block tables
    (``block_tables[b, l]`` = the physical page of sequence b's logical
    page l, -1 = unmapped). The entry for position p lives at
    (block_tables[b, p // page_size], p % page_size). ``kv_pos`` is
    pool-shaped (-1 = unwritten), so a recycled page never leaks a previous
    owner's entries into attention. ``kv_bits`` 8 or 4 stores uint8
    ``kv_page_quantize`` codes plus float32 ranges in ``k_scale`` /
    ``v_scale``; ``dtype`` then shapes nothing."""
    common = {
        "kv_pos": torch.full((num_pages, page_size), -1, dtype=torch.int32,
                             device=device),
        "block_tables": torch.full((batch, pages_per_seq), -1,
                                   dtype=torch.int32, device=device),
    }
    if kv_bits == 32:
        shape = (num_pages, page_size, num_kv, head_dim)
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device),
                **common}
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 32, 8 or 4, got {kv_bits}")
    if kv_bits == 4 and head_dim % 2:
        raise ValueError("4-bit KV pages need an even head_dim")
    store = head_dim if kv_bits == 8 else head_dim // 2
    shape = (num_pages, page_size, num_kv, store)
    return {
        "k_pages": torch.zeros(shape, dtype=torch.uint8, device=device),
        "v_pages": torch.zeros(shape, dtype=torch.uint8, device=device),
        "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        **common,
    }


def is_paged_cache(cache) -> bool:
    return isinstance(cache, dict) and "k_pages" in cache


def paged_kv_bits(cache, head_dim: int) -> int:
    """Storage bits of a paged cache's pools, from their structure."""
    if "k_scale" not in cache:
        return 32
    return 8 if cache["k_pages"].shape[-1] == head_dim else 4


def _paged_slots(cache, q_positions: torch.Tensor):
    """(physical page, in-page slot, valid) for each (b, s) position.
    Invalid: a negative position (padding, an inactive decode slot), a
    position past the table, or an unmapped page."""
    page_size = cache["kv_pos"].shape[-1]
    bt = cache["block_tables"]
    qp = q_positions.long()
    logical = torch.div(qp, page_size, rounding_mode="floor")
    valid = (qp >= 0) & (logical < bt.shape[1])
    phys = torch.gather(bt, 1, torch.clamp(logical, 0, bt.shape[1] - 1))
    valid = valid & (phys >= 0)
    return phys.long(), qp % page_size, valid


def _write_targets(pf: torch.Tensor, sf: torch.Tensor, valid: torch.Tensor):
    """Where each entry of a cache write lands, without a host
    synchronisation (the JAX package drops invalid writes with
    ``mode="drop"``; PyTorch has no such scatter). An invalid entry
    repeats the first valid entry's write (same index, same value: the
    result does not depend on which duplicate lands last). Returns
    ``(page, slot, source entry, any valid)``; with no valid entry at all
    the caller rewrites slot (0, 0) with its own content."""
    any_valid = valid.any()
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    src = torch.where(valid, torch.arange(valid.shape[0], device=pf.device),
                      first)
    zero = torch.zeros((), dtype=pf.dtype, device=pf.device)
    return (torch.where(any_valid, pf[src], zero),
            torch.where(any_valid, sf[src], zero), src, any_valid)


def _paged_cache_write(cache, k, v, q_positions):
    """Write S new (k, v) entries through the block table into the pools,
    in place. Code pools encode each entry at write time, with its range in
    the scale leaves."""
    phys, slots, valid = _paged_slots(cache, q_positions)
    pf, sf, src, any_valid = _write_targets(
        phys.reshape(-1), slots.reshape(-1), valid.reshape(-1))

    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    if "k_scale" in cache:
        bits = paged_kv_bits(cache, k.shape[-1])
        kq, kr = kernel_ref.kv_page_quantize(k, kv_bits=bits)
        vq, vr = kernel_ref.kv_page_quantize(v, kv_bits=bits)
        writes = (("k_pages", kq), ("v_pages", vq), ("k_scale", kr),
                  ("v_scale", vr))
    else:
        writes = (("k_pages", k.to(cache["k_pages"].dtype)),
                  ("v_pages", v.to(cache["v_pages"].dtype)))
    writes += (("kv_pos", q_positions.to(torch.int32)),)
    for name, val in writes:
        dst = cache[name]
        dst[pf, sf] = torch.where(any_valid, flat(val)[src], dst[0, 0])
    return cache


def paged_gather(cache, head_dim: Optional[int] = None):
    """Each sequence's pages in logical order as a contiguous view: (k, v,
    kv_pos) shaped (B, P·ps, ...), equal to a linear cache of that length
    (unmapped pages show kv_pos = -1). Code pools are dequantized to
    float32; ``head_dim`` is needed then."""
    bt = cache["block_tables"]
    b, p = bt.shape
    ps = cache["kv_pos"].shape[-1]
    safe = torch.where(bt >= 0, bt, 0).long()
    mapped = (bt >= 0)[:, :, None]

    def take(pool):
        g = pool[safe]                                   # (B, P, ps, ...)
        return g.reshape((b, p * ps) + g.shape[3:])

    k, v = take(cache["k_pages"]), take(cache["v_pages"])
    if "k_scale" in cache:
        if head_dim is None:
            raise ValueError("quantized paged cache: paged_gather needs "
                             "head_dim to undo the code packing")
        bits = paged_kv_bits(cache, head_dim)
        k = kernel_ref.kv_page_dequantize(k, take(cache["k_scale"]),
                                          kv_bits=bits, head_dim=head_dim)
        v = kernel_ref.kv_page_dequantize(v, take(cache["v_scale"]),
                                          kv_bits=bits, head_dim=head_dim)
    kv_pos = torch.where(mapped, cache["kv_pos"][safe], -1)
    return k, v, kv_pos.reshape(b, p * ps)


def _paged_decode(cache, q: torch.Tensor, q_positions: torch.Tensor):
    """(B, 1, H, hd) attention of one new token per sequence through the
    paged-attention decode kernel (``kernels.ops``): pages are read through
    the block table inside the kernel, never gathered into a contiguous
    copy; code pools go in with their ranges."""
    ctx_lens = torch.clamp_min(q_positions[:, 0] + 1, 0).to(torch.int32)
    kw = {}
    if "k_scale" in cache:
        kw = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"],
                  kv_bits=paged_kv_bits(cache, q.shape[-1]))
    out = kernel_ops.paged_attention_decode(
        q[:, 0], cache["k_pages"], cache["v_pages"], cache["block_tables"],
        ctx_lens, **kw)
    return out[:, None].to(q.dtype)


def attention_apply(params, dims: AttnDims, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, rope_theta: float = 10000.0,
                    use_rope: bool = True, cache: Optional[dict] = None):
    """Self-attention of x (B, S, D) at absolute ``positions`` (B, S), with
    an optional contiguous or paged cache (written in place). Returns
    ``(out (B, S, D), cache)``.

    Decode route: one new token (S = 1) without a window on a paged cache
    goes through ``kernels.ops.paged_attention_decode`` on every device
    (the plain one-shot version on the CPU, the CUDA kernels on the card).
    The JAX package takes that kernel only under
    ``REPRO_PAGED_ATTN_KERNEL=1`` and otherwise gathers the pages and runs
    :func:`mha`. Prefill chunks (S > 1) gather and run :func:`mha`, as in
    the JAX package."""
    b, s, _ = x.shape
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = dense(params["q"], x).reshape(b, s, h, hd)
    k = dense(params["k"], x).reshape(b, s, kv, hd)
    v = dense(params["v"], x).reshape(b, s, kv, hd)
    if use_rope:
        tables = rope_tables(positions, hd, rope_theta)
        q = apply_rope(q, tables)
        k = apply_rope(k, tables)
    if cache is not None:
        if is_paged_cache(cache):
            _paged_cache_write(cache, k, v, positions)
            if s == 1 and window is None:
                out = _paged_decode(cache, q, positions)
                return dense(params["o"], out.reshape(b, s, h * hd)), cache
            k, v, kv_positions = paged_gather(cache, head_dim=hd)
        else:
            _cache_write(cache, k, v, positions)
            k, v, kv_positions = cache["k"], cache["v"], cache["kv_pos"]
    else:
        kv_positions = positions
    k, v = k.to(q.dtype), v.to(q.dtype)
    if s > MHA_BLOCKWISE_THRESHOLD:
        out = mha_blockwise(q, k, v, positions, kv_positions, causal, window)
    else:
        out = mha(q, k, v, _attn_mask(positions, kv_positions, causal,
                                      window))
    return dense(params["o"], out.reshape(b, s, h * hd)), cache
