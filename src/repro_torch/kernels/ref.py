"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (``kernels.ops``), what the tests hold
against the JAX package's ``repro.kernels.ref``, and what ``chip_smoke.py``
holds each CUDA kernel against on the card. Each repeats its kernel's
arithmetic in the same order; none is a yardstick of speed.

Narrowed storage (bf16, f16: the engine's ``hat_dtype`` replicas) has one
contract in every kernel that takes it: the float32 route on the widened
values, its result rounded once to the storage dtype
(:func:`bipartite_mix_ref`, :func:`stoch_quantize_grouped_fused_ref`;
:func:`edge_gather_mix_ref` returns float32).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantization import _exp2, bit_schedule

_EPS = 1e-12
NARROW = (torch.bfloat16, torch.float16)


def stoch_quantize_ref(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                       uniforms: torch.Tensor, delta: torch.Tensor,
                       qrange: torch.Tensor) -> torch.Tensor:
    """Fused quantize -> dequantize (paper Eqs. 14, 15, 20).

    theta, q_hat_prev, uniforms: (N, d); delta, qrange: (N,) per-worker
    step size Δ and range R. All math in float32; Δ is floored at 1e-12.
    Returns the (N, d) reconstruction Q̂^k = Q̂^{k-1} + Δ q - R in
    ``theta``'s dtype."""
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    unif32 = uniforms.to(torch.float32)
    safe_delta = torch.clamp_min(delta.to(torch.float32), _EPS)[:, None]
    r = qrange.to(torch.float32)[:, None]
    c = (theta32 - qprev32 + r) / safe_delta
    floor_c = torch.floor(c)
    q = floor_c + (unif32 < (c - floor_c)).to(torch.float32)
    levels = 2.0 * r / safe_delta            # = 2^b - 1
    q = torch.minimum(torch.clamp_min(q, 0.0), levels)
    return (qprev32 + safe_delta * q - r).to(theta.dtype)


def stoch_quantize_grouped_ref(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                               uniforms: torch.Tensor, delta: torch.Tensor,
                               qrange: torch.Tensor,
                               group_ids: torch.Tensor) -> torch.Tensor:
    """Grouped quantize -> dequantize over a packed buffer (Eqs. 14-20,
    group-wise). theta, q_hat_prev, uniforms: (N, D); delta, qrange: (N, G);
    group_ids: (D,) integer column -> group map. Column j takes the side
    information of group ``group_ids[j]``; G=1 is
    :func:`stoch_quantize_ref` bit for bit."""
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    unif32 = uniforms.to(torch.float32)
    gid = group_ids.to(device=theta.device, dtype=torch.int64)
    delta_c = delta.to(torch.float32).index_select(1, gid)       # (N, D)
    range_c = qrange.to(torch.float32).index_select(1, gid)
    safe_delta = torch.clamp_min(delta_c, _EPS)
    c = (theta32 - qprev32 + range_c) / safe_delta
    floor_c = torch.floor(c)
    q = floor_c + (unif32 < (c - floor_c)).to(torch.float32)
    levels = 2.0 * range_c / safe_delta      # = 2^{b_g} - 1, column-wise
    q = torch.minimum(torch.clamp_min(q, 0.0), levels)
    return (qprev32 + safe_delta * q - range_c).to(theta.dtype)


def grouped_range_ref(diff: torch.Tensor, group_runs) -> torch.Tensor:
    """Per-worker per-group ``max |diff|`` over each group's static
    contiguous column runs: (N, G). Max does not depend on order, so any
    reduction order gives the same bits."""
    absdiff = torch.abs(diff)
    cols = []
    for runs in group_runs:
        parts = [torch.amax(absdiff[:, off:off + size], dim=1)
                 for off, size in runs]
        if not parts:
            parts = [torch.zeros((diff.shape[0],), dtype=torch.float32,
                                 device=diff.device)]
        cols.append(parts[0] if len(parts) == 1
                    else torch.amax(torch.stack(parts, dim=0), dim=0))
    return torch.stack(cols, dim=1)


def stoch_quantize_grouped_fused_ref(
    theta: torch.Tensor, q_hat_prev: torch.Tensor, uniforms: torch.Tensor,
    bits_prev: torch.Tensor, range_prev: torch.Tensor,
    initialized: torch.Tensor, group_ids: torch.Tensor, *, group_runs,
    omega: float, b0: int, b_max: int,
):
    """One whole grouped round: range reduction over the group runs, the
    Eq. (18) bit schedule (``core.quantization.bit_schedule``), the grouped
    quantize, and degenerate groups (R <= 1e-12) passed through unchanged.
    Returns ``(out (N, D), range_new, bits, delta)``, the last three
    (N, G) float32. A narrowed ``q_hat_prev`` takes the float32 route on
    its widened values, and ``out`` is rounded once to its dtype."""
    if q_hat_prev.dtype in NARROW:
        out, range_new, bits, delta = stoch_quantize_grouped_fused_ref(
            theta, q_hat_prev.to(torch.float32), uniforms, bits_prev,
            range_prev, initialized, group_ids, group_runs=group_runs,
            omega=omega, b0=b0, b_max=b_max)
        return out.to(q_hat_prev.dtype), range_new, bits, delta
    theta32 = theta.to(torch.float32)
    qprev32 = q_hat_prev.to(torch.float32)
    range_new = grouped_range_ref(theta32 - qprev32, group_runs)
    bits, delta, degen = bit_schedule(
        bits_prev.to(torch.float32), range_new,
        range_prev.to(torch.float32), initialized.to(torch.float32),
        omega, b0, b_max)
    out = stoch_quantize_grouped_ref(theta, q_hat_prev, uniforms, delta,
                                     range_new, group_ids)
    gid = group_ids.to(device=theta.device, dtype=torch.int64)
    degen_c = degen.index_select(1, gid)
    out = torch.where(degen_c, qprev32.to(out.dtype), out)
    return out, range_new, bits, delta.to(torch.float32)


def bipartite_mix_ref(adjacency: torch.Tensor, values: torch.Tensor
                      ) -> torch.Tensor:
    """Neighbor aggregation ``A @ V``: adjacency (M, N) cast to the values'
    dtype, values (N, d) -> (M, d). Narrowed values: the float32 product,
    rounded once to their dtype (not a bf16 matmul, whose rounding is the
    library's)."""
    if values.dtype in NARROW:
        return (adjacency.to(torch.float32) @ values.to(torch.float32)
                ).to(values.dtype)
    return adjacency.to(values.dtype) @ values


def edge_gather_mix_ref(values: torch.Tensor, nbr_table: torch.Tensor,
                        nbr_valid: torch.Tensor) -> torch.Tensor:
    """Neighbor sum over a degree-padded CSR table, in float32:
    ``out[n] = sum_s valid[n, s] * values[nbr[n, s]]``. values (N, d),
    nbr_table (N, S) int, nbr_valid (N, S) 1/0 -> (N, d).

    The kernel's arithmetic in its order: from 0, one slot after another,
    ``out + valid[:, s] * V[nbr[:, s]]`` with the product rounded before
    the add. A padded slot is multiplied by its 0.0, not skipped, so a NaN
    or inf in the row it points at reaches the output as in the Pallas
    body. Table ids are clamped into [0, N), as the TPU kernel's block
    index is. Narrowed values are widened first: the float32 route."""
    vals = values.to(torch.float32)
    n = vals.shape[0]
    idx = torch.clamp(nbr_table.to(torch.int64), 0, n - 1)
    w = nbr_valid.to(device=vals.device, dtype=torch.float32)
    out = torch.zeros(vals.shape, dtype=torch.float32, device=vals.device)
    for s in range(idx.shape[1]):
        out.add_(w[:, s, None] * vals.index_select(0, idx[:, s]))
    return out


# --------------------------------------------------- KV page quantization --
def kv_page_levels(kv_bits: int, device) -> torch.Tensor:
    """``2^b - 1`` of a fixed-bit page codec as the Eq. (18) schedule
    evaluates it (``exp(b ln 2) - 1``, floored at 1), a float32 scalar
    tensor on ``device``. The kernels take this value as an argument, so
    the step size they derive is the plain version's on the same card."""
    zeros = torch.zeros((), dtype=torch.float32, device=device)
    bits, _, _ = bit_schedule(zeros, zeros, zeros, zeros, 0.0, kv_bits,
                              kv_bits)
    return torch.clamp_min(_exp2(bits) - 1.0, 1.0)


def _kv_page_delta(rng: torch.Tensor, kv_bits: int) -> torch.Tensor:
    """Step size Δ = 2R / (2^b - 1) of a fixed-bit page codec through the
    same ``bit_schedule`` the engine's adaptive rounds use: a cache page is
    a group whose width never grows (initialized=0 pins b = b0 =
    ``kv_bits``)."""
    zeros = torch.zeros_like(rng)
    _, delta, _ = bit_schedule(zeros, rng, zeros, zeros, 0.0, kv_bits,
                               kv_bits)
    return torch.clamp_min(delta, _EPS)


def kv_page_quantize(x: torch.Tensor, *, kv_bits: int):
    """Encode K/V entries to ``kv_bits``-bit codes (Eqs. 14/15 with
    Q̂_prev = 0 and the deterministic draw u = 0.5).

    x: (..., KV, hd) -> (codes (..., KV, hd_store) uint8, rng (..., KV)
    float32), hd_store = hd (8-bit) or hd // 2 (4-bit, two codes per byte
    along head_dim, low nibble first). The per-entry range R = max|x| is
    the only float carried; Δ follows from it."""
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    x32 = x.to(torch.float32)
    rng = torch.amax(torch.abs(x32), dim=-1)
    delta = _kv_page_delta(rng, kv_bits)[..., None]
    c = (x32 + rng[..., None]) / delta
    floor_c = torch.floor(c)
    q = floor_c + (0.5 < (c - floor_c)).to(torch.float32)
    q = torch.clamp(q, 0.0, float(2 ** kv_bits - 1)).to(torch.int32)
    if kv_bits == 4:
        if x.shape[-1] % 2:
            raise ValueError("4-bit KV pages need an even head_dim")
        pair = q.reshape(q.shape[:-1] + (x.shape[-1] // 2, 2))
        q = pair[..., 0] | (pair[..., 1] << 4)
    return q.to(torch.uint8), rng


def kv_page_dequantize(codes: torch.Tensor, rng: torch.Tensor, *,
                       kv_bits: int, head_dim: int) -> torch.Tensor:
    """Decode :func:`kv_page_quantize` output: x̂ = Δ·q - R (Eq. 20 with
    Q̂_prev = 0). codes (..., KV, hd_store) uint8, rng (..., KV) float32 ->
    (..., KV, head_dim) float32."""
    q = codes.to(torch.int32)
    if kv_bits == 4:
        lo, hi = q & 0xF, (q >> 4) & 0xF
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[:-1] + (head_dim,))
    delta = _kv_page_delta(rng, kv_bits)[..., None]
    return delta * q.to(torch.float32) - rng[..., None]


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        ctx_lens: torch.Tensor, *,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        kv_bits: int = 32) -> torch.Tensor:
    """Single-token decode attention through a paged KV cache, in the JAX
    package's order of evaluation: per-page QK dots for each KV head, ONE
    softmax over the whole (H, P·ps) logits slab, and float32 V
    accumulation in logical page order (batched over sequences and KV
    heads, which leaves each dot's reduction unchanged).

    q: (B, H, hd); k_pages/v_pages: (num_pages, ps, KV, hd_store) float32
    or bf16 values, or uint8 codes with ``k_scale``/``v_scale``
    (num_pages, ps, KV) float32 ranges when ``kv_bits`` is 8 or 4;
    block_tables: (B, P) (-1 = unmapped: clamped into the pool and masked
    by ``ctx_lens``); ctx_lens: (B,). A slot at position >= ctx gets logit
    -1e30, so ctx = 0 averages all P·ps slots uniformly, as the JAX
    package's one-shot kernel does. Returns (B, H, hd) float32."""
    bsz, h, hd = q.shape
    num_pages, page_size, num_kv, _ = k_pages.shape
    groups = h // num_kv
    pages_per_seq = block_tables.shape[1]
    scale = 1.0 / float(np.sqrt(np.float32(hd)))
    bt = torch.clamp(block_tables.to(torch.int64), 0, num_pages - 1)
    ctx = ctx_lens.to(torch.int64)
    qb = q.to(torch.float32).reshape(bsz, num_kv, groups, hd)

    def page(pool, scales, p):                       # (B, ps, KV, hd) f32
        pid = bt[:, p]
        if kv_bits == 32:
            return pool[pid].to(torch.float32)
        return kv_page_dequantize(pool[pid], scales[pid], kv_bits=kv_bits,
                                  head_dim=hd)

    slabs = []
    for p in range(pages_per_seq):
        k = page(k_pages, k_scale, p)
        dots = torch.einsum("bkgd,bskd->bkgs", qb, k) * scale
        idx = p * page_size + torch.arange(page_size, device=q.device)
        valid = (idx[None, :] < ctx[:, None])[:, None, None, :]
        slabs.append(torch.where(valid, dots, -1e30))
    probs = torch.softmax(torch.cat(slabs, dim=-1), dim=-1)
    acc = torch.zeros((bsz, num_kv, groups, hd), dtype=torch.float32,
                      device=q.device)
    for p in range(pages_per_seq):
        v = page(v_pages, v_scale, p)
        pg = probs[..., p * page_size:(p + 1) * page_size]
        acc = acc + torch.einsum("bkgs,bskd->bkgd", pg, v)
    return acc.reshape(bsz, h, hd)


def paged_attention_online_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                               *, k_scale=None, v_scale=None,
                               kv_bits: int = 32) -> torch.Tensor:
    """The online-softmax variant's contract: :func:`paged_attention_ref`
    where ctx > 0 and zeros where ctx = 0 (an inactive slot attends to
    nothing). It agrees with the one-shot version to float tolerance, not
    bit for bit, on the card (the kernel rescales its running sums)."""
    out = paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                              k_scale=k_scale, v_scale=v_scale,
                              kv_bits=kv_bits)
    return torch.where((ctx_lens > 0)[:, None, None], out, 0.0)


# ------------------------------------------------------------ sLSTM cell --
def slstm_cell_ref(wx: torch.Tensor, r_w: torch.Tensor, fbias: torch.Tensor,
                   c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                   h0: torch.Tensor):
    """The stabilized sLSTM recurrence over a whole sequence, one step at
    a time (the kernel's contract, as the JAX package's
    ``ref.slstm_cell_ref``).

    wx (B, S, H, 4dh) input projections in the activation dtype (gates in
    the order i, f, z, o); r_w (H, dh, 4dh) float32 recurrent weights;
    fbias (H, dh) float32; c0, n0, m0, h0 (B, H, dh) float32. Each step:
    ``pre = wx_t + h R``, ``log_f = logsigmoid(f + fbias)``,
    ``m' = max(log_f + m, i)``, ``c' = e^(log_f + m - m') c +
    e^(i - m') tanh(z)``, ``n' = max(e^(log_f + m - m') n + e^(i - m'),
    1e-6)``, ``h' = sigmoid(o) c' / n'``. Returns (hs (B, S, H, dh)
    float32, (c, n, m, h) final). ``m0`` may be -1e30 (a fresh state) or
    any finite value (a paged slot admits with 0)."""
    dh = r_w.shape[1]
    r32 = r_w.to(torch.float32)
    fb = fbias.to(torch.float32)[None]
    c, n, m, h = (t.to(torch.float32) for t in (c0, n0, m0, h0))
    hs = []
    for t in range(wx.shape[1]):
        rec = torch.einsum("bhk,hkf->bhf", h, r32)
        pre = wx[:, t].to(torch.float32) + rec
        i_pre, f_pre, z_pre, o_pre = torch.split(pre, dh, dim=-1)
        log_f = torch.nn.functional.logsigmoid(f_pre + fb)
        m_new = torch.maximum(log_f + m, i_pre)
        i_sc = torch.exp(i_pre - m_new)
        f_sc = torch.exp(log_f + m - m_new)
        c = f_sc * c + i_sc * torch.tanh(z_pre)
        n = torch.clamp_min(f_sc * n + i_sc, 1e-6)
        h = torch.sigmoid(o_pre) * c / n
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)
