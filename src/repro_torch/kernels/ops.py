"""The kernels' entry points: the plain version for a CPU tensor, the CUDA
kernel for a CUDA tensor. There is no fall-back: a CUDA tensor that the
kernel does not take raises, and so does a failed build or launch.

``launches`` counts kernel calls by name, one per call (the tiled fused
round is two CUDA launches and counts once). It is bumped only where a
kernel is launched (never on the CPU path), so a run can show that the main
path went through the kernels: set the counts to 0 before the run and read
them after. Every wrapper also bumps the ``kernel_dispatch`` counter of
``obs.metrics`` with the JAX package's ``(kernel, variant)`` labels, on the
CPU as well: which variant the call selected, not whether a kernel ran.

Storage types: ``bipartite_mix`` takes values in float32, bf16 or f16 and
returns their dtype, ``edge_gather_mix`` reads them as stored and returns
float32, and the fused grouped round takes ``q_hat_prev`` in any of the
three and returns ``out`` in it (the engine's narrowed replicas,
``hat_dtype``). The other quantize kernels take float32: the tiled fused
round widens a narrowed ``q_hat_prev`` before its kernel and rounds
``out`` back after, as the JAX engine's casts do.

The grouped entry points take the JAX package's arguments plus the
packing's ``group_runs`` (per group, its ``(offset, size)`` column runs):
the CUDA kernels read the runs, the plain versions the ``(D,)``
``group_ids`` map, which may be None (it is then built from the runs).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from repro_torch.core.packing import runs_to_col_ids
from repro_torch.kernels import ref
from repro_torch.kernels.bipartite_mix import bipartite_mix_cuda
from repro_torch.kernels.edge_gather_mix import edge_gather_mix_cuda
from repro_torch.kernels.paged_attention import (
    SMEM_PER_BLOCK, oneshot_smem_bytes, paged_attention_cuda)
from repro_torch.kernels.grouped_quant import (
    stoch_quantize_grouped_cuda, stoch_quantize_grouped_fused_cuda,
    stoch_quantize_grouped_fused_tiled_cuda)
from repro_torch.kernels.slstm_cell import slstm_cell_cuda
from repro_torch.kernels.stoch_quant import stoch_quantize_cuda
from repro_torch.obs.metrics import kernel_dispatch_counter

KERNELS = ("stoch_quantize", "bipartite_mix", "stoch_quantize_grouped",
           "stoch_quantize_grouped_fused",
           "stoch_quantize_grouped_fused_tiled", "paged_attention_decode",
           "paged_attention_decode_online", "edge_gather_mix", "slstm_cell")
launches: Dict[str, int] = {k: 0 for k in KERNELS}
# each entry point's (kernel, variant) labels of ``kernel_dispatch``, the
# JAX package's
LABELS = {
    "stoch_quantize": ("stoch_quantize", "flat"),
    "bipartite_mix": ("bipartite_mix", "dense"),
    "stoch_quantize_grouped": ("stoch_quantize", "grouped"),
    "stoch_quantize_grouped_fused": ("stoch_quantize_fused", "slab"),
    "stoch_quantize_grouped_fused_tiled": ("stoch_quantize_fused", "tiled"),
    "paged_attention_decode": ("paged_attention_decode", "oneshot"),
    "paged_attention_decode_online": ("paged_attention_decode", "online"),
    "edge_gather_mix": ("edge_gather_mix", "sparse"),
    "slstm_cell": ("slstm_cell", "fused"),
}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def _count(name: str) -> None:
    kernel, variant = LABELS[name]
    kernel_dispatch_counter().inc(kernel=kernel, variant=variant)


def calls() -> Dict[str, int]:
    """Wrapper calls so far by kernel name, read from ``kernel_dispatch``
    (on the CPU too, where each is a call of the plain version; on the card
    each is one of ``launches``). A run's calls are the difference of two
    reads."""
    c = kernel_dispatch_counter()
    return {k: int(c.value(kernel=kv[0], variant=kv[1]))
            for k, kv in LABELS.items()}


def stoch_quantize(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                   uniforms: torch.Tensor, delta: torch.Tensor,
                   qrange: torch.Tensor) -> torch.Tensor:
    """Fused quantize -> dequantize, Eqs. 14-20 (see ``ref``)."""
    _count("stoch_quantize")
    if theta.is_cpu:
        return ref.stoch_quantize_ref(theta, q_hat_prev, uniforms, delta,
                                      qrange)
    out = stoch_quantize_cuda(theta, q_hat_prev, uniforms, delta, qrange)
    launches["stoch_quantize"] += 1
    return out


def bipartite_mix(adjacency: torch.Tensor, values: torch.Tensor
                  ) -> torch.Tensor:
    """Neighbour sum ``A @ V`` in the values' dtype, float32 accumulation
    (see ``ref``)."""
    _count("bipartite_mix")
    if values.is_cpu:
        return ref.bipartite_mix_ref(adjacency, values)
    out = bipartite_mix_cuda(adjacency, values)
    launches["bipartite_mix"] += 1
    return out


def edge_gather_mix(values: torch.Tensor, nbr_table: torch.Tensor,
                    nbr_valid: torch.Tensor) -> torch.Tensor:
    """Neighbour sum over the degree-padded CSR table, float32 out (see
    ``ref.edge_gather_mix_ref``). The kernel reads float32, bf16 and f16
    values as stored; values of another dtype are cast to float32 first,
    as the JAX kernel casts every dtype."""
    _count("edge_gather_mix")
    if values.is_cpu:
        return ref.edge_gather_mix_ref(values, nbr_table, nbr_valid)
    if values.dtype not in (torch.float32,) + ref.NARROW:
        values = values.to(torch.float32)
    values = values.contiguous()
    out = edge_gather_mix_cuda(values, nbr_table, nbr_valid)
    launches["edge_gather_mix"] += 1
    return out


def slstm_cell(wx: torch.Tensor, r_w: torch.Tensor, fbias: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
               h0: torch.Tensor):
    """The sLSTM recurrence over a whole sequence: wx (B, S, H, 4dh) in the
    activation dtype, R (H, dh, 4dh), fbias (H, dh), state (B, H, dh) ->
    (hs (B, S, H, dh) float32, (c, n, m, h)) (see ``ref.slstm_cell_ref``).
    The inputs go to the kernel as they are: it reads bf16 or float32
    ``wx`` and raises on anything else, or on a non-contiguous tensor."""
    _count("slstm_cell")
    if wx.device.type == "cpu":
        return ref.slstm_cell_ref(wx, r_w, fbias, c0, n0, m0, h0)
    out = slstm_cell_cuda(wx, r_w, fbias, c0, n0, m0, h0)
    launches["slstm_cell"] += 1
    return out


def _col_ids(group_ids: Optional[torch.Tensor], group_runs, dim: int,
             device) -> torch.Tensor:
    """The (D,) column -> group map the plain versions take."""
    if group_ids is not None:
        return group_ids
    return torch.from_numpy(runs_to_col_ids(group_runs, dim)).to(device)


def stoch_quantize_grouped(theta: torch.Tensor, q_hat_prev: torch.Tensor,
                           uniforms: torch.Tensor, delta: torch.Tensor,
                           qrange: torch.Tensor,
                           group_ids: Optional[torch.Tensor], *,
                           group_runs) -> torch.Tensor:
    """Grouped quantize -> dequantize with given (N, G) Δ and R (see
    ``ref.stoch_quantize_grouped_ref``)."""
    _count("stoch_quantize_grouped")
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_ref(
            theta, q_hat_prev, uniforms, delta, qrange,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device))
    out = stoch_quantize_grouped_cuda(theta, q_hat_prev, uniforms, delta,
                                      qrange, group_runs)
    launches["stoch_quantize_grouped"] += 1
    return out


def stoch_quantize_grouped_fused(theta, q_hat_prev, uniforms, bits_prev,
                                 range_prev, initialized, group_ids, *,
                                 group_runs, omega: float, b0: int,
                                 b_max: int):
    """One grouped round with the range reduction folded in (see
    ``ref.stoch_quantize_grouped_fused_ref``). ``REPRO_QUANT_TILE_D=<n>``
    (n > 0) routes it through the D-tiled kernel with n-column tiles, as
    the JAX package's ``ops.stoch_quantize_grouped_fused`` does."""
    tile_d = int(os.environ.get("REPRO_QUANT_TILE_D", "0"))
    if tile_d > 0:
        return stoch_quantize_grouped_fused_tiled(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            group_ids, group_runs=group_runs, omega=omega, b0=b0,
            b_max=b_max, block_d=tile_d)
    _count("stoch_quantize_grouped_fused")
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_fused_ref(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device),
            group_runs=group_runs, omega=omega, b0=b0, b_max=b_max)
    out = stoch_quantize_grouped_fused_cuda(
        theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
        group_runs, omega, b0, b_max)
    launches["stoch_quantize_grouped_fused"] += 1
    return out


def stoch_quantize_grouped_fused_tiled(theta, q_hat_prev, uniforms,
                                       bits_prev, range_prev, initialized,
                                       group_ids, *, group_runs,
                                       omega: float, b0: int, b_max: int,
                                       block_d: int = 512):
    """The D-tiled twin of :func:`stoch_quantize_grouped_fused`, with the
    same outputs bit for bit. Its kernel takes float32 operands: a narrowed
    ``q_hat_prev`` is widened before it and ``out`` rounded back after."""
    _count("stoch_quantize_grouped_fused_tiled")
    if theta.device.type == "cpu":
        return ref.stoch_quantize_grouped_fused_ref(
            theta, q_hat_prev, uniforms, bits_prev, range_prev, initialized,
            _col_ids(group_ids, group_runs, theta.shape[1], theta.device),
            group_runs=group_runs, omega=omega, b0=b0, b_max=b_max)
    store = q_hat_prev.dtype
    out = stoch_quantize_grouped_fused_tiled_cuda(
        theta, q_hat_prev.to(torch.float32), uniforms, bits_prev, range_prev,
        initialized, group_runs, omega, b0, b_max, block_d)
    launches["stoch_quantize_grouped_fused_tiled"] += 1
    return (out[0].to(store),) + tuple(out[1:])


# The one-shot contract's first kernel kept its (G, P·ps) float32 logits
# slab in shared memory, next to q and one K/V tile (``oneshot_smem_bytes``).
# A Hopper block may use at most 227 KB. The one-shot contract runs while
# that footprint fits in half of it; past it the online contract takes over.
# Both now run in one split kernel whose footprint does not grow with the
# table, but the switch keeps the first design's measure so that the routes
# stay where they were. At tinyllama's G = 8, hd = 64, ps = 16 it falls
# between 190 and 191 pages per sequence (3,040 and 3,056 table slots): a
# 1,024-slot table takes the one-shot contract (51,456 bytes), a 4,096-slot
# table the online one (149,760).
ONESHOT_SMEM_LIMIT = SMEM_PER_BLOCK // 2


def paged_attention_online_selected(heads: int, num_kv: int, head_dim: int,
                                    pages_per_seq: int,
                                    page_size: int) -> bool:
    """Which variant :func:`paged_attention_decode` takes for this shape:
    ``REPRO_PAGED_ATTN_ONLINE=1|0`` forces it, as in the JAX package;
    otherwise the one-shot kernel's shared-memory footprint decides."""
    force = os.environ.get("REPRO_PAGED_ATTN_ONLINE", "")
    if force in ("0", "1"):
        return force == "1"
    return oneshot_smem_bytes(heads // num_kv, head_dim, pages_per_seq,
                              page_size) > ONESHOT_SMEM_LIMIT


def paged_attention_decode(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           k_scale=None, v_scale=None, kv_bits: int = 32):
    """Single-token decode attention through the block table (see
    ``ref.paged_attention_ref``). Unmapped (-1) and out-of-range page ids
    are clamped into the pool, as the JAX package's wrapper does: here for
    the plain versions on the CPU, inside the kernel on the card (no extra
    launch); their slots are masked by ``ctx_lens``. q (B, H, hd) ->
    (B, H, hd) float32; ``kv_bits`` 8 or 4 reads code pools with their
    scales."""
    online = paged_attention_online_selected(
        q.shape[1], k_pages.shape[2], q.shape[2], block_tables.shape[1],
        k_pages.shape[1])
    _count("paged_attention_decode_online" if online
           else "paged_attention_decode")
    bt = block_tables.to(torch.int32)
    if q.device.type == "cpu":
        plain = (ref.paged_attention_online_ref if online
                 else ref.paged_attention_ref)
        bt = torch.clamp(bt, 0, k_pages.shape[0] - 1)
        return plain(q, k_pages, v_pages, bt, ctx_lens, k_scale=k_scale,
                     v_scale=v_scale, kv_bits=kv_bits)
    out = paged_attention_cuda(
        q.to(torch.float32).contiguous(), k_pages, v_pages, bt.contiguous(),
        ctx_lens.to(torch.int32).contiguous(), online=online,
        k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits)
    launches["paged_attention_decode_online" if online
             else "paged_attention_decode"] += 1
    return out
