"""Launch wrapper of the CUDA paged-attention decode kernel
(csrc/paged_attention.cu): one split decode with two contracts, the
one-shot one (the port of ``repro.kernels.paged_attention.
paged_attention_decode``: the uniform average of V where ctx = 0) and the
online one (``paged_attention_decode_online``: zeros where ctx = 0). Both
split a sequence's slots over blocks of ``SPLIT_ROWS`` slots and combine
their partial softmax results in the same launch.

It takes CUDA tensors only; ``kernels.ops.paged_attention_decode`` is the
entry point the attention layer calls (it picks the contract, counts
launches and sends CPU tensors to the plain versions in ``kernels.ref``).
The kernel's shared memory is :func:`online_smem_bytes`;
:func:`oneshot_smem_bytes`, the first one-shot design's footprint, is what
``ops`` still compares with its threshold to pick the contract. The float32
workspace and ticket counters are kept per device across calls (the kernel
leaves the counters at 0), so calls on one device run in stream order.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

# shared memory one block may use on Hopper (sm_90): 227 KB
SMEM_PER_BLOCK = 232448
THREADS = 256
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# 64-slot tiles, 8 rows of each per warp of 8, a 3-stage cp.async ring; at
# most 8 query heads per block (a KV head with more takes several blocks);
# the head dims it is built for. SPLIT_ROWS slots per block (a multiple of
# TILE), chosen on the card (PERF.md, chip_smoke.time_split_rows): from 64,
# 128, 256 and 512 at the long request's table (online) and from 64, 128 and
# 256 at the main stream's (one-shot); 128 was fastest at both.
TILE = 64
WARPS = THREADS // 32
STAGES = 3
MAX_GROUPS = 8
HEAD_DIMS = (32, 64)
SPLIT_ROWS = 128
_levels: Dict[Tuple[int, torch.device], float] = {}
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_SCALES: Dict[int, float] = {}           # 1 / sqrt(hd) in float32, per hd
_decode = None


def _fn():
    """The library's C entry, with its argument types set (resolved
    once)."""
    global _decode
    if _decode is None:
        fn = build.load("paged_attention").paged_decode_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _decode = fn
    return _decode


def oneshot_smem_bytes(groups: int, head_dim: int, pages_per_seq: int,
                       page_size: int) -> int:
    """Shared memory of the first one-shot design (one block per (sequence,
    KV head)): q (G, hd), the logits slab (G, P·ps) and one tile of whole
    pages (64 rows at ps <= 64) padded to hd + 1, all float32. The kernel
    now runs in :func:`online_smem_bytes`; ``ops`` keeps this measure for
    its one-shot/online switch, so that the routes do not move."""
    tile = page_size * max(1, 64 // page_size)
    return 4 * (groups * head_dim + groups * pages_per_seq * page_size
                + tile * (head_dim + 1))


def online_smem_bytes(head_dim: int, row_bytes: int, splits: int) -> int:
    """Dynamic shared memory of the split kernel (both contracts): the ring
    of ``STAGES`` stages (a tile of raw K and V rows of ``row_bytes`` each
    and their float32 ranges), each warp's (G, 8) probabilities and 2 x 8
    step sizes, the warps' (acc, m, l) for the merge, a 16-byte flag and the
    combine's (m, l) table of ``splits`` x G entries. Only the table grows
    with the table width (64 bytes a split). ``ops`` picks the contract
    with :func:`oneshot_smem_bytes`, not with this."""
    ring = STAGES * (2 * TILE * row_bytes + 2 * TILE * 4)
    rows = TILE // WARPS
    floats = (WARPS * MAX_GROUPS * rows + WARPS * 2 * rows
              + WARPS * MAX_GROUPS * (head_dim + 2))
    table = 2 * splits * MAX_GROUPS + MAX_GROUPS
    return ring + 4 * floats + 16 + 4 * table


def split_count(pages_per_seq: int, page_size: int, split_rows: int) -> int:
    """Blocks per (sequence, KV head) of the split kernel: the table's
    slots in splits of ``split_rows``, from the table width alone."""
    return -(-pages_per_seq * page_size // split_rows)


def online_workspace_shape(batch: int, num_kv: int, splits: int,
                           groups: int, head_dim: int) -> Tuple[int, ...]:
    """The split kernel's float32 partials: per (sequence, KV head,
    split, query head) the unnormalized accumulator (hd), the max m and
    the normalizer l."""
    return (batch, num_kv, splits, groups, head_dim + 2)


def _scratch_on(device: torch.device, ws_elems: int, tickets: int):
    """This device's workspace and ticket counters, grown (counters
    zeroed) when a call needs more."""
    have = _scratch.get(device)
    if have is None or have[0].numel() < ws_elems \
            or have[1].numel() < tickets:
        ws = torch.empty(max(ws_elems, have[0].numel() if have else 0),
                         dtype=torch.float32, device=device)
        cnt = torch.zeros(max(tickets, have[1].numel() if have else 0),
                          dtype=torch.int32, device=device)
        have = _scratch[device] = (ws, cnt)
    return have


def _levels_on(kv_bits: int, device: torch.device) -> float:
    """``2^b - 1`` as the plain codec evaluates it on this device (read
    once per width and device)."""
    key = (kv_bits, device)
    if key not in _levels:
        _levels[key] = float(ref.kv_page_levels(kv_bits, device).item())
    return _levels[key]


def _check(name: str, x: torch.Tensor, shape, dtype, index: int) -> None:
    """``x`` is a contiguous ``dtype`` tensor of ``shape`` on CUDA device
    ``index`` (cheap attribute reads: this runs on every decode call)."""
    if (x.dtype != dtype or x.get_device() != index
            or not x.is_contiguous()):
        raise ValueError(f"paged_attention: {name} must be a contiguous "
                         f"{dtype} tensor on cuda:{index}, got {x.dtype} on "
                         f"{x.device}")
    if x.shape != shape:
        raise ValueError(f"paged_attention: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         ctx_lens: torch.Tensor, *, online: bool,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         kv_bits: int = 32) -> torch.Tensor:
    """Launch the split kernel on the current stream under the one-shot
    (``online=False``, the contract of ``ref.paged_attention_ref``) or
    online contract (``ref.paged_attention_online_ref``: zeros where
    ctx = 0); returns the (B, H, hd) float32 output. One launch of
    ``split_count`` blocks per (sequence, KV head, 8 query heads). The
    kernel clamps the table's ids into the pool."""
    if q.dim() != 3 or not q.is_cuda:
        raise ValueError(f"paged_attention: q must be a CUDA (B, H, hd) "
                         f"tensor, got {tuple(q.shape)} on {q.device}")
    dev, index = q.device, q.get_device()
    bsz, heads, hd = q.shape
    if k_pages.dim() != 4:
        raise ValueError("paged_attention: pools must be (num_pages, ps, "
                         "KV, hd_store)")
    num_pages, ps, num_kv, hd_store = k_pages.shape
    pages_per_seq = block_tables.shape[-1]
    if heads % num_kv:
        raise ValueError(f"paged_attention: {heads} heads do not split "
                         f"over {num_kv} KV heads")
    groups = heads // num_kv
    if kv_bits == 32:
        if k_pages.dtype not in _KINDS or k_scale is not None \
                or v_scale is not None:
            raise ValueError("paged_attention: kv_bits=32 takes float32 or "
                             "bfloat16 pools and no scales")
        kind, pool_dtype, want_store = _KINDS[k_pages.dtype], k_pages.dtype, hd
    elif kv_bits in (8, 4):
        if k_scale is None or v_scale is None:
            raise ValueError("paged_attention: code pools need k_scale and "
                             "v_scale")
        kind = 2 if kv_bits == 8 else 3
        pool_dtype = torch.uint8
        want_store = hd if kv_bits == 8 else hd // 2
    else:
        raise ValueError(f"paged_attention: kv_bits must be 32, 8 or 4, "
                         f"got {kv_bits}")
    pool_shape = (num_pages, ps, num_kv, want_store)
    _check("q", q, (bsz, heads, hd), torch.float32, index)
    _check("k_pages", k_pages, pool_shape, pool_dtype, index)
    _check("v_pages", v_pages, pool_shape, pool_dtype, index)
    if kv_bits != 32:
        _check("k_scale", k_scale, pool_shape[:3], torch.float32, index)
        _check("v_scale", v_scale, pool_shape[:3], torch.float32, index)
    _check("block_tables", block_tables, (bsz, pages_per_seq), torch.int32,
           index)
    _check("ctx_lens", ctx_lens, (bsz,), torch.int32, index)
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: the kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    chunks = -(-groups // MAX_GROUPS)
    if bsz > 65535 or num_kv * chunks > 65535:
        raise ValueError(f"paged_attention: at most 65535 sequences and "
                         f"65535 (KV head, 8 query heads) blocks, got {bsz} "
                         f"and {num_kv * chunks}")
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages)):
        raise ValueError("paged_attention: pools must start on 16-byte "
                         "boundaries")
    levels = _levels_on(kv_bits, dev) if kv_bits != 32 else 1.0
    scale = _SCALES.get(hd)
    if scale is None:
        scale = _SCALES[hd] = 1.0 / float(np.sqrt(np.float32(hd)))
    splits = split_count(pages_per_seq, ps, SPLIT_ROWS)
    smem = online_smem_bytes(hd, want_store * k_pages.element_size(), splits)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"exceed the {SMEM_PER_BLOCK} a block may use")
    ws, tickets = _scratch_on(
        dev, math.prod(online_workspace_shape(bsz, num_kv, splits, groups,
                                              hd)),
        bsz * num_kv * chunks)
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = q.new_empty((bsz, heads, hd))
    err = _fn()(
        int(not online), kind, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), bsz, heads, num_kv, hd, ps,
        pages_per_seq, num_pages, SPLIT_ROWS, splits, levels, scale, smem,
        stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
