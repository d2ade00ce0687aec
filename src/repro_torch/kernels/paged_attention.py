"""Launch wrappers of the CUDA paged-attention decode kernels
(csrc/paged_attention.cu): the one-shot softmax kernel (the port of
``repro.kernels.paged_attention.paged_attention_decode``) and the online
softmax kernel (``paged_attention_decode_online``), which splits each
sequence's slots over blocks of ``SPLIT_ROWS`` slots and combines their
partial softmax results in the same launch.

They take CUDA tensors only; ``kernels.ops.paged_attention_decode`` is the
entry point the attention layer calls (it clamps the block table, picks
the variant, counts launches and sends CPU tensors to the plain version in
``kernels.ref``). The shared-memory layouts of both kernels are computed
here, and :func:`oneshot_smem_bytes` is what ``ops`` compares with its
threshold. The online kernel's float32 workspace and ticket counters are
kept per device across calls (the kernel leaves the counters at 0), so
calls on one device run in stream order.
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
MAX_OUT_PER_THREAD = 4
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_ELEMS_PER_VEC = (4, 8, 16, 32)          # float32, bf16, 8-bit, 4-bit codes
# online kernel: 64-slot tiles, 8 rows of each per warp of 8, a 3-stage
# cp.async ring; at most 8 query heads per KV head; the head dims it is
# built for. SPLIT_ROWS slots per block (a multiple of TILE), chosen on the
# card from 64, 128, 256 and 512 (PERF.md, chip_smoke.time_split_rows).
TILE = 64
WARPS = THREADS // 32
STAGES = 3
MAX_GROUPS = 8
ONLINE_HEAD_DIMS = (32, 64)
SPLIT_ROWS = 128
_levels: Dict[Tuple[int, torch.device], float] = {}
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_SCALES: Dict[int, float] = {}           # 1 / sqrt(hd) in float32, per hd
_fns: Dict[str, object] = {}


def _fn(name: str):
    """The C entry ``name`` of the library, with its argument types set
    (resolved once)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("paged_attention"), name)
        fn.restype = ctypes.c_int
        ptrs = 10 if name == "paged_online_f32" else 8
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * ptrs
                       + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _fns[name] = fn
    return fn


def tile_rows(page_size: int) -> int:
    """Rows (token slots) per one-shot tile: whole pages, 64 rows at ps
    <= 64."""
    return page_size * max(1, 64 // page_size)


def oneshot_smem_bytes(groups: int, head_dim: int, pages_per_seq: int,
                       page_size: int) -> int:
    """Dynamic shared memory of the one-shot kernel: q (G, hd), the logits
    slab (G, P·ps) and one padded K/V tile, all float32."""
    tr = tile_rows(page_size)
    return 4 * (groups * head_dim + groups * pages_per_seq * page_size
                + tr * (head_dim + 1))


def online_smem_bytes(head_dim: int, row_bytes: int, splits: int) -> int:
    """Dynamic shared memory of the online kernel: the ring of ``STAGES``
    stages (a tile of raw K and V rows of ``row_bytes`` each and their
    float32 ranges), each warp's (G, 8) probabilities and 2 x 8 step
    sizes, the warps' (acc, m, l) for the merge, a 16-byte flag and the
    combine's (m, l) table of ``splits`` x G entries. Only the table grows
    with the table width (64 bytes a split)."""
    ring = STAGES * (2 * TILE * row_bytes + 2 * TILE * 4)
    rows = TILE // WARPS
    floats = (WARPS * MAX_GROUPS * rows + WARPS * 2 * rows
              + WARPS * MAX_GROUPS * (head_dim + 2))
    table = 2 * splits * MAX_GROUPS + MAX_GROUPS
    return ring + 4 * floats + 16 + 4 * table


def split_count(pages_per_seq: int, page_size: int, split_rows: int) -> int:
    """Blocks per (sequence, KV head) of the online kernel: the table's
    slots in splits of ``split_rows``, from the table width alone."""
    return -(-pages_per_seq * page_size // split_rows)


def online_workspace_shape(batch: int, num_kv: int, splits: int,
                           groups: int, head_dim: int) -> Tuple[int, ...]:
    """The online kernel's float32 partials: per (sequence, KV head,
    split, query head) the unnormalized accumulator (hd), the max m and
    the normalizer l."""
    return (batch, num_kv, splits, groups, head_dim + 2)


def _online_scratch(device: torch.device, ws_elems: int, tickets: int):
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
    """Launch the one-shot (``online=False``) or online kernel on the
    current stream; returns the (B, H, hd) float32 output. Same contract
    as ``ref.paged_attention_ref`` (online: zeros where ctx = 0). The
    online kernel is one launch of ``split_count`` blocks per (sequence,
    KV head) of ``SPLIT_ROWS`` slots each."""
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
    row_bytes = want_store * k_pages.element_size()
    epv = _ELEMS_PER_VEC[kind]
    if row_bytes % 16 or hd % epv or (hd // epv) > 32:
        raise ValueError(f"paged_attention: head_dim {hd} does not split "
                         f"into 16-byte vectors of this pool type")
    if bsz > 65535:
        raise ValueError(f"paged_attention: at most 65535 sequences, got "
                         f"{bsz}")
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages)):
        raise ValueError("paged_attention: pools must start on 16-byte "
                         "boundaries")
    levels = _levels_on(kv_bits, dev) if kv_bits != 32 else 1.0
    scale = _SCALES.get(hd)
    if scale is None:
        scale = _SCALES[hd] = 1.0 / float(np.sqrt(np.float32(hd)))
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = q.new_empty((bsz, heads, hd))
    if online:
        split_rows = SPLIT_ROWS
        if hd not in ONLINE_HEAD_DIMS or groups > MAX_GROUPS:
            raise ValueError(
                f"paged_attention: the online kernel takes head_dim in "
                f"{ONLINE_HEAD_DIMS} and at most {MAX_GROUPS} query heads "
                f"per KV head; got {hd} and {groups}")
        splits = split_count(pages_per_seq, ps, split_rows)
        smem = online_smem_bytes(hd, row_bytes, splits)
        ws, tickets = _online_scratch(
            dev, math.prod(online_workspace_shape(bsz, num_kv, splits,
                                                  groups, hd)),
            bsz * num_kv)
    else:
        if groups * hd > THREADS * MAX_OUT_PER_THREAD:
            raise ValueError(f"paged_attention: G*hd = {groups * hd} exceeds"
                             f" {THREADS * MAX_OUT_PER_THREAD}")
        smem = oneshot_smem_bytes(groups, hd, pages_per_seq, ps)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"exceed the {SMEM_PER_BLOCK} a block may use")
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr())
    if online:
        err = _fn("paged_online_f32")(
            kind, *ptrs, ws.data_ptr(), tickets.data_ptr(), bsz, heads,
            num_kv, hd, ps, pages_per_seq, num_pages, split_rows, splits,
            levels, scale, smem, stream)
    else:
        err = _fn("paged_oneshot_f32")(
            kind, *ptrs, bsz, heads, num_kv, hd, ps, pages_per_seq,
            num_pages, row_bytes, tile_rows(ps), levels, scale, smem, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
