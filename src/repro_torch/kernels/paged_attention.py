"""Launch wrappers of the CUDA paged-attention decode kernels
(csrc/paged_attention.cu): the one-shot softmax kernel (the port of
``repro.kernels.paged_attention.paged_attention_decode``) and the online
softmax kernel (``paged_attention_decode_online``).

They take CUDA tensors only; ``kernels.ops.paged_attention_decode`` is the
entry point the attention layer calls (it clamps the block table, picks
the variant, counts launches and sends CPU tensors to the plain version in
``kernels.ref``). The shared-memory layouts of both kernels are computed
here, and :func:`oneshot_smem_bytes` is what ``ops`` compares with its
threshold.
"""
from __future__ import annotations

import ctypes
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
_levels: Dict[Tuple[int, torch.device], float] = {}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_decode_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
    return lib


def tile_rows(page_size: int) -> int:
    """Rows (token slots) per tile: whole pages, 64 rows at ps <= 64."""
    return page_size * max(1, 64 // page_size)


def oneshot_smem_bytes(groups: int, head_dim: int, pages_per_seq: int,
                       page_size: int) -> int:
    """Dynamic shared memory of the one-shot kernel: q (G, hd), the logits
    slab (G, P·ps) and one padded K/V tile, all float32."""
    tr = tile_rows(page_size)
    return 4 * (groups * head_dim + groups * pages_per_seq * page_size
                + tr * (head_dim + 1))


def online_smem_bytes(groups: int, head_dim: int, page_size: int) -> int:
    """Dynamic shared memory of the online kernel: q, a K and a V tile,
    the (G, tile) probabilities and three (G,) carries; independent of the
    table width."""
    tr = tile_rows(page_size)
    return 4 * (groups * head_dim + 2 * tr * (head_dim + 1)
                + groups * tr + 3 * groups)


def _levels_on(kv_bits: int, device: torch.device) -> float:
    """``2^b - 1`` as the plain codec evaluates it on this device (read
    once per width and device)."""
    key = (kv_bits, device)
    if key not in _levels:
        _levels[key] = float(ref.kv_page_levels(kv_bits, device).item())
    return _levels[key]


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"paged_attention: {name} must be a contiguous "
                         f"{dtype} tensor on {device}, got {x.dtype} on "
                         f"{x.device}")
    if tuple(x.shape) != tuple(shape):
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
    as ``ref.paged_attention_ref`` (online: zeros where ctx = 0)."""
    if q.dim() != 3 or not q.is_cuda:
        raise ValueError(f"paged_attention: q must be a CUDA (B, H, hd) "
                         f"tensor, got {tuple(q.shape)} on {q.device}")
    dev = q.device
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
    _check("q", q, (bsz, heads, hd), torch.float32, dev)
    _check("k_pages", k_pages, pool_shape, pool_dtype, dev)
    _check("v_pages", v_pages, pool_shape, pool_dtype, dev)
    if kv_bits != 32:
        _check("k_scale", k_scale, pool_shape[:3], torch.float32, dev)
        _check("v_scale", v_scale, pool_shape[:3], torch.float32, dev)
    _check("block_tables", block_tables, (bsz, pages_per_seq), torch.int32,
           dev)
    _check("ctx_lens", ctx_lens, (bsz,), torch.int32, dev)
    row_bytes = want_store * k_pages.element_size()
    epv = _ELEMS_PER_VEC[kind]
    if row_bytes % 16 or hd % epv or (hd // epv) > 32:
        raise ValueError(f"paged_attention: head_dim {hd} does not split "
                         f"into 16-byte vectors of this pool type")
    if groups * hd > THREADS * MAX_OUT_PER_THREAD:
        raise ValueError(f"paged_attention: G*hd = {groups * hd} exceeds "
                         f"{THREADS * MAX_OUT_PER_THREAD}")
    if bsz > 65535:
        raise ValueError(f"paged_attention: at most 65535 sequences, got "
                         f"{bsz}")
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages)):
        raise ValueError("paged_attention: pools must start on 16-byte "
                         "boundaries")
    smem = (online_smem_bytes(groups, hd, ps) if online
            else oneshot_smem_bytes(groups, hd, pages_per_seq, ps))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"exceed the {SMEM_PER_BLOCK} a block may use")
    levels = _levels_on(kv_bits, dev) if kv_bits != 32 else 1.0
    scale = 1.0 / float(np.sqrt(np.float32(hd)))
    out = torch.empty((bsz, heads, hd), dtype=torch.float32, device=dev)
    err = _lib().paged_attention_decode_f32(
        int(online), kind, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(), bsz,
        heads, num_kv, hd, ps, pages_per_seq, num_pages, row_bytes,
        tile_rows(ps), levels, scale, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
