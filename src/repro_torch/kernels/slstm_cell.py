"""Launch wrapper of the CUDA ``slstm_cell`` kernel (csrc/slstm_cell.cu).

The port's counterpart of ``repro.kernels.slstm_cell.slstm_cell``: the
whole sLSTM recurrence of a sequence in one launch. It takes CUDA tensors
only; ``kernels.ops.slstm_cell`` is the entry point the serving path's
sLSTM forward calls. ``wx`` may be bfloat16 or float32 and is converted to
float32 inside the kernel, not in a separate pass.

The kernel runs one thread-block cluster per (head, tile of batch rows):
:func:`cluster_size` CTAs, each holding a slice of R on chip for the whole
sequence. :func:`rows_per_cluster` picks the tile from what the card can
hold at once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

# shared memory one block may use on Hopper (sm_90): 227 KB
SMEM_PER_BLOCK = 232448
MAX_HEAD_DIM = 256
MAX_ROWS = 8                      # batch rows per cluster
ROW_CHOICES = (1, 2, 4, 8)
# (largest dh, CTAs per cluster): a CTA owns ceil(dh / C) <= 64 hidden units
# (16 threads each, at most 1024) and holds 16 ceil(dh / 64) floats of R per
# thread: 16 up to dh 64, 32 at 128 (1024 threads), 48 at 192 (768), 64 at
# 256 (512)
_CLUSTERS = ((64, 1), (128, 2), (192, 4), (256, 8))
_max_clusters: Dict[Tuple, int] = {}
_fn = None


def cluster_size(dh: int) -> int:
    """CTAs per cluster for head width ``dh``: 1 up to 64, 2 up to 128, 4
    up to 192, 8 up to 256. R's slice of one CTA, dh x 4dh float32 / C,
    fits the 227 KB a block may use at each."""
    for top, c in _CLUSTERS:
        if dh <= top:
            return c
    raise ValueError(f"slstm_cell: head width at most {MAX_HEAD_DIM}, got "
                     f"{dh}")


def rows_per_cluster(batch: int, heads: int, max_clusters: int) -> int:
    """Batch rows a cluster takes: the fewest of ``ROW_CHOICES`` whose
    clusters, ceil(batch / rows) per head, all run at once (each row then
    costs its cluster a step's work); all ``MAX_ROWS`` where even that is
    too many."""
    for rows in ROW_CHOICES:
        if -(-batch // rows) * heads <= max_clusters:
            return rows
    return MAX_ROWS


def _lib() -> ctypes.CDLL:
    global _fn
    lib = build.load("slstm_cell")
    if _fn is None:
        lib.slstm_cell_launch.restype = ctypes.c_int
        lib.slstm_cell_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.slstm_cell_max_clusters.restype = ctypes.c_int
        lib.slstm_cell_max_clusters.argtypes = [ctypes.c_int] * 5
        _fn = lib.slstm_cell_launch
    return lib


def max_clusters(device: torch.device, heads: int, dh: int, cluster: int,
                 wx_bf16: bool) -> int:
    """Clusters of this shape the card runs at once (asked once per
    device and shape)."""
    key = (device, heads, dh, cluster, wx_bf16)
    if key not in _max_clusters:
        with torch.cuda.device(device):
            n = _lib().slstm_cell_max_clusters(heads, dh, cluster, 1,
                                               int(wx_bf16))
        if n <= 0:
            raise RuntimeError(f"slstm_cell: no cluster of {cluster} CTAs "
                               f"fits the card at dh {dh}")
        _max_clusters[key] = n
    return _max_clusters[key]


def slstm_cell_cuda(wx: torch.Tensor, r_w: torch.Tensor, fbias: torch.Tensor,
                    c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                    h0: torch.Tensor, *, rows: Optional[int] = None):
    """sLSTM over a sequence on the current stream: wx (B, S, H, 4dh)
    bfloat16 or float32, r_w (H, dh, 4dh), fbias (H, dh) and the state
    c0, n0, m0, h0 (B, H, dh) float32, all contiguous on one card. Returns
    (hs (B, S, H, dh) float32, (c, n, m, h)), the contract of
    ``ref.slstm_cell_ref``. ``rows`` overrides :func:`rows_per_cluster`
    (1 to ``MAX_ROWS``)."""
    if not wx.is_cuda or wx.dim() != 4 or r_w.dim() != 3:
        raise ValueError(f"slstm_cell: needs a CUDA (B, S, H, 4dh) wx and "
                         f"(H, dh, 4dh) weights, got {tuple(wx.shape)}, "
                         f"{tuple(r_w.shape)} on {wx.device}")
    b, s, h, dh4 = wx.shape
    dh = r_w.shape[1]
    if tuple(r_w.shape) != (h, dh, 4 * dh) or dh4 != 4 * dh:
        raise ValueError(f"slstm_cell: wx {tuple(wx.shape)} does not match "
                         f"R {tuple(r_w.shape)}")
    if wx.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"slstm_cell: wx must be bfloat16 or float32, got "
                         f"{wx.dtype}")
    shapes = {"r_w": (h, dh, 4 * dh), "fbias": (h, dh), "c0": (b, h, dh),
              "n0": (b, h, dh), "m0": (b, h, dh), "h0": (b, h, dh)}
    args = {"r_w": r_w, "fbias": fbias, "c0": c0, "n0": n0, "m0": m0,
            "h0": h0}
    if not wx.is_contiguous():
        raise ValueError("slstm_cell: wx must be contiguous")
    for name, x in args.items():
        if (x.device != wx.device or x.dtype != torch.float32
                or tuple(x.shape) != shapes[name] or not x.is_contiguous()):
            raise ValueError(f"slstm_cell: {name} must be a contiguous "
                             f"float32 {shapes[name]} tensor on {wx.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    cluster = cluster_size(dh)
    bf16 = wx.dtype == torch.bfloat16
    if rows is None:
        rows = rows_per_cluster(b, h, max_clusters(wx.device, h, dh,
                                                   cluster, bf16))
    hs = torch.empty((b, s, h, dh), dtype=torch.float32, device=wx.device)
    state = [torch.empty((b, h, dh), dtype=torch.float32, device=wx.device)
             for _ in range(4)]
    _lib()
    err = _fn(wx.data_ptr(), int(bf16), r_w.data_ptr(), fbias.data_ptr(),
              c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), h0.data_ptr(),
              hs.data_ptr(), *(x.data_ptr() for x in state), b, s, h, dh,
              cluster, rows,
              torch._C._cuda_getCurrentRawStream(wx.get_device()))
    if err != 0:
        raise RuntimeError(f"slstm_cell launch failed: CUDA error {err}")
    return hs, tuple(state)
