"""Launch wrapper of the CUDA ``slstm_cell`` kernel (csrc/slstm_cell.cu).

The port's counterpart of ``repro.kernels.slstm_cell.slstm_cell``: the
whole sLSTM recurrence of a sequence in one launch. It takes CUDA tensors
only; ``kernels.ops.slstm_cell`` is the entry point the serving path's
sLSTM forward calls. ``wx`` may be bfloat16 or float32 and is converted to
float32 inside the kernel, not in a separate pass.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _lib() -> ctypes.CDLL:
    lib = build.load("slstm_cell")
    fn = lib.slstm_cell_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        lib.slstm_cell_max_head_dim.restype = ctypes.c_int
        lib.slstm_cell_max_head_dim.argtypes = []
    return lib


def slstm_cell_cuda(wx: torch.Tensor, r_w: torch.Tensor, fbias: torch.Tensor,
                    c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                    h0: torch.Tensor):
    """sLSTM over a sequence on the current stream: wx (B, S, H, 4dh)
    bfloat16 or float32, r_w (H, dh, 4dh), fbias (H, dh) and the state
    c0, n0, m0, h0 (B, H, dh) float32, all contiguous on one card. Returns
    (hs (B, S, H, dh) float32, (c, n, m, h)), the contract of
    ``ref.slstm_cell_ref``."""
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
    lib = _lib()
    if dh > lib.slstm_cell_max_head_dim():
        raise ValueError(f"slstm_cell: head width at most "
                         f"{lib.slstm_cell_max_head_dim()}, got {dh}")
    hs = torch.empty((b, s, h, dh), dtype=torch.float32, device=wx.device)
    state = [torch.empty((b, h, dh), dtype=torch.float32, device=wx.device)
             for _ in range(4)]
    err = lib.slstm_cell_launch(
        wx.data_ptr(), int(wx.dtype == torch.bfloat16), r_w.data_ptr(),
        fbias.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        h0.data_ptr(), hs.data_ptr(), *(x.data_ptr() for x in state), b, s,
        h, dh, torch.cuda.current_stream(wx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_cell launch failed: CUDA error {err}")
    return hs, tuple(state)
