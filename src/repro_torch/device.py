"""Device selection for the port's entry points.

The port runs on the CUDA card. The CPU is used only when a caller asks for
it by name (the tests do): there is no silent fall-back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is absent and the
    caller did not ask for ``"cpu"``.

    On CUDA this also pins float32 matrix products to full float32 (no
    TF32): the mix and the Gram matrices feed the exact local solve, and
    TF32 keeps only about three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
