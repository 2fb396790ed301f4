"""Device selection for the port."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` picks CUDA when a
    card is present, else the CPU.

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions: the
    blur and the IC_Angle moments are float32 math, and cuDNN would otherwise
    run them in TF32 (about three decimal digits).
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
