"""Device selection for the port."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """Return ``device`` as a ``torch.device``. ``None`` means the card: the
    port runs on CUDA unless the caller asks for the CPU (``"cpu"``), and
    without a card ``None`` raises rather than fall back to the CPU.

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions: the
    blur and the IC_Angle moments are float32 math, and cuDNN would otherwise
    run them in TF32 (about three decimal digits).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
