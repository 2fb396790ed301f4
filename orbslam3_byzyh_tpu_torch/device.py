"""Device selection for the port."""

from __future__ import annotations

import numpy as np
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


def upload(a, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor of its own on ``device``, in one copy. On
    CUDA the copy goes from page-locked memory and does not wait for the
    stream (a copy from pageable memory synchronises); the caching host
    allocator keeps the page-locked block until the copy has run. A tensor
    already on ``device`` (an image the prefetcher decoded there) passes
    through as it is."""
    if isinstance(a, torch.Tensor):
        if a.device == device or (a.device.type == device.type == "cuda"
                                  and device.index is None):
            return a
        a = a.cpu().numpy()
    t = torch.from_numpy(np.array(a, order="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def read(*xs: torch.Tensor, dtype=torch.float32) -> list:
    """Each tensor's values as a numpy array of ``dtype`` (float32 holds the
    whole numbers of a map's ids and counts exactly), in one read from the
    device: the one synchronisation of the caller."""
    flat = torch.cat([x.reshape(-1).to(dtype) for x in xs]).cpu().numpy()
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(tuple(x.shape)))
        i += x.numel()
    return out
