"""Kernel P1: the PNG unfilter on the card (``csrc/png.cu``).

A port kernel for a host OpenCV function (``cv2.imread``'s libpng
unfilter and grey conversion), not for a TPU kernel: the card's machine
has no OpenCV. The host inflates the file (``io.png.inflate``); the
filtered scanlines go up as they are and P1 writes the (h, w) float32
image on the device, the grey conversion of RGB and the byte swap of
16-bit samples fused in. :func:`unfilter_plain` is the same function on
the host (``io.png``'s numpy unfilter): the CPU path and P1's oracle.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..io import png
from ..kernels._build import Kernel, check_cuda, ptr, stream_of

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("png", {
    # raw, height, width, bpp, mode, recon, out, stream
    "png_unfilter": [_P, _I, _I, _I, _I, _P, _P, _P],
})


def _inflated(raw, width, bpp, mode) -> png.Inflated:
    return png.Inflated("<tensor>", width, raw.shape[0], bpp, mode,
                        raw.numpy())


def unfilter_plain(raw, width: int, bpp: int, mode: int) -> torch.Tensor:
    """Plain version: ``raw`` (h, 1 + width * bpp) uint8 CPU tensor of
    filtered scanlines -> (h, width) float32 samples."""
    return torch.from_numpy(png.decode_plain(
        _inflated(raw.cpu(), width, bpp, mode)))


def unfilter_kernel(raw, width: int, bpp: int, mode: int) -> torch.Tensor:
    """P1 on the card: one block, one thread a row, a skewed wavefront (see
    ``csrc/png.cu``). ``raw``: contiguous CUDA uint8 (h, 1 + width * bpp)."""
    h = raw.shape[0]
    check_cuda("raw", raw, torch.uint8, (h, 1 + width * bpp))
    if mode not in (png.GREY8, png.GREY16, png.RGB8, png.RGBA8, png.GREYA8):
        raise ValueError(f"unknown conversion mode {mode}")
    out = torch.empty((h, width), dtype=torch.float32, device=raw.device)
    recon = torch.empty((h, width * bpp), dtype=torch.uint8,
                        device=raw.device)
    KERNEL.launch("png_unfilter", ptr(raw), h, width, bpp, mode, ptr(recon),
                  ptr(out), stream_of(raw))
    return out


def unfilter(raw, width: int, bpp: int, mode: int) -> torch.Tensor:
    """Filtered scanlines -> the (h, width) float32 image on ``raw``'s
    device."""
    if raw.device.type == "cpu":
        return unfilter_plain(raw, width, bpp, mode)
    return unfilter_kernel(raw, width, bpp, mode)


def bound_bytes(height: int, width: int, bpp: int) -> int:
    """The bytes P1 must move: the filtered scanlines read once, the float32
    image written once."""
    return height * (1 + width * bpp) + 4 * height * width
