"""Kernel K1: steered-BRIEF sampling and bit packing for all pyramid levels.

Replaces ``orbslam3_byzyh_tpu/ops/pallas_brief.py::brief_sample`` and the
compare-and-pack that follows it in ``fast_orb.extract``. The CUDA source is
``csrc/brief.cu``; :func:`brief_descriptors_plain` is the same function in
plain PyTorch (pattern positions + one gather + ``_pack_bits``).

Both take the blurred levels as a list of (h, w) tensors, as ``extract``
holds them: the kernel reads each level where it lies, so no concatenated
copy of the pyramid is made for it.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels._build import Kernel, check_cuda, ptr, stream_of
from . import fast_orb

MAX_LEVELS = 16


class _LevelTable(ctypes.Structure):
    """Passed by value: base pointer, height and width of each level."""

    _fields_ = [("base", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS)]


_P = ctypes.c_void_p
KERNEL = Kernel("brief", {
    # levels, kp_level, xy, angle, pattern, k, out, stream
    "brief_descriptors": [_LevelTable, _P, _P, _P, _P, ctypes.c_int, _P, _P],
    # angle, n, sin_out, cos_out, stream
    "brief_sincos": [_P, ctypes.c_int, _P, _P, _P],
})


def brief_descriptors_plain(blurred, xy, kp_level, angle):
    """Plain PyTorch version: (K, 8) int32 descriptor words."""
    dev = xy.device
    sizes = [b.numel() for b in blurred]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    table = torch.tensor([[o, b.shape[0], b.shape[1]]
                          for o, b in zip(offsets, blurred)],
                         dtype=torch.int64, device=dev)[kp_level.long()]
    off, h, w = table[:, 0:1], table[:, 1:2], table[:, 2:3]
    gy, gx = fast_orb._pattern_positions(xy, torch.cos(angle),
                                         torch.sin(angle), w.float(),
                                         h.float())
    flat = torch.cat([b.reshape(-1) for b in blurred])
    vals = flat[off + gy.long() * w + gx.long()]              # (K, 512)
    return fast_orb._pack_bits(vals[:, :256] < vals[:, 256:])


def brief_descriptors_kernel(blurred, xy, kp_level, angle):
    """K1 on the card: a block of 4 warps per keypoint, two point pairs a
    thread, all levels in one launch. Every input is a contiguous CUDA tensor
    that the kernel reads where it lies (levels float32 (h, w); xy float32
    (K, 2), 8-byte aligned; kp_level int32; angle float32 radians), so a
    call is one launch beside the allocation of its output."""
    k, n = xy.shape[0], len(blurred)
    if n > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {n}")
    for i, b in enumerate(blurred):
        if not (isinstance(b, torch.Tensor) and b.is_cuda
                and b.dtype == torch.float32 and b.dim() == 2
                and b.is_contiguous()):
            check_cuda(f"blurred[{i}]", b, torch.float32)
            raise ValueError(f"blurred[{i}]: expected (h, w), got "
                             f"{tuple(b.shape)}")
    table = _LevelTable()
    table.base[:n] = [b.data_ptr() for b in blurred]
    table.h[:n] = [b.shape[0] for b in blurred]
    table.w[:n] = [b.shape[1] for b in blurred]
    check_cuda("xy", xy, torch.float32, (k, 2))
    if xy.data_ptr() % 8:
        raise ValueError("xy: expected 8-byte aligned rows")
    check_cuda("kp_level", kp_level, torch.int32, (k,))
    check_cuda("angle", angle, torch.float32, (k,))
    out = torch.empty((k, 8), dtype=torch.int32, device=xy.device)
    if k == 0:
        return out
    pattern = fast_orb._constants(xy.device)["pattern"]
    KERNEL.launch("brief_descriptors", table, ptr(kp_level), ptr(xy),
                  ptr(angle), ptr(pattern), k, ptr(out), stream_of(xy))
    return out


def sincos_on_card(angle):
    """(sin, cos) of a CUDA float32 tensor by the kernel's own sincosf, for
    holding it against torch.sin / torch.cos. Not a K1 launch: it is not
    counted."""
    check_cuda("angle", angle, torch.float32)
    s, c = torch.empty_like(angle), torch.empty_like(angle)
    err = KERNEL.build().brief_sincos(ptr(angle), angle.numel(), ptr(s),
                                      ptr(c), stream_of(angle))
    if err != 0:
        raise RuntimeError(f"brief_sincos failed: CUDA error {err}")
    return s, c


def brief_descriptors(blurred, xy, kp_level, angle):
    """Steered-BRIEF descriptors of keypoints on several pyramid levels.

    blurred: [(h, w) float32] the blurred levels; xy: (K, 2) level-local
    keypoint coords; kp_level: (K,) int32 index into ``blurred``; angle:
    (K,) radians. Returns (K, 8) int32 words.
    """
    if xy.device.type == "cpu":
        return brief_descriptors_plain(blurred, xy, kp_level, angle)
    return brief_descriptors_kernel(blurred, xy, kp_level, angle)
