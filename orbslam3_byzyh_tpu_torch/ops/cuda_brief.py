"""Kernel K1: steered-BRIEF sampling and bit packing for all pyramid levels.

Replaces ``orbslam3_byzyh_tpu/ops/pallas_brief.py::brief_sample`` and the
compare-and-pack that follows it in ``fast_orb.extract``. The CUDA source is
``csrc/brief.cu``; :func:`brief_descriptors_plain` is the same function in
plain PyTorch (pattern positions + one gather + ``_pack_bits``).

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels._build import Kernel, check_cuda, ptr, stream_of
from . import fast_orb

MAX_LEVELS = 16


class _LevelTable(ctypes.Structure):
    """Passed by value: element offset, height and width of each level
    inside the concatenated blurred-pyramid buffer."""

    _fields_ = [("offset", ctypes.c_int * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS)]


_P = ctypes.c_void_p
KERNEL = Kernel("brief", {
    # img, levels, kp_level, xy, ca, sa, pattern, k, out, stream
    "brief_descriptors": [_P, _LevelTable, _P, _P, _P, _P, _P, ctypes.c_int,
                          _P, _P],
})


def _offsets(shapes):
    out, acc = [], 0
    for h, w in shapes:
        out.append(acc)
        acc += h * w
    return out, acc


def brief_descriptors_plain(blurred, shapes, xy, kp_level, ca, sa):
    """Plain PyTorch version: (K, 8) int32 descriptor words."""
    offsets, _ = _offsets(shapes)
    dev = blurred.device
    table = torch.tensor([[o, h, w] for o, (h, w) in zip(offsets, shapes)],
                         dtype=torch.int64, device=dev)[kp_level.long()]
    off, h, w = table[:, 0:1], table[:, 1:2], table[:, 2:3]
    gy, gx = fast_orb._pattern_positions(xy, ca, sa, w.float(), h.float())
    vals = blurred[off + gy.long() * w + gx.long()]          # (K, 512)
    return fast_orb._pack_bits(vals[:, :256] < vals[:, 256:])


def brief_descriptors_kernel(blurred, shapes, xy, kp_level, ca, sa):
    """K1 on the card: one warp per keypoint, all levels in one launch."""
    k = xy.shape[0]
    _, total = _offsets(shapes)
    if len(shapes) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(shapes)}")
    check_cuda("blurred", blurred, torch.float32, (total,))
    check_cuda("xy", xy, torch.float32, (k, 2))
    check_cuda("kp_level", kp_level, torch.int32, (k,))
    check_cuda("ca", ca, torch.float32, (k,))
    check_cuda("sa", sa, torch.float32, (k,))
    table = _LevelTable()
    for i, (o, (h, w)) in enumerate(zip(_offsets(shapes)[0], shapes)):
        table.offset[i], table.h[i], table.w[i] = o, h, w
    out = torch.empty((k, 8), dtype=torch.int32, device=xy.device)
    if k == 0:
        return out
    pattern = fast_orb._constants(xy.device)["pattern"]
    KERNEL.launch("brief_descriptors", ptr(blurred), table, ptr(kp_level),
                  ptr(xy), ptr(ca), ptr(sa), ptr(pattern), k, ptr(out),
                  stream_of(xy))
    return out


def brief_descriptors(blurred, shapes, xy, kp_level, angle):
    """Steered-BRIEF descriptors of keypoints on several pyramid levels.

    blurred: (sum h*w,) float32, the blurred levels concatenated row-major;
    shapes: [(h, w)] per level; xy: (K, 2) level-local keypoint coords;
    kp_level: (K,) int32 index into ``shapes``; angle: (K,) radians.
    Returns (K, 8) int32 words.
    """
    ca, sa = torch.cos(angle), torch.sin(angle)
    args = (blurred, shapes, xy.contiguous(), kp_level.contiguous(),
            ca.contiguous(), sa.contiguous())
    if blurred.device.type == "cpu":
        return brief_descriptors_plain(*args)
    return brief_descriptors_kernel(*args)
