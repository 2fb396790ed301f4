"""Kernel K2: fused masked-Hamming top-2 descriptor matching.

Replaces ``orbslam3_byzyh_tpu/ops/pallas_match.py::hamming_best2`` (Pallas
``_kernel`` / ``hamming_best2_pallas``). The CUDA source is
``csrc/match.cu``: the distances on the tensor cores (1-bit AND-popc
products), the gate and the top-2 in their epilogue.
:func:`hamming_best2_plain` is the same function in plain PyTorch
(``masked_hamming`` + ``best_two`` with the window / level / epipolar
gates).

Modes, chosen by the keyword arguments given:
  * window: ``xy_a``, ``xy_b``, ``radius`` (per row or one value; the
    kernel takes it as a tensor), with ``level_a``/``level_b`` and
    ``level_window`` = [lo, hi] on level_b - level_a;
  * epipolar: ``lines`` (N, 3) in image b and ``line_th`` (M,): squared
    point-line distance (a u + b v + c)^2 / (a^2 + b^2) below the threshold;
  * none: validity only.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels._build import Kernel, check_cuda, ptr, stream_of
from . import matching

MODES = {"none": 0, "window": 1, "epipolar": 2}

_P = ctypes.c_void_p


class _Gates(ctypes.Structure):
    """Passed by value: the gate's input arrays where the caller holds them
    (null where the mode does not read them)."""

    _fields_ = [("xy_a", _P), ("radius", _P), ("level_a", _P),
                ("lines", _P), ("xy_b", _P), ("level_b", _P),
                ("line_th", _P), ("radius_stride", ctypes.c_int),
                ("lo", ctypes.c_int), ("hi", ctypes.c_int)]


KERNEL = Kernel("match", {
    # da, db, va, vb, n, m, mode, gates, best, second, bj, stream
    "hamming_best2": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _Gates, _P, _P, _P, _P],
})


def _mode(xy_a, lines) -> str:
    if lines is not None:
        return "epipolar"
    return "window" if xy_a is not None else "none"


def _inv_norm2(lines):
    return 1.0 / (lines[:, 0] ** 2 + lines[:, 1] ** 2).clamp_min(1e-12)


def hamming_best2_plain(da, db, valid_a, valid_b, *, xy_a=None, xy_b=None,
                        radius=None, level_a=None, level_b=None,
                        level_window=(0, 0), lines=None, line_th=None,
                        chunk_rows=None):
    """Plain PyTorch version: (best, second, best_j), each (N,) int32.

    A row that ``valid_a`` masks has every distance at ``INVALID_DIST``
    whatever its descriptor and gate data, so its result is (INVALID_DIST,
    INVALID_DIST, 0) and only the valid rows are computed (the
    landmark-slot searches mask most of their 65,536 rows). They are taken
    ``chunk_rows`` at a time (default: ``matching.chunk_rows_for(M)``);
    each row's result depends on that row alone, so any block size gives
    the same bits."""
    mode = _mode(xy_a, lines)
    n, m = da.shape[0], db.shape[0]
    step = chunk_rows or matching.chunk_rows_for(m)
    if radius is not None and not isinstance(radius, torch.Tensor):
        radius = torch.full((), radius, dtype=torch.float32, device=da.device)
    keep = torch.nonzero(valid_a).flatten()

    def kept(x):
        return x if x is None or x.dim() == 0 else x[keep]

    da, valid_a, xy_a, radius, level_a, lines = (
        kept(x) for x in (da, valid_a, xy_a, radius, level_a, lines))
    parts = []
    for r0 in range(0, keep.numel(), step):
        rows = slice(r0, r0 + step)
        pm = None
        if mode == "window":
            rad = radius if radius.dim() == 0 else radius[rows]
            pm = matching.window_mask(xy_a[rows], xy_b, rad) \
                & matching.level_mask(level_a[rows], level_b, *level_window)
        elif mode == "epipolar":
            ln = lines[rows]
            num = (ln[:, None, 0] * xy_b[None, :, 0]
                   + ln[:, None, 1] * xy_b[None, :, 1] + ln[:, None, 2])
            pm = num * num * _inv_norm2(ln)[:, None] < line_th[None, :]
        dist = matching.masked_hamming(da[rows], db, valid_a[rows], valid_b,
                                       pm)
        parts.append(matching.best_two(dist))
    out = tuple(torch.full((n,), v, dtype=torch.int32, device=da.device)
                for v in (matching.INVALID_DIST, matching.INVALID_DIST, 0))
    for o, p in zip(out, zip(*parts)):
        o[keep] = torch.cat(p)
    return out


def hamming_best2_kernel(da, db, valid_a, valid_b, *, xy_a=None, xy_b=None,
                         radius=None, level_a=None, level_b=None,
                         level_window=(0, 0), lines=None, line_th=None):
    """K2 on the card. Every array is a contiguous CUDA tensor that the
    kernel reads where it lies (descriptors int32, 16-byte aligned;
    validity bool; levels int32; the rest float32; ``radius`` (N,) or one
    value as a 0-d tensor), so a call is one launch beside the allocation
    of its outputs."""
    n, m = da.shape[0], db.shape[0]
    mode = _mode(xy_a, lines)
    check_cuda("da", da, torch.int32, (n, 8))
    check_cuda("db", db, torch.int32, (m, 8))
    for name, x in (("da", da), ("db", db)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned rows")
    check_cuda("valid_a", valid_a, torch.bool, (n,))
    check_cuda("valid_b", valid_b, torch.bool, (m,))
    gates = _Gates()
    if mode == "window":
        check_cuda("xy_a", xy_a, torch.float32, (n, 2))
        check_cuda("xy_b", xy_b, torch.float32, (m, 2))
        check_cuda("radius", radius, torch.float32)
        if radius.shape not in ((), (n,)):
            raise ValueError(f"radius: expected shape () or ({n},), got "
                             f"{tuple(radius.shape)}")
        check_cuda("level_a", level_a, torch.int32, (n,))
        check_cuda("level_b", level_b, torch.int32, (m,))
        gates.xy_a, gates.xy_b = xy_a.data_ptr(), xy_b.data_ptr()
        gates.radius, gates.radius_stride = radius.data_ptr(), radius.dim()
        gates.level_a, gates.level_b = level_a.data_ptr(), level_b.data_ptr()
        gates.lo, gates.hi = int(level_window[0]), int(level_window[1])
    elif mode == "epipolar":
        check_cuda("lines", lines, torch.float32, (n, 3))
        check_cuda("xy_b", xy_b, torch.float32, (m, 2))
        check_cuda("line_th", line_th, torch.float32, (m,))
        gates.lines, gates.xy_b = lines.data_ptr(), xy_b.data_ptr()
        gates.line_th = line_th.data_ptr()
    best = torch.empty(n, dtype=torch.int32, device=da.device)
    second = torch.empty_like(best)
    bj = torch.empty_like(best)
    if n == 0:
        return best, second, bj
    KERNEL.launch("hamming_best2", ptr(da), ptr(db), ptr(valid_a),
                  ptr(valid_b), n, m, MODES[mode], gates, ptr(best),
                  ptr(second), ptr(bj), stream_of(da))
    return best, second, bj


def hamming_best2(da, db, valid_a, valid_b, **gates):
    """Geometry-gated top-2 Hamming match: per query row the best distance,
    the second-best distance and the best column (lowest column on ties;
    the second excludes only the best column). Masked pairs count as
    ``INVALID_DIST``."""
    if da.device.type == "cpu":
        return hamming_best2_plain(da, db, valid_a, valid_b, **gates)
    return hamming_best2_kernel(da, db, valid_a, valid_b, **gates)
