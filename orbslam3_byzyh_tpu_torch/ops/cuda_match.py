"""Kernel K2: fused masked-Hamming top-2 descriptor matching.

Replaces ``orbslam3_byzyh_tpu/ops/pallas_match.py::hamming_best2`` (Pallas
``_kernel`` / ``hamming_best2_pallas``). The CUDA source is
``csrc/match.cu``; :func:`hamming_best2_plain` is the same function in plain
PyTorch (``masked_hamming`` + ``best_two`` with the window / level /
epipolar gates).

Modes, chosen by the keyword arguments given:
  * window: ``xy_a``, ``xy_b``, ``radius`` (scalar or per row), with
    ``level_a``/``level_b`` and ``level_window`` = [lo, hi] on
    level_b - level_a;
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
KERNEL = Kernel("match", {
    # da, db, va, vb, geo_a, geo_b, n, m, mode, lo, hi, best, second, bj,
    # stream
    "hamming_best2": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      _P, _P, _P, _P],
})


def _mode(xy_a, lines) -> str:
    if lines is not None:
        return "epipolar"
    return "window" if xy_a is not None else "none"


def _inv_norm2(lines):
    return 1.0 / (lines[:, 0] ** 2 + lines[:, 1] ** 2).clamp_min(1e-12)


def hamming_best2_plain(da, db, valid_a, valid_b, *, xy_a=None, xy_b=None,
                        radius=None, level_a=None, level_b=None,
                        level_window=(0, 0), lines=None, line_th=None):
    """Plain PyTorch version: (best, second, best_j), each (N,) int32."""
    mode = _mode(xy_a, lines)
    pm = None
    if mode == "window":
        pm = matching.window_mask(xy_a, xy_b, radius) \
            & matching.level_mask(level_a, level_b, *level_window)
    elif mode == "epipolar":
        num = (lines[:, None, 0] * xy_b[None, :, 0]
               + lines[:, None, 1] * xy_b[None, :, 1] + lines[:, None, 2])
        pm = num * num * _inv_norm2(lines)[:, None] < line_th[None, :]
    dist = matching.masked_hamming(da, db, valid_a, valid_b, pm)
    return matching.best_two(dist)


def hamming_best2_kernel(da, db, valid_a, valid_b, *, xy_a=None, xy_b=None,
                         radius=None, level_a=None, level_b=None,
                         level_window=(0, 0), lines=None, line_th=None):
    """K2 on the card. Packs the per-mode gate data as the Pallas wrapper
    does: geo_a (N, 4) per row, geo_b (4, M) per column."""
    n, m = da.shape[0], db.shape[0]
    dev = da.device
    mode = _mode(xy_a, lines)
    geo_a = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    geo_b = torch.zeros((4, m), dtype=torch.float32, device=dev)
    if mode == "window":
        # geo_a rows: [u, v, r^2, level]; geo_b rows: [u, v, level, 0].
        geo_a[:, :2] = xy_a
        r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
        geo_a[:, 2] = r * r
        geo_a[:, 3] = level_a.to(torch.float32)
        geo_b[:2] = xy_b.T
        geo_b[2] = level_b.to(torch.float32)
    elif mode == "epipolar":
        # geo_a rows: [a, b, c, 1/(a^2+b^2)]; geo_b rows: [u, v, th, 0].
        geo_a[:, :3] = lines
        geo_a[:, 3] = _inv_norm2(lines)
        geo_b[:2] = xy_b.T
        geo_b[2] = line_th
    da, db = da.contiguous(), db.contiguous()
    va, vb = valid_a.contiguous(), valid_b.contiguous()
    check_cuda("da", da, torch.int32, (n, 8))
    check_cuda("db", db, torch.int32, (m, 8))
    check_cuda("valid_a", va, torch.bool, (n,))
    check_cuda("valid_b", vb, torch.bool, (m,))
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    bj = torch.empty_like(best)
    if n == 0:
        return best, second, bj
    KERNEL.launch("hamming_best2", ptr(da), ptr(db), ptr(va), ptr(vb),
                  ptr(geo_a), ptr(geo_b), n, m, MODES[mode],
                  float(level_window[0]), float(level_window[1]),
                  ptr(best), ptr(second), ptr(bj), stream_of(da))
    return best, second, bj


def hamming_best2(da, db, valid_a, valid_b, **gates):
    """Geometry-gated top-2 Hamming match: per query row the best distance,
    the second-best distance and the best column (lowest column on ties;
    the second excludes only the best column). Masked pairs count as
    ``INVALID_DIST``."""
    if da.device.type == "cpu":
        return hamming_best2_plain(da, db, valid_a, valid_b, **gates)
    return hamming_best2_kernel(da, db, valid_a, valid_b, **gates)
