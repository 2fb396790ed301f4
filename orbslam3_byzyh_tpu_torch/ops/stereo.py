"""Rectified stereo matching: row-constrained Hamming search, SAD subpixel
refinement and the median outlier sweep.

Port of ``orbslam3_byzyh_tpu/ops/stereo.py::stereo_match``
(``Frame::ComputeStereoMatches``): candidates on the left keypoint's row
(+-2 sigma of its level), disparity in [-1, bf / min_z], levels within one;
the coarse gate at thOrbDist = (TH_HIGH + TH_LOW) / 2 = 75; an 11x11 SAD
(each window less its centre pixel) sliding +-5 px around the coarse match
on the level-0 image, with a parabola fit; then the 1.5 x 1.4 x median SAD
sweep. Everything here is plain PyTorch, as the JAX package computes it
outside any Pallas kernel, and nothing is read back to the host.

The sweep's median, repaired: the JAX package takes
``jnp.median(where(ok, sad, nan))``, which is NaN as soon as one keypoint
lacks a match, so its threshold becomes 1e9 on every real frame and the
sweep never removes anything. Here the median is Frame.cc's: the accepted
matches' SADs sorted, the element at index count // 2, selected on the
device. A match is kept when its SAD is at most the threshold, as the JAX
package compares (Frame.cc removes one equal to it, which at a median of 0,
an exact shift, would remove every match).

``fisheye_stereo_match`` waits for the next slice (ROADMAP item 10b).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import matching

SCALE = 1.2
W_SAD = 5          # 11x11 window (w = 5), Frame.cc:1247
SLIDE = 5          # +-5 px search
TH_ORB = (100 + 50) // 2   # (TH_HIGH + TH_LOW) / 2 = 75
OUTLIER_FACTOR = 1.5 * 1.4


class StereoMatchResult(NamedTuple):
    u_right: torch.Tensor   # (N,) refined right-image u, -1 invalid
    depth: torch.Tensor     # (N,) bf / disparity, -1 invalid
    valid: torch.Tensor     # (N,) bool


def _gather_window(img, cx, cy, half: int):
    """(N,) integer centres -> (N, 2h+1, 2h+1) windows, border-clamped."""
    h, w = img.shape
    d = torch.arange(-half, half + 1, device=img.device)
    yy = (cy[:, None, None] + d[None, :, None]).clamp(0, h - 1)
    xx = (cx[:, None, None] + d[None, None, :]).clamp(0, w - 1)
    return img.reshape(-1)[(yy * w + xx).reshape(-1)].reshape(
        -1, 2 * half + 1, 2 * half + 1)


def _sad_curve(img_left, img_right, uL, vL, uR0):
    """(N, 2 SLIDE + 1) SADs of the left window against the right windows
    at uR0 + d, d in [-SLIDE, SLIDE], each window less its centre."""
    c = W_SAD
    patch_l = _gather_window(img_left, uL, vL, W_SAD)
    patch_l = patch_l - patch_l[:, c:c + 1, c:c + 1]
    sads = []
    for d in range(-SLIDE, SLIDE + 1):
        patch_r = _gather_window(img_right, uR0 + d, vL, W_SAD)
        patch_r = patch_r - patch_r[:, c:c + 1, c:c + 1]
        sads.append((patch_l - patch_r).abs().sum((-1, -2)))
    return torch.stack(sads, -1)


def median_of_accepted(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Frame.cc's median of ``x`` over the rows where ``ok``: sorted
    ascending, the element at index count // 2 (+inf when none is
    accepted). A 0-d tensor on the device; nothing is read back."""
    keyed = torch.where(ok, x, torch.full_like(x, float("inf")))
    srt = keyed.sort().values
    mid = (ok.sum() // 2).clamp_max(x.shape[0] - 1).reshape(1)
    return srt.index_select(0, mid)[0]


def match_and_refine(left_xy, left_level, left_desc, left_valid,
                     right_xy, right_level, right_desc, right_valid,
                     img_left, img_right, bf, min_z):
    """Everything before the sweep: (u_right (N,), the disparity clamped at
    0.01 (N,), the accepted rows (N,), each row's best SAD (N,))."""
    n = left_xy.shape[0]
    dev = left_xy.device
    bf32 = np.float32(bf)
    sigma = SCALE ** left_level.to(torch.float32)

    # Row, disparity and level constraints (Frame.cc:1130-1166).
    dv = (left_xy[:, 1:2] - right_xy[None, :, 1]).abs()
    row_ok = dv <= 2.0 * sigma[:, None]
    disparity = left_xy[:, 0:1] - right_xy[None, :, 0]
    max_d = float(bf32 / np.float32(min_z))
    disp_ok = (disparity >= -1.0) & (disparity <= max_d)
    lvl_ok = (left_level[:, None] - right_level[None, :]).abs() <= 1
    dist = matching.masked_hamming(left_desc, right_desc, left_valid,
                                   right_valid, row_ok & disp_ok & lvl_ok)
    best, _, best_j = matching.best_two(dist)
    coarse_ok = best <= TH_ORB

    # SAD sub-pixel refinement around the coarse match.
    uL = torch.round(left_xy[:, 0]).to(torch.int64)
    vL = torch.round(left_xy[:, 1]).to(torch.int64)
    uR0 = torch.round(right_xy[best_j.clamp_min(0).long(), 0]).to(torch.int64)
    sad = _sad_curve(img_left, img_right, uL, vL, uR0)          # (N, 11)
    best_d = torch.argmin(sad, -1)
    interior = (best_d > 0) & (best_d < 2 * SLIDE)
    im = best_d.clamp(1, 2 * SLIDE - 1)
    rows = torch.arange(n, device=dev)
    s_m1, s_0, s_p1 = sad[rows, im - 1], sad[rows, im], sad[rows, im + 1]
    denom = (2.0 * (s_m1 + s_p1 - 2.0 * s_0)).clamp_min(1e-6)
    delta = torch.where(interior, (s_m1 - s_p1) / denom, 0.0).clamp(-1.0, 1.0)

    u_right = uR0.to(torch.float32) + (im.to(torch.float32) - SLIDE) + delta
    disp = left_xy[:, 0] - u_right
    disp = torch.where(disp <= 0.01, 0.01, disp)
    gap = left_xy[:, 0] - u_right
    ok = coarse_ok & left_valid & (gap > 0.0) & (gap <= max_d)
    return u_right, disp, ok, sad[rows, best_d]


def stereo_match(left_xy, left_level, left_desc, left_valid,
                 right_xy, right_level, right_desc, right_valid,
                 img_left, img_right, bf, min_z) -> StereoMatchResult:
    """Match the left keypoints into the right image of a rectified pair.

    ``img_left`` / ``img_right``: (H, W) float32 level-0 images. ``bf``:
    baseline x fx and ``min_z``, the closest depth (max disparity bf /
    min_z): Python floats, used in float32 as the JAX package's float32
    ``bf``.
    """
    u_right, disp, ok, sad_best = match_and_refine(
        left_xy, left_level, left_desc, left_valid, right_xy, right_level,
        right_desc, right_valid, img_left, img_right, bf, min_z)
    # The median outlier sweep (Frame.cc: 1.5 x 1.4 x median SAD).
    ok = ok & (sad_best <= OUTLIER_FACTOR * median_of_accepted(sad_best, ok))
    bf32 = torch.full_like(disp, np.float32(bf))
    return StereoMatchResult(
        u_right=torch.where(ok, u_right, -1.0),
        depth=torch.where(ok, bf32 / disp, -1.0), valid=ok)
