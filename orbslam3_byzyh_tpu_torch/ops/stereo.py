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

``fisheye_stereo_match`` is the non-rectified ("fisheye") rig's match
(``Frame::ComputeStereoFishEyeMatches`` and
``KannalaBrandt8::TriangulateMatches``): an all-pairs descriptor match of
the two cameras' keypoints (K2's none mode, then the 0.7 ratio and the
75 gate), then a DLT triangulation of each match with the parallax, the
two-sided depth and the sigma-gated reprojection gates, and the mutual
filter. It is one call on the device with no host read; the DLT's
``torch.linalg.svd`` synchronises with the host (``ops/geometry.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import camera as cam
from . import geometry, matching

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


class FisheyeStereoResult(NamedTuple):
    depth: torch.Tensor     # (N,) z in the left camera frame, -1 invalid
    match_j: torch.Tensor   # (N,) right-keypoint index, -1 invalid
    valid: torch.Tensor     # (N,) bool


# Parallax gate: a pair of rays closer than this cosine is rejected
# (KannalaBrandt8.cpp:470), and the reprojection gate in each view.
COS_PARALLAX = 0.9998
CHI2_REPROJ = 5.991


def fisheye_stereo_match(xy_l, level_l, desc_l, valid_l,
                         xy_r, level_r, desc_r, valid_r,
                         cam_l, cam_r, R_rl, t_rl) -> FisheyeStereoResult:
    """Match and triangulate the keypoints of a non-rectified pair.

    Port of ``orbslam3_byzyh_tpu/ops/stereo.py::fisheye_stereo_match``. The
    keypoints arrive rectified onto each camera's virtual pinhole (the KB8
    unprojection runs once at extraction, ``graft.mono_extract``), so the
    rays and the reprojection gates run in the virtual-pinhole frames.

    xy_l / xy_r: (N, 2) / (M, 2) virtual-pinhole pixels; levels (N,) /
    (M,) int32; descriptors (N, 8) / (M, 8) int32 words; validity masks.
    cam_l / cam_r: (4,) [fx, fy, cx, cy]. (R_rl, t_rl): left camera ->
    right camera (x_r = R_rl x_l + t_rl).

    A match is kept where the best distance passes the 0.7 ratio and
    ``TH_ORB``, the rays' cosine is under 0.9998, the point lies in front of
    both cameras and reprojects within chi2 5.991 sigma^2(level) in each
    view, and no other left keypoint took the same right keypoint at a
    lower distance (the lowest row on ties)."""
    from . import cuda_match

    best, second, bj = cuda_match.hamming_best2(desc_l, desc_r, valid_l,
                                                valid_r)
    acc = matching.ratio_test(best, second, 0.7) & (best <= TH_ORB)
    bj_safe = bj.clamp_min(0).long()
    xy_rm = xy_r[bj_safe]

    # Rays in each camera frame, and the parallax between them.
    r1 = cam.pinhole_unproject(cam_l, xy_l)              # (N, 3), z = 1
    r2 = cam.pinhole_unproject(cam_r, xy_rm)
    r2_in_l = r2 @ R_rl                                  # R_rl^T r2
    cosp = (r1 * r2_in_l).sum(-1) / (
        r1.norm(dim=-1) * r2_in_l.norm(dim=-1)).clamp_min(1e-9)
    parallax_ok = cosp < COS_PARALLAX

    # DLT in normalised coordinates: P1 = [I | 0], P2 = [R_rl | t_rl].
    dev, dt = xy_l.device, xy_l.dtype
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                    torch.zeros(3, 1, dtype=dt, device=dev)], -1)
    P2 = torch.cat([R_rl, t_rl[:, None]], -1)
    X = geometry.triangulate_dlt(P1, P2, r1[:, :2] / r1[:, 2:],
                                 r2[:, :2] / r2[:, 2:])
    z1 = X[:, 2]
    X2 = X @ R_rl.T + t_rl
    depth_ok = (z1 > 0) & (X2[:, 2] > 0)

    # The sigma-gated reprojection checks in both views.
    sigma2_l = SCALE ** (2.0 * level_l.to(torch.float32))
    sigma2_r = SCALE ** (2.0 * level_r[bj_safe].to(torch.float32))
    e1 = ((cam.pinhole_project(cam_l, X) - xy_l) ** 2).sum(-1)
    e2 = ((cam.pinhole_project(cam_r, X2) - xy_rm) ** 2).sum(-1)
    reproj_ok = (e1 <= CHI2_REPROJ * sigma2_l) & (e2 <= CHI2_REPROJ * sigma2_r)

    ok = acc & valid_l & parallax_ok & depth_ok & reproj_ok
    ok = ok & matching.mutual_filter_from_best(best, bj, ok, xy_r.shape[0])
    return FisheyeStereoResult(depth=torch.where(ok, z1, -1.0),
                               match_j=torch.where(ok, bj, -1), valid=ok)
