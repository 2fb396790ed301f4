"""Tracking front-end: the local-map tracking step.

Port of ``orbslam3_byzyh_tpu/pipeline/tracking.py`` (``track_local_map``;
``TrackLocalMap`` + ``SearchLocalPoints`` of the reference). The other
per-frame steps (motion model, ``frame_step``, the local window) wait for
later ports.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import camera as cam
from ..ops import matching
from ..solver import pose_opt

SCALE = 1.2
N_LEVELS = 8
SIGMA2 = torch.tensor([SCALE ** (2 * i) for i in range(N_LEVELS)],
                      dtype=torch.float32)
INV_SIGMA2 = 1.0 / SIGMA2


@functools.cache
def _inv_sigma2_on(device: torch.device) -> torch.Tensor:
    # Copied once: a copy from pageable host memory synchronises the stream.
    return INV_SIGMA2.to(device)


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    bindings: torch.Tensor   # (N,) landmark id per current keypoint, -1 = none
    n_inliers: torch.Tensor


def track_local_map(R0, t0, bindings,
                    lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
                    feats_xy, feats_level, feats_desc, feats_valid,
                    cam_params, img_w: int, img_h: int,
                    model_id: int = cam.PINHOLE) -> TrackResult:
    """Project all visible landmarks, widen the match set, re-optimize.

    Landmarks already bound to a keypoint keep their binding; unbound
    visible landmarks search within a radius of 4 * 1.2^level px.
    """
    n_kp = feats_xy.shape[0]
    n_lm = lm_pos.shape[0]
    dev = lm_pos.device

    visible, proj, _, plevel = matching.frustum_cull(
        R0, t0, lm_pos, lm_normal, lm_min_d, lm_max_d, cam_params,
        float(img_w), float(img_h))
    visible = visible & lm_valid

    # Landmarks already matched this frame are excluded from the search.
    # Unbound keypoints scatter into a spare slot that is sliced off.
    is_bound_kp = bindings >= 0
    lm_already = torch.zeros(n_lm + 1, dtype=torch.bool, device=dev)
    lm_already[torch.where(is_bound_kp, bindings, n_lm).long()] = True
    lm_already = lm_already[:n_lm]

    radius = 4.0 * SCALE ** plevel.to(torch.float32)
    mj, _ = matching.search_by_projection(
        proj, plevel, lm_desc, visible & ~lm_already,
        feats_xy, feats_level, feats_desc, feats_valid & ~is_bound_kp,
        radius=radius, max_dist=matching.TH_HIGH, ratio=0.8,
        level_window=(-1, 1))

    # Union of previous bindings and new matches, as (kp -> lm). The mutual
    # filter makes every matched keypoint index unique.
    matched = mj >= 0
    new_bind = torch.full((n_kp + 1,), -1, dtype=torch.int32, device=dev)
    new_bind[torch.where(matched, mj, n_kp).long()] = torch.where(
        matched, torch.arange(n_lm, dtype=torch.int32, device=dev), -1)
    bindings = torch.where(is_bound_kp, bindings, new_bind[:n_kp])

    # Final pose optimization over all bound keypoints.
    has = bindings >= 0
    pw = lm_pos[bindings.clamp_min(0).long()]
    inv_s2 = _inv_sigma2_on(dev)[feats_level.long()]
    res = pose_opt.pose_optimization(
        R0, t0, pw, feats_xy, inv_s2, has & feats_valid, cam_params,
        model_id=model_id)
    bindings = torch.where(res.inlier | ~has, bindings, -1)
    return TrackResult(R=res.R, t=res.t, bindings=bindings,
                       n_inliers=res.n_inliers)
