"""Tracking front-end: the per-frame step and its stages.

Port of ``orbslam3_byzyh_tpu/pipeline/tracking.py`` (monocular):
``track_motion_model`` (TrackWithMotionModel), ``track_local_map``
(TrackLocalMap + SearchLocalPoints), ``select_local_window`` and
``track_local_map_windowed`` (UpdateLocalKeyFrames / UpdateLocalPoints),
``frame_step`` (the fused step the systems call on every tracked frame),
``ref_kf_matches``, ``track_reference_keyframe`` and
``match_for_initialization``; and the stereo variant
``track_local_map_stereo``, whose final pose optimization mixes stereo rows
(K3s) with mono ones, selected by ``use_stereo=True``.

The JAX package's drop-mode scatters (``.at[sentinel].set(mode="drop")``)
become writes into one padded slot that is sliced off, and its ``top_k``
(lower index first on ties) becomes :func:`matching.top_k_lowest_first`.
Nothing here reads a tensor back to the host.
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
# frame_step retries the motion model from the last pose, with a wider
# window, when the first try keeps fewer than this many inliers.
RETRY_BELOW = 10
MOTION_RADIUS = 15.0
RETRY_RADIUS = 30.0

@functools.cache
def _inv_sigma2_on(device: torch.device) -> torch.Tensor:
    # Copied once: a copy from pageable host memory synchronises the stream.
    return INV_SIGMA2.to(device)


@functools.cache
def _row_radii(radii: tuple, n: int, device: torch.device) -> torch.Tensor:
    """(len(radii) * n,) float32: n rows of each radius, made once."""
    return torch.tensor(radii, dtype=torch.float32).repeat_interleave(n).to(
        device)


@functools.cache
def _zero_levels(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device=device)


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    bindings: torch.Tensor   # (N,) landmark id per current keypoint, -1 = none
    n_inliers: torch.Tensor


class LocalWindow(NamedTuple):
    """The frame's bounded local map."""

    lm_ids: torch.Tensor     # (W,) global landmark ids gathered this frame
    lm_ok: torch.Tensor      # (W,) which rows are real
    loc: torch.Tensor        # (L,) global -> window index, -1 = outside


def select_local_window(last_bind, obs_kf, obs_valid, lm_valid, n_kf,
                        max_kf: int, n_local_kf: int = 20,
                        n_local_lm: int = 4096,
                        recent_kf: int = 4) -> LocalWindow:
    """The frame's local map: the landmarks observed by the top
    ``n_local_kf`` keyframes voted for by the last frame's bindings plus the
    ``recent_kf`` newest keyframes, truncated at ``n_local_lm`` rows with
    the currently bound landmarks first (ties: lower id first)."""
    L = obs_kf.shape[0]
    dev = obs_kf.device
    bound = last_bind >= 0
    gids = last_bind.clamp_min(0).long()

    # Votes of the keyframes that observe the landmarks bound to the last
    # frame; other entries go to the spare slot max_kf.
    rows = obs_kf[gids]                                   # (N, O)
    rv = obs_valid[gids] & bound[:, None] & (rows >= 0) & (rows < max_kf)
    voter = torch.where(rv, rows, max_kf).reshape(-1).long()
    votes = torch.zeros(max_kf + 1, dtype=torch.int32, device=dev).index_add(
        0, voter, rv.reshape(-1).to(torch.int32))[:max_kf]
    kc, ki = matching.top_k_lowest_first(votes, min(n_local_kf, max_kf))
    kf_mask = torch.zeros(max_kf + 1, dtype=torch.bool, device=dev)
    kf_mask.index_fill_(0, torch.where(kc > 0, ki, max_kf), True)
    ids = torch.arange(max_kf, device=dev)
    kf_mask = kf_mask[:max_kf] | ((ids >= n_kf - recent_kf) & (ids < n_kf))

    # Local landmarks: observed by a local keyframe; bound ones first.
    in_local = (obs_valid & (obs_kf >= 0)
                & kf_mask[obs_kf.clamp(0, max_kf - 1).long()]).any(-1) \
        & lm_valid
    bound_lm = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    bound_lm.index_fill_(0, torch.where(bound, gids, L), True)
    score = in_local.to(torch.int32) \
        + 2 * (bound_lm[:L] & lm_valid).to(torch.int32)
    sc, lm_ids = matching.top_k_lowest_first(score, min(n_local_lm, L))
    lm_ok = sc > 0
    loc = torch.full((L + 1,), -1, dtype=torch.int32, device=dev)
    loc[torch.where(lm_ok, lm_ids, L)] = torch.arange(
        lm_ids.shape[0], dtype=torch.int32, device=dev)
    return LocalWindow(lm_ids=lm_ids, lm_ok=lm_ok, loc=loc[:L])


def _motion_model(R0, t0, radii: tuple, lm_pos, lm_valid, last_bind,
                  last_desc, feats_xy, feats_level, feats_desc, feats_valid,
                  cam_params, model_id, last_angle,
                  feats_angle) -> TrackResult:
    """``track_motion_model`` from B start poses at once: R0 (B, 3, 3), t0
    (B, 3), one search radius each. The B x N projection rows go to K2 in
    one window-mode launch (K2 is row-wise, so each branch's rows get what
    a launch of their own would give) and the B pose problems to K3 in one
    launch; the gates that look across rows (mutual filter, rotation
    histogram) run per branch. Returns batched fields."""
    b, n = R0.shape[0], last_bind.shape[0]
    m = feats_xy.shape[0]
    dev = lm_pos.device
    lm_id = last_bind.clamp_min(0).long()
    pw = lm_pos[lm_id]                                    # (N, 3)
    has_lm = (last_bind >= 0) & lm_valid[lm_id]

    pc = torch.einsum("bij,nj->bni", R0, pw) + t0[:, None, :]
    proj = cam.project(model_id, cam_params, pc)          # (B, N, 2)
    ok = has_lm & (pc[..., 2] > 0.05)

    # The radius scales with the level of the source keypoint, which the
    # JAX package takes as level 0 for every row (so 1.2^0 = 1).
    from ..ops import cuda_match
    best, second, best_j = cuda_match.hamming_best2(
        last_desc.repeat(b, 1), feats_desc, ok.reshape(-1), feats_valid,
        xy_a=proj.reshape(b * n, 2), xy_b=feats_xy,
        radius=_row_radii(radii, n, dev), level_a=_zero_levels(b * n, dev),
        level_b=feats_level, level_window=(-8, 8))
    accept = (best <= matching.TH_HIGH) & matching.ratio_test(best, second,
                                                              0.9)
    # Branch k's columns are k * m + j, so one mutual filter keeps the
    # branches apart.
    offset = (torch.arange(b * n, device=dev) // n * m).to(torch.int32)
    accept = matching.mutual_filter_from_best(best, best_j + offset, accept,
                                              b * m)
    mj = torch.where(accept, best_j, -1).reshape(b, n)
    if last_angle is not None and feats_angle is not None:
        mj = torch.stack([matching.apply_rotation_filter(
            mj[k], last_angle, feats_angle) for k in range(b)])

    matched = mj >= 0
    kp_idx = mj.clamp_min(0).long()
    res = pose_opt.pose_optimization(
        R0, t0, pw.expand(b, n, 3).contiguous(), feats_xy[kp_idx],
        _inv_sigma2_on(dev)[feats_level[kp_idx].long()], matched, cam_params,
        model_id=model_id)

    # Bindings for the current frame: landmark ids scattered to the matched
    # keypoints (unique per branch after the mutual filter); the rest go to
    # the spare column m.
    keep = matched & res.inlier
    bindings = torch.full((b, m + 1), -1, dtype=torch.int32, device=dev)
    bindings.scatter_(1, torch.where(keep, kp_idx, m),
                      torch.where(keep, last_bind, -1))
    return TrackResult(R=res.R, t=res.t, bindings=bindings[:, :m],
                       n_inliers=res.n_inliers)


def track_motion_model(R_pred, t_pred, lm_pos, lm_valid,
                       last_bind, last_desc,
                       feats_xy, feats_level, feats_desc, feats_valid,
                       cam_params, radius: float = MOTION_RADIUS,
                       model_id: int = cam.PINHOLE,
                       last_angle=None, feats_angle=None) -> TrackResult:
    """Match the last frame's landmark bindings into the current frame by
    projection with the motion-model pose (radius 15, ratio 0.9, level
    window +-8, rotation histogram when both angle sets are given), then
    motion-only pose optimization."""
    res = _motion_model(R_pred[None], t_pred[None], (float(radius),),
                        lm_pos, lm_valid, last_bind, last_desc, feats_xy,
                        feats_level, feats_desc, feats_valid, cam_params,
                        model_id, last_angle, feats_angle)
    return TrackResult(*(x[0] for x in res))


def _search_local_points(R0, t0, bindings, lm_pos, lm_desc, lm_normal,
                         lm_min_d, lm_max_d, lm_valid, feats_xy, feats_level,
                         feats_desc, feats_valid, cam_params, img_w: int,
                         img_h: int):
    """SearchLocalPoints: the incoming bindings united with the matches of
    the unbound visible landmarks (radius 4 * 1.2^level px, ratio 0.8)."""
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
    lm_already.index_fill_(0, torch.where(is_bound_kp, bindings, n_lm).long(),
                           True)
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
    return torch.where(is_bound_kp, bindings, new_bind[:n_kp])


def _final_pose(R0, t0, bindings, lm_pos, feats_xy, feats_level,
                feats_valid, cam_params, model_id, feats_ur=None, bf=None):
    """The final pose optimization over every bound keypoint (stereo rows
    where ``feats_ur`` is given); outliers lose their binding."""
    has = bindings >= 0
    pw = lm_pos[bindings.clamp_min(0).long()]
    inv_s2 = _inv_sigma2_on(lm_pos.device)[feats_level.long()]
    if feats_ur is None:
        res = pose_opt.pose_optimization(
            R0, t0, pw, feats_xy, inv_s2, has & feats_valid, cam_params,
            model_id=model_id)
    else:
        res = pose_opt.pose_optimization_stereo(
            R0, t0, pw, feats_xy, feats_ur, bf, inv_s2, has & feats_valid,
            cam_params, model_id=model_id)
    bindings = torch.where(res.inlier | ~has, bindings, -1)
    return TrackResult(R=res.R, t=res.t, bindings=bindings,
                       n_inliers=res.n_inliers)


def track_local_map(R0, t0, bindings,
                    lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
                    feats_xy, feats_level, feats_desc, feats_valid,
                    cam_params, img_w: int, img_h: int,
                    model_id: int = cam.PINHOLE) -> TrackResult:
    """Project all visible landmarks, widen the match set, re-optimize.

    Landmarks already bound to a keypoint keep their binding; unbound
    visible landmarks search within a radius of 4 * 1.2^level px.
    """
    bindings = _search_local_points(
        R0, t0, bindings, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
        lm_valid, feats_xy, feats_level, feats_desc, feats_valid, cam_params,
        img_w, img_h)
    return _final_pose(R0, t0, bindings, lm_pos, feats_xy, feats_level,
                       feats_valid, cam_params, model_id)


def track_local_map_stereo(R0, t0, bindings,
                           lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                           lm_valid,
                           feats_xy, feats_level, feats_desc, feats_valid,
                           feats_ur, bf,
                           cam_params, img_w: int, img_h: int,
                           model_id: int = cam.PINHOLE) -> TrackResult:
    """``track_local_map`` with the stereo residual in the final pose
    optimization (K3s): keypoints with a right-image match (``feats_ur >=
    0``) add the u_r = u - bf / z row, the others stay monocular. ``bf`` is
    a Python float."""
    bindings = _search_local_points(
        R0, t0, bindings, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
        lm_valid, feats_xy, feats_level, feats_desc, feats_valid, cam_params,
        img_w, img_h)
    return _final_pose(R0, t0, bindings, lm_pos, feats_xy, feats_level,
                       feats_valid, cam_params, model_id, feats_ur, bf)


def _track_local(R0, t0, bindings, lm, feats_xy, feats_level, feats_desc,
                 feats_valid, feats_ur, bf, cam_params, img_w, img_h,
                 use_stereo, model_id) -> TrackResult:
    """``track_local_map`` or, with ``use_stereo``, its stereo variant."""
    if use_stereo:
        return track_local_map_stereo(
            R0, t0, bindings, *lm, feats_xy, feats_level, feats_desc,
            feats_valid, feats_ur, bf, cam_params, img_w, img_h,
            model_id=model_id)
    return track_local_map(R0, t0, bindings, *lm, feats_xy, feats_level,
                           feats_desc, feats_valid, cam_params, img_w, img_h,
                           model_id=model_id)


def _window_map(win: LocalWindow, lm_pos, lm_desc, lm_normal, lm_min_d,
                lm_max_d, lm_valid):
    """The landmark arrays gathered to the window's rows."""
    ids = win.lm_ids
    return (lm_pos[ids], lm_desc[ids], lm_normal[ids], lm_min_d[ids],
            lm_max_d[ids], lm_valid[ids] & win.lm_ok)


def _to_window(win: LocalWindow, bindings):
    lb = win.loc[bindings.clamp_min(0).long()]
    return torch.where((bindings >= 0) & (lb >= 0), lb, -1)


def _to_global(win: LocalWindow, bindings):
    return torch.where(bindings >= 0,
                       win.lm_ids[bindings.clamp_min(0).long()].to(
                           torch.int32), -1)


def track_local_map_windowed(R0, t0, bindings,
                             lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                             lm_valid, obs_kf, obs_valid, n_kf,
                             feats_xy, feats_level, feats_desc, feats_valid,
                             feats_ur, bf,
                             cam_params, img_w: int, img_h: int,
                             use_stereo: bool = False,
                             model_id: int = cam.PINHOLE,
                             max_kf: int = 0, n_local_kf: int = 20,
                             n_local_lm: int = 4096,
                             recent_kf: int = 4) -> TrackResult:
    """``track_local_map`` (``track_local_map_stereo`` with ``use_stereo``:
    ``feats_ur`` (N,) and ``bf`` a Python float) against the frame's local
    window (``select_local_window`` over the incoming bindings), with
    global-id bindings in and out; the whole map when it fits in the
    window."""
    lm = (lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid)
    use_window = max_kf > 0 and n_local_lm < lm_pos.shape[0]
    if use_window:
        win = select_local_window(
            bindings, obs_kf, obs_valid, lm_valid, n_kf, max_kf=max_kf,
            n_local_kf=n_local_kf, n_local_lm=n_local_lm, recent_kf=recent_kf)
        lm = _window_map(win, *lm)
        bindings = _to_window(win, bindings)
    res = _track_local(R0, t0, bindings, lm, feats_xy, feats_level,
                       feats_desc, feats_valid, feats_ur, bf, cam_params,
                       img_w, img_h, use_stereo, model_id)
    if use_window:
        res = res._replace(bindings=_to_global(win, res.bindings))
    return res


def frame_step(R_pred, t_pred, R_last, t_last,
               lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
               last_bind, last_desc, last_angle,
               feats_xy, feats_level, feats_desc, feats_valid, feats_angle,
               feats_ur, bf, th_depth,
               obs_kf, obs_valid, ref_kf, ref_min_obs, n_kf,
               n_found, n_visible,
               cam_params, img_w: int, img_h: int,
               use_stereo: bool = False, model_id: int = cam.PINHOLE,
               max_kf: int = 0, n_local_kf: int = 20,
               n_local_lm: int = 4096, recent_kf: int = 4):
    """One tracking step: the motion model and its widened retry, the
    local-map track against the bounded window, the found/visible counter
    update, the reference-KF tracked-point count and the stereo close-point
    counters, with the results the caller reads packed into one 16-float
    vector:

      info = [n_inliers, ref_matches, n_tracked_close, n_untracked_close,
              R_cw.flatten(9), t_cw(3)]

    The retry (radius 30 from the last pose, taken when the motion model
    keeps fewer than 10 inliers) is not a branch on the host: both tries
    run, as one K2 launch of 2N rows and one K3 launch of two problems, and
    ``torch.where`` selects. Nothing is read back to the host; the caller's
    read of ``info`` is the frame's one synchronisation.

    With ``use_stereo`` (``bf`` a Python float, ``feats_ur`` the frame's
    right-image u, -1 where none), the local-map track's final pose
    optimization adds the stereo rows (K3s); the motion model stays mono.
    ``th_depth`` is the close-point depth (bf / fx * ThDepth; 0 for a mono
    rig).

    Returns (TrackResult, info, n_found', n_visible').
    """
    both = _motion_model(
        torch.stack([R_pred, R_last]), torch.stack([t_pred, t_last]),
        (MOTION_RADIUS, RETRY_RADIUS), lm_pos, lm_valid, last_bind,
        last_desc, feats_xy, feats_level, feats_desc, feats_valid,
        cam_params, model_id, last_angle, feats_angle)
    retry = both.n_inliers[0] < RETRY_BELOW
    res = TrackResult(*(torch.where(retry, x[1], x[0]) for x in both))

    # Bounded local map: when the landmark capacity exceeds the window,
    # track against the frame's local landmarks only.
    lm = (lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid)
    use_window = max_kf > 0 and n_local_lm < lm_pos.shape[0]
    bindings = res.bindings
    if use_window:
        win = select_local_window(
            last_bind, obs_kf, obs_valid, lm_valid, n_kf, max_kf=max_kf,
            n_local_kf=n_local_kf, n_local_lm=n_local_lm, recent_kf=recent_kf)
        lm = _window_map(win, *lm)
        bindings = _to_window(win, bindings)
    res = _track_local(res.R, res.t, bindings, lm, feats_xy, feats_level,
                       feats_desc, feats_valid, feats_ur, bf, cam_params,
                       img_w, img_h, use_stereo, model_id)
    if use_window:
        res = res._replace(bindings=_to_global(win, res.bindings))

    # Found/visible counters, applied only when the frame tracks (the
    # caller treats < 15 inliers as lost).
    n_lm = lm_pos.shape[0]
    bound = res.bindings
    add = torch.zeros(n_lm, dtype=torch.int32, device=lm_pos.device)
    add = add.index_add(0, bound.clamp_min(0).long(),
                        ((bound >= 0) & (res.n_inliers >= 15)).to(torch.int32))
    n_found = n_found + add
    n_visible = n_visible + add

    ref_matches = ref_kf_matches(obs_kf, obs_valid, ref_kf, ref_min_obs)

    # Stereo close-point counters (zero for a mono rig: feats_ur < 0).
    disp = feats_xy[:, 0] - feats_ur
    if not isinstance(bf, torch.Tensor):  # a number: divide in float32
        bf = torch.full_like(disp, bf)
    z = bf / disp.clamp_min(1e-6)
    close = (feats_ur >= 0) & (disp > 1e-6) & (z < th_depth) & feats_valid
    tracked = res.bindings >= 0
    counts = torch.stack([res.n_inliers.to(torch.int64), ref_matches,
                          (close & tracked).sum(), (close & ~tracked).sum()])
    info = torch.cat([counts.to(torch.float32), res.R.reshape(-1), res.t])
    return res, info, n_found, n_visible


def ref_kf_matches(obs_kf, obs_valid, ref_kf, min_obs=3):
    """Landmarks observed by the reference keyframe that have at least
    ``min_obs`` live observations (TrackedMapPoints(nMinObs))."""
    live = obs_valid & (obs_kf >= 0)
    mature = live.sum(-1) >= min_obs
    in_ref = ((obs_kf == ref_kf) & obs_valid).any(-1)
    return (in_ref & mature).sum()


def match_for_initialization(ref_xy, ref_desc, ref_valid, ref_level,
                             cur_xy, cur_desc, cur_valid, cur_level,
                             radius: float = 100.0,
                             ref_angle=None, cur_angle=None):
    """SearchForInitialization: window search at level 0 only, TH_LOW,
    ratio 0.9, mutual; the rotation histogram when both angle sets are
    given."""
    mj, _ = matching.match_window(
        ref_desc, cur_desc, ref_valid & (ref_level == 0),
        cur_valid & (cur_level == 0), ref_xy, cur_xy, radius,
        ref_level, cur_level, level_window=(-8, 8),
        max_dist=matching.TH_LOW, ratio=0.9, mutual=True)
    if ref_angle is not None and cur_angle is not None:
        mj = matching.apply_rotation_filter(mj, ref_angle, cur_angle)
    return mj


def track_reference_keyframe(R_last, t_last,
                             ref_desc, ref_angle, ref_valid, ref_lm,
                             lm_pos, lm_valid,
                             feats_xy, feats_level, feats_desc, feats_valid,
                             feats_angle, cam_params,
                             model_id: int = cam.PINHOLE) -> TrackResult:
    """TrackReferenceKeyFrame: match the current frame against the
    reference keyframe by descriptor alone (K2's "none" mode; ratio 0.7,
    TH_LOW, rotation histogram, mutual) and pose-optimize from the last
    frame's pose. ref_lm: (N,) landmark id of each reference keypoint."""
    dev = lm_pos.device
    n_kp = feats_xy.shape[0]
    ref_id = ref_lm.clamp_min(0).long()
    has_lm = (ref_lm >= 0) & lm_valid[ref_id] & ref_valid
    mj, _ = matching.match(
        ref_desc, feats_desc, has_lm, feats_valid,
        max_dist=matching.TH_LOW, ratio=0.7, mutual=True,
        angles=(ref_angle, feats_angle))

    matched = mj >= 0
    kp_idx = mj.clamp_min(0).long()
    res = pose_opt.pose_optimization(
        R_last, t_last, lm_pos[ref_id], feats_xy[kp_idx],
        _inv_sigma2_on(dev)[feats_level[kp_idx].long()], matched, cam_params,
        model_id=model_id)

    keep = matched & res.inlier
    bindings = torch.full((n_kp + 1,), -1, dtype=torch.int32, device=dev)
    bindings[torch.where(keep, kp_idx, n_kp)] = torch.where(keep, ref_lm, -1)
    return TrackResult(R=res.R, t=res.t, bindings=bindings[:n_kp],
                       n_inliers=res.n_inliers)
