"""Local mapping: the per-keyframe bundle and its stages.

Port of ``orbslam3_byzyh_tpu/pipeline/mapping.py`` (the stages of
``keyframe_bundle``): epipolar triangulation against the best covisible
keyframes (CreateNewMapPoints), device-side landmark-slot allocation and
the capacity valve, duplicate fusion (SearchInNeighbors / Fuse), the
covisibility-windowed local BA, landmark and keyframe culling, and the
full-map BA the monocular initialisation runs (``local_ba``, with the
scatter Schur assembly), and the redundancy-cull candidate the system's
forced culling ranks by (``cull_candidate``). With ``use_stereo`` the BAs
add the keypoints' stereo rows (``kp_ur``, baseline x fx ``bf``). The
global BA (``global_ba``) may shard its landmarks over a device mesh.

Every function returns a new state and writes into none of its inputs. The
JAX package's drop-mode scatters write a padded spare row that is sliced
off (``map_state.scatter_rows``); its ``top_k`` (lower index first on ties)
is ``matching.top_k_lowest_first``, its ``argsort`` a stable sort. Nothing
here reads a tensor back to the host, apart from the synchronisation inside
``torch.linalg.svd`` (the DLT, once per neighbour).

One intended difference from the JAX package: ``landmark_overflow_valve``
also clears the observation rows of the landmarks it retires (the JAX
package leaves them live).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models import map_state as ms
from ..ops import camera as cam
from ..ops import geometry, lie, matching
from ..solver import ba
from ..utils import verbose
from .tracking import SCALE, SIGMA2, _inv_sigma2_on

_INT32_MAX = 2 ** 31 - 1


@functools.cache
def _sigma2_on(device: torch.device) -> torch.Tensor:
    # Copied once: a copy from pageable host memory synchronises the stream.
    return SIGMA2.to(device)


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a (1,) int64 index tensor, without a host read."""
    return x.index_select(0, idx)[0]


def _intrinsics(cam_params: torch.Tensor) -> torch.Tensor:
    """The pinhole K (3, 3) from [fx, fy, cx, cy], built on the device."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                        torch.stack([z, z, o])])


def fundamental_from_poses(R1, t1, R2, t2, cam_params):
    """F12 with x2^T F12 x1 = 0 from two world->cam poses, in pixels
    (GeometricTools::ComputeF12). K^-1 is the pinhole's closed form."""
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    Kinv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                        torch.stack([z, 1.0 / fy, -cy / fy]),
                        torch.stack([z, z, o])])
    E = lie.skew(t12) @ R12
    F21 = Kinv.T @ E @ Kinv            # x1^T F21 x2 = 0
    return F21.T


class TriangulationResult(NamedTuple):
    pos: torch.Tensor       # (N, 3) new landmark positions
    kp_a: torch.Tensor      # (N,) keypoint index in KF a
    kp_b: torch.Tensor      # (N,) keypoint index in KF b
    desc: torch.Tensor      # (N, 8) descriptor (from KF a)
    normal: torch.Tensor    # (N, 3)
    min_dist: torch.Tensor
    max_dist: torch.Tensor
    good: torch.Tensor      # (N,) validity


def triangulate_pair(Ra, ta, xy_a, level_a, desc_a, free_a,
                     Rb, tb, xy_b, level_b, desc_b, free_b,
                     cam_params, model_id: int = cam.PINHOLE,
                     ) -> TriangulationResult:
    """Epipolar-guided matching (K2's epipolar mode) and DLT between two
    keyframes. Only free keypoints (not bound to a landmark) take part. A
    match is good with positive depth in both views, reprojection chi2 <
    5.991 sigma2(level) in both, a view-distance ratio consistent with the
    levels (within 1.5 x 1.2), parallax cos < 0.9998 and a finite point.

    ``model_id`` is not read, as in the JAX function (a fault of the
    reference kept for parity, ROADMAP section 3): a KB8 keyframe's pixels
    go through the pinhole fundamental matrix and DLT of its first four
    parameters, on straight epipolar lines."""
    dev = xy_a.device
    inv_s2 = _inv_sigma2_on(dev)
    F12 = fundamental_from_poses(Ra, ta, Rb, tb, cam_params)
    lines = torch.cat([xy_a, torch.ones_like(xy_a[:, :1])], -1) @ F12.T
    mj, _ = matching.search_epipolar(lines, desc_a, free_a, xy_b, level_b,
                                     desc_b, free_b, _sigma2_on(dev),
                                     max_dist=matching.TH_LOW, ratio=0.8)
    n = xy_a.shape[0]
    kp_b = mj.clamp_min(0)
    matched = mj >= 0
    kb = kp_b.long()
    xb, lb = xy_b[kb], level_b[kb]

    K = _intrinsics(cam_params)
    Pa = geometry.projection_matrix(K, Ra, ta)
    Pb = geometry.projection_matrix(K, Rb, tb)
    X = geometry.triangulate_dlt(Pa, Pb, xy_a, xb)
    pca = X @ Ra.T + ta
    pcb = X @ Rb.T + tb

    def reproj2(P, xo):
        p = torch.cat([X, torch.ones_like(X[:, :1])], -1) @ P.T
        w = torch.where(p[:, 2].abs() < 1e-9, torch.full_like(p[:, 2], 1e-9),
                        p[:, 2])
        return ((xo - p[:, :2] / w[:, None]) ** 2).sum(-1)

    ea = reproj2(Pa, xy_a) * inv_s2[level_a.long()]
    eb = reproj2(Pb, xb) * inv_s2[lb.long()]

    ca = -(Ra.T @ ta)
    cb = -(Rb.T @ tb)
    da = torch.linalg.vector_norm(X - ca, dim=-1)
    db = torch.linalg.vector_norm(X - cb, dim=-1)
    ratio_dist = da / db.clamp_min(1e-9)
    ratio_octave = torch.pow(SCALE, (level_a - lb).to(torch.float32))
    ratio_factor = 1.5 * SCALE
    scale_ok = ((ratio_dist < ratio_octave * ratio_factor)
                & (ratio_dist > ratio_octave / ratio_factor))
    ray_a = (X - ca) / da.clamp_min(1e-9)[:, None]
    ray_b = (X - cb) / db.clamp_min(1e-9)[:, None]
    cos_par = (ray_a * ray_b).sum(-1)

    good = (matched & (pca[:, 2] > 0) & (pcb[:, 2] > 0)
            & (ea < 5.991) & (eb < 5.991) & scale_ok
            & (cos_par < 0.9998) & torch.isfinite(X).all(-1))
    normal = 0.5 * (ray_a + ray_b)
    normal = normal / torch.linalg.vector_norm(
        normal, dim=-1, keepdim=True).clamp_min(1e-9)
    max_dist = da * torch.pow(SCALE, level_a.to(torch.float32))
    min_dist = max_dist / SCALE ** (8 - 1)
    return TriangulationResult(
        pos=X, kp_a=torch.arange(n, dtype=torch.int32, device=dev),
        kp_b=kp_b, desc=desc_a, normal=normal, min_dist=min_dist,
        max_dist=max_dist, good=good)


def _full_ba_problem(state: ms.MapState, free_kf: torch.Tensor, cam_params,
                     use_stereo: bool = False,
                     bf: float = 0.0) -> ba.BAProblem:
    """The whole-map BA problem, every keyframe and landmark slot, with only
    the live ``free_kf`` (K,) poses free; with ``use_stereo`` the keypoints'
    right-image u (``kp_ur``) adds stereo rows."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    kf_safe = obs.kf.clamp_min(0).long()
    kp_safe = obs.kp.clamp_min(0).long()
    return ba.BAProblem(
        R=kfs.R, t=kfs.t, points=lms.pos, obs_kf=obs.kf,
        obs_uv=kfs.kp_xy[kf_safe, kp_safe],
        obs_w=_inv_sigma2_on(kfs.R.device)[
            kfs.kp_level[kf_safe, kp_safe].long()],
        obs_valid=obs.valid & (obs.kf >= 0), fixed=~(free_kf & kfs.valid),
        lm_valid=lms.valid, cam_params=cam_params,
        obs_ur=kfs.kp_ur[kf_safe, kp_safe] if use_stereo else None,
        bf=float(bf) if use_stereo else None)


def _apply_ba_result(state: ms.MapState, res: ba.BAResult) -> ms.MapState:
    """Write a full-map BA result back: poses, positions, the inlier gating;
    landmarks left with fewer than two observations die."""
    obs = state.obs._replace(valid=state.obs.valid & res.obs_inlier)
    n_obs = (obs.valid & (obs.kf >= 0)).sum(-1)
    lms = state.lms._replace(pos=res.points,
                             valid=state.lms.valid & (n_obs >= 2),
                             n_obs=n_obs.to(torch.int32))
    return ms.MapState(kfs=state.kfs._replace(R=res.R, t=res.t), lms=lms,
                       obs=obs)


def local_ba(state: ms.MapState, free_kf: torch.Tensor, cam_params,
             model_id: int = cam.PINHOLE, use_stereo: bool = False,
             bf: float = 0.0) -> ms.MapState:
    """Bundle adjust the whole map with only ``free_kf`` poses free (stages
    (5, 10)), by the scatter Schur assembly: the one-hot form's cost grows
    with the number of keyframe slots squared. Returns the updated state,
    with the observations' inlier gating applied."""
    prob = _full_ba_problem(state, free_kf, cam_params, use_stereo, bf)
    res = ba.bundle_adjust(prob, model_id=model_id,
                           assembly=ba.schur_pieces_scatter)
    return _apply_ba_result(state, res)


def global_ba(state: ms.MapState, cam_params, model_id: int = cam.PINHOLE,
              use_stereo: bool = False, bf: float = 0.0,
              mesh=None) -> ms.MapState:
    """Full bundle adjustment (RunGlobalBundleAdjustment ->
    GlobalBundleAdjustemnt): every live keyframe free but the gauge anchor,
    keyframe 0, on :func:`local_ba` (the scatter Schur assembly).

    ``mesh``: a ``parallel.dist_ba.DeviceMesh`` of the state's device type.
    The landmark axis is then sharded over its devices and the Schur
    pieces summed on its first (``dist_ba.dist_bundle_adjust``), with the
    unsharded semantics; the result comes back to the state's device. When
    the landmark slots do not split into equal shards the JAX package
    prints why and runs unsharded, and so does this."""
    kfs = state.kfs
    free = kfs.valid & (torch.arange(kfs.valid.shape[0],
                                     device=kfs.valid.device) != 0)
    if mesh is not None and state.lms.pos.shape[0] % mesh.size != 0:
        verbose.print_mess(
            f"global_ba: max_lm={state.lms.pos.shape[0]} not divisible by "
            f"mesh size {mesh.size}; falling back to single-device BA")
        mesh = None
    if mesh is None:
        return local_ba(state, free, cam_params, model_id,
                        use_stereo=use_stereo, bf=bf)
    from ..parallel import dist_ba
    home = kfs.R.device
    if any(d.type != home.type for d in mesh.devices):
        raise ValueError(f"global_ba: a mesh on "
                         f"{[str(d) for d in mesh.devices]} for a map on "
                         f"{home}")
    prob = _full_ba_problem(state, free, cam_params, use_stereo, bf)
    res = dist_ba.dist_bundle_adjust(dist_ba.shard_problem(prob, mesh), mesh,
                                     model_id=model_id)
    return _apply_ba_result(state, ba.BAResult(*(x.to(home) for x in res)))


def windowed_local_ba(state: ms.MapState, kf_id, cam_params,
                      model_id: int = cam.PINHOLE, use_stereo: bool = False,
                      bf: float = 0.0, n_free: int = 9, n_window: int = 32,
                      n_lm_window: int = 4096) -> ms.MapState:
    """Covisibility-windowed local BA (LocalBundleAdjustment): free = the
    keyframe and its ``n_free - 1`` best covisible neighbours; the window's
    landmarks = the first ``n_lm_window`` live landmarks those observe;
    fixed = the other observers of those landmarks (at most ``n_window -
    n_free``), KF 0, and the oldest free keyframe when nothing else is
    fixed. Runs ``bundle_adjust`` with stages (4, 6) (stereo rows from
    ``kp_ur`` with ``use_stereo``) and scatters the free poses, the window's
    points and its inlier gating back."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    dev = kfs.R.device
    max_kf = kfs.valid.shape[0]
    max_lm = lms.pos.shape[0]
    n_fixed_cap = n_window - n_free
    ki = ms.slot_index(kf_id, dev)

    # Free set: the keyframe and its top covisible neighbours.
    counts = ms.covisibility_counts(state, kf_id, max_kf)
    counts = torch.where(kfs.valid, counts, -1).index_fill(0, ki, -1)
    top_c, top_i = matching.top_k_lowest_first(counts, n_free - 1)
    free_ids = torch.cat([ki, top_i])
    free_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         top_c > 0])
    free_mask = ms.scatter_rows(
        torch.zeros(max_kf, dtype=torch.bool, device=dev),
        torch.where(free_ok, free_ids, max_kf), True)

    # Window landmarks: observed by any free keyframe.
    obs_live = obs.valid & (obs.kf >= 0)
    kf_safe_all = obs.kf.clamp_min(0).long()
    in_free = free_mask[kf_safe_all]
    lm_in = (obs_live & in_free).any(-1) & lms.valid
    lm_score, lm_ids = matching.top_k_lowest_first(lm_in.to(torch.int32),
                                                   n_lm_window)
    lm_ok = lm_score > 0

    # Fixed set: the other observers of the window's landmarks.
    contrib = lm_in[:, None] & obs_live & ~in_free
    flat_kf = torch.where(contrib, obs.kf, max_kf).reshape(-1).long()
    fix_counts = torch.zeros(max_kf + 1, dtype=torch.int32, device=dev)
    fix_counts = fix_counts.index_add(
        0, flat_kf, torch.ones_like(flat_kf, dtype=torch.int32))
    fix_counts = torch.where(kfs.valid & ~free_mask, fix_counts[:max_kf], -1)
    fc, fi = matching.top_k_lowest_first(fix_counts, n_fixed_cap)

    win_ids = torch.cat([free_ids, fi])                         # (W,)
    win_ok = torch.cat([free_ok, fc > 0])
    win_fixed = torch.arange(n_window, device=dev) >= n_free
    win_fixed = win_fixed | ~win_ok | (win_ids == 0)
    no_fixed = ~(win_fixed & win_ok).any()
    anchor = torch.argmin(torch.where(free_ok, free_ids, max_kf))
    win_fixed = win_fixed | ((torch.arange(n_window, device=dev) == anchor)
                             & no_fixed)

    loc = ms.scatter_rows(
        torch.full((max_kf,), -1, dtype=torch.int32, device=dev),
        torch.where(win_ok, win_ids, max_kf),
        torch.arange(n_window, dtype=torch.int32, device=dev))

    # Gather the window problem.
    okf_g = obs.kf[lm_ids]                                       # (Lw, O)
    okp_g = obs.kp[lm_ids].clamp_min(0).long()
    oval_g = obs.valid[lm_ids] & (okf_g >= 0) & lm_ok[:, None]
    kf_safe = okf_g.clamp_min(0).long()
    okf_local = torch.where(oval_g, loc[kf_safe], -1)
    in_win = okf_local >= 0
    obs_level = kfs.kp_level[kf_safe, okp_g]
    prob = ba.BAProblem(
        R=kfs.R[win_ids], t=kfs.t[win_ids], points=lms.pos[lm_ids],
        obs_kf=torch.where(in_win, okf_local, -1),
        obs_uv=kfs.kp_xy[kf_safe, okp_g],
        obs_w=_inv_sigma2_on(dev)[obs_level.long()],
        obs_valid=oval_g & in_win, fixed=win_fixed, lm_valid=lm_ok,
        cam_params=cam_params,
        obs_ur=(torch.where(in_win, kfs.kp_ur[kf_safe, okp_g], -1.0)
                if use_stereo else None),
        bf=float(bf) if use_stereo else None)
    # (4, 6) iterations, as the JAX package runs its per-keyframe local BA.
    res = ba.bundle_adjust(prob, model_id=model_id, stages=(4, 6))

    # Scatter back: free poses, window landmarks, inlier gating.
    scat_kf = torch.where(win_ok & ~win_fixed, win_ids, max_kf)
    kfs = kfs._replace(R=ms.scatter_rows(kfs.R, scat_kf, res.R),
                       t=ms.scatter_rows(kfs.t, scat_kf, res.t))
    scat_lm = torch.where(lm_ok, lm_ids, max_lm)
    keep = res.obs_inlier | ~in_win
    obs = obs._replace(valid=ms.scatter_rows(obs.valid, scat_lm,
                                             obs.valid[lm_ids] & keep))
    n_obs = (obs.valid & (obs.kf >= 0)).sum(-1)
    lms = lms._replace(pos=ms.scatter_rows(lms.pos, scat_lm, res.points),
                       valid=lms.valid & (n_obs >= 2),
                       n_obs=n_obs.to(torch.int32))
    return ms.MapState(kfs=kfs, lms=lms, obs=obs)


def landmark_overflow_valve(state: ms.MapState, margin: int) -> ms.MapState:
    """Capacity valve: when fewer than ``margin`` landmark slots are free,
    retire the live landmarks whose last observation is oldest (smallest
    last observing keyframe id; ties by slot, a stable sort). Their
    observation rows are cleared too: the JAX package leaves them live, a
    fault this port repairs."""
    lms, obs = state.lms, state.obs
    L = lms.valid.shape[0]
    dev = lms.valid.device
    n_free = (~lms.valid).sum()
    need = (margin - n_free).clamp_min(0)
    last_seen = torch.where(obs.valid, obs.kf, -1).amax(1)
    key = torch.where(lms.valid, last_seen, _INT32_MAX)
    order = torch.argsort(key, stable=True)              # oldest live first
    rank_kill = torch.arange(L, device=dev) < need
    kill = torch.zeros(L, dtype=torch.bool, device=dev).index_put(
        (order,), rank_kill) & lms.valid
    return state._replace(lms=lms._replace(valid=lms.valid & ~kill),
                          obs=obs._replace(valid=obs.valid & ~kill[:, None]))


def _alloc_landmark_slots(lm_valid: torch.Tensor, good: torch.Tensor):
    """A free landmark slot for each ``good`` row, in order of free-slot
    rank. Returns (slots int32, ok): ok is good and a slot was left."""
    L = lm_valid.shape[0]
    dev = lm_valid.device
    free = ~lm_valid
    n_free = free.sum()
    rank_free = torch.cumsum(free, 0) - 1
    slot_of_rank = ms.scatter_rows(
        torch.zeros(L, dtype=torch.int32, device=dev),
        torch.where(free, rank_free, L),
        torch.arange(L, dtype=torch.int32, device=dev))
    r = torch.cumsum(good, 0) - 1
    ok = good & (r < n_free)
    return slot_of_rank[r.clamp(0, L - 1)], ok


def fuse_duplicates(state: ms.MapState, kf_id, cam_params, img_w: float,
                    img_h: float) -> ms.MapState:
    """SearchInNeighbors / ORBmatcher::Fuse: project the live landmarks the
    keyframe does not see into it (K2's window mode over every landmark
    slot). A hit on a keypoint bound to another landmark is a duplicate:
    the one with fewer observations dies. A hit on a free keypoint becomes
    a new observation."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    dev = kfs.R.device
    n_lm = lms.pos.shape[0]
    n_feat = kfs.kp_xy.shape[1]
    ki = ms.slot_index(kf_id, dev)
    seen, kp_of = ms.landmarks_seen_by(state, kf_id)
    visible, proj, _, plevel = matching.frustum_cull(
        _row(kfs.R, ki), _row(kfs.t, ki), lms.pos, lms.normal, lms.min_dist,
        lms.max_dist, cam_params, img_w, img_h)
    cand = visible & lms.valid & ~seen
    radius = 3.0 * torch.pow(SCALE, plevel.to(torch.float32))
    mj, _ = matching.search_by_projection(
        proj, plevel, lms.desc, cand, _row(kfs.kp_xy, ki),
        _row(kfs.kp_level, ki), _row(kfs.kp_desc, ki),
        _row(kfs.kp_valid, ki), radius=radius, max_dist=matching.TH_LOW,
        ratio=None, level_window=(-1, 1))

    lm_ids = torch.arange(n_lm, dtype=torch.int32, device=dev)
    kp2lm = ms.scatter_rows(
        torch.full((n_feat,), -1, dtype=torch.int32, device=dev),
        torch.where(seen, kp_of, n_feat), torch.where(seen, lm_ids, -1))
    hit_kp = mj.clamp_min(0)
    other = kp2lm[hit_kp.long()]
    dup = (mj >= 0) & (other >= 0) & cand
    other_safe = other.clamp_min(0).long()
    keep_other = lms.n_obs[other_safe] >= lms.n_obs
    die = dup & keep_other                       # this landmark loses
    die = die | ms.scatter_rows(                 # the bound one loses
        torch.zeros(n_lm, dtype=torch.bool, device=dev),
        torch.where(dup & ~keep_other, other_safe, n_lm), True)
    lm_valid = lms.valid & ~die
    state = state._replace(lms=lms._replace(valid=lm_valid),
                           obs=obs._replace(valid=obs.valid
                                            & lm_valid[:, None]))
    new_obs = (mj >= 0) & (other < 0) & cand & ~die
    return ms.add_observations(state, lm_ids, kf_id, hit_kp, new_obs)


def redundancy_stats(state: ms.MapState):
    """Per keyframe (frac, seen_cnt): the share of its landmarks that at
    least 3 other keyframes observe, and its live-observation count (the
    KeyFrameCulling inputs)."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    dev = kfs.valid.device
    max_kf = kfs.valid.shape[0]
    valid_obs = obs.valid & (obs.kf >= 0) & lms.valid[:, None]
    redundant_lm = valid_obs.sum(-1) >= 4             # self + 3 others
    flat_kf = torch.where(valid_obs, obs.kf, max_kf).reshape(-1).long()
    ones = valid_obs.reshape(-1).to(torch.int32)
    red = (valid_obs & redundant_lm[:, None]).reshape(-1).to(torch.int32)
    zeros = torch.zeros(max_kf + 1, dtype=torch.int32, device=dev)
    seen_cnt = zeros.index_add(0, flat_kf, ones)[:max_kf]
    red_cnt = zeros.index_add(0, flat_kf, red)[:max_kf]
    return red_cnt / seen_cnt.clamp_min(1), seen_cnt


def drop_keyframe(state: ms.MapState, kf_id, do=True) -> ms.MapState:
    """Invalidate keyframe ``kf_id`` when ``do`` (a bool or 0-d tensor):
    clear its liveness and observations, recount the landmarks' support
    (SetBadFlag)."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    dev = kfs.valid.device
    hit = torch.arange(kfs.valid.shape[0], device=dev) == kf_id
    kf_valid = kfs.valid & ~(hit & do)
    drop = obs.valid & (obs.kf == kf_id) & do
    obs_valid = obs.valid & ~drop
    n_obs = (obs_valid & (obs.kf >= 0)).sum(-1)
    return ms.MapState(
        kfs=kfs._replace(valid=kf_valid),
        lms=lms._replace(valid=lms.valid & (n_obs >= 2),
                         n_obs=n_obs.to(torch.int32)),
        obs=obs._replace(valid=obs_valid))


def cull_keyframes(state: ms.MapState, kf_id, redundancy: float = 0.9,
                   protect_last: int = 3) -> ms.MapState:
    """KeyFrameCulling: drop at most one keyframe, the one with the largest
    share of redundantly observed landmarks if it reaches ``redundancy``.
    KF 0, the newest ``protect_last + 1`` ids, dead keyframes and those
    with fewer than 30 observations are protected."""
    kfs = state.kfs
    max_kf = kfs.valid.shape[0]
    frac, seen_cnt = redundancy_stats(state)
    ids = torch.arange(max_kf, device=kfs.valid.device)
    protected = ((ids == 0) | (ids >= kf_id - protect_last) | ~kfs.valid
                 | (seen_cnt < 30))
    score = torch.where(protected, -1.0, frac)
    c = torch.argmax(score)
    # score[c] is the maximum; indexing by a device tensor would read it
    # back to the host.
    return drop_keyframe(state, c, score.amax() >= redundancy)


def cull_candidate(state: ms.MapState, eligible: torch.Tensor,
                   min_seen: int = 30) -> torch.Tensor:
    """The best redundancy-cull candidate among the ``eligible`` keyframes,
    as the (2,) float32 ``[best_id, best_frac]`` (``best_frac`` -1 when no
    live eligible keyframe has ``min_seen`` observations): one small read
    for the caller instead of the whole redundancy table."""
    frac, seen = redundancy_stats(state)
    score = torch.where(eligible & state.kfs.valid & (seen >= min_seen),
                        frac, -1.0)
    return torch.stack([torch.argmax(score).to(torch.float32), score.amax()])


def cull_landmarks(state: ms.MapState, current_kf,
                   min_found_ratio: float = 0.25) -> ms.MapState:
    """MapPointCulling: kill landmarks found in fewer than a quarter of
    the frames that should have seen them (once seen 3 times), and young
    landmarks (2-29 keyframes old) with at most 2 observations."""
    lms = state.lms
    found_ratio = lms.n_found / lms.n_visible.clamp_min(1)
    age = current_kf - lms.first_kf
    bad = (found_ratio < min_found_ratio) & (lms.n_visible >= 3)
    bad = bad | ((age >= 2) & (lms.n_obs <= 2) & (age < 30))
    return state._replace(lms=lms._replace(valid=lms.valid & ~bad))


def keyframe_bundle(state: ms.MapState, kf_id, R, t, stamp, feats, ur,
                    bindings, cam_params, n_lm_hwm, img_w: float,
                    img_h: float, model_id: int = cam.PINHOLE,
                    use_stereo: bool = False, bf: float = 0.0,
                    n_neighbors: int = 3, n_free: int = 9,
                    n_window: int = 32, n_lm_window: int = 4096,
                    do_kf_cull: bool = True, do_local_ba: bool = True):
    """The whole per-keyframe mapping work: insert the keyframe and bind
    its observations, pick the ``n_neighbors`` best covisible keyframes,
    run the capacity valve, triangulate against each neighbour (at least 15
    shared landmarks) with device-side slot allocation, fuse duplicates,
    then the windowed local BA, landmark culling and keyframe culling.

    ``kf_id`` is the new keyframe's slot (an int or a 0-d tensor);
    ``feats`` has ``xy``, ``level``, ``angle``, ``desc``, ``valid``;
    ``bindings`` (N,) int32 is the landmark of each keypoint (-1 none).
    ``ur`` (N,) is the right-image u of each keypoint (-1 none); with
    ``use_stereo`` the local BA adds its stereo rows (``bf`` a Python
    float) and the valve keeps room for two frames' worth of landmarks, as
    a stereo keyframe also back-projects its depths after the bundle.
    Returns (state', bindings', info, culled): info is [parent,
    parent_count, n_lm_hwm', R_kf (9), t_kf (3)] as float32 (15,), culled
    the (K,) mask of keyframes this call dropped."""
    dev = feats.xy.device
    n_feat = feats.xy.shape[0]
    ki = ms.slot_index(kf_id, dev)
    state = ms.add_keyframe(state, kf_id, R, t, stamp, feats, ur=ur)
    kp_idx = torch.arange(n_feat, dtype=torch.int32, device=dev)
    state = ms.add_observations(state, bindings.clamp_min(0), kf_id, kp_idx,
                                bindings >= 0)

    max_kf = state.kfs.valid.shape[0]
    counts = ms.covisibility_counts(state, kf_id, max_kf)
    counts = torch.where(state.kfs.valid, counts, 0).index_fill(0, ki, 0)
    cv, ci = matching.top_k_lowest_first(counts, n_neighbors)

    # The valve runs after this keyframe's observations bind, so its
    # landmarks rank newest and survive.
    state = landmark_overflow_valve(state,
                                    2 * n_feat if use_stereo else n_feat)

    free_kp = feats.valid & (bindings < 0)
    hwm = torch.full((), n_lm_hwm, dtype=torch.int64, device=dev)
    for i in range(n_neighbors):
        nb = ci[i:i + 1]
        ok_nb = cv[i] >= 15
        kfs = state.kfs
        res = triangulate_pair(
            _row(kfs.R, ki), _row(kfs.t, ki), feats.xy, feats.level,
            feats.desc, free_kp & ok_nb,
            _row(kfs.R, nb), _row(kfs.t, nb), _row(kfs.kp_xy, nb),
            _row(kfs.kp_level, nb), _row(kfs.kp_desc, nb),
            _row(kfs.kp_valid, nb) & ok_nb, cam_params, model_id=model_id)
        slots, ok = _alloc_landmark_slots(state.lms.valid, res.good)
        state = ms.add_landmarks(state, slots, res.pos, res.desc, kf_id,
                                 res.kp_a, nb[0], res.kp_b, ok, res.normal,
                                 res.min_dist, res.max_dist)
        bindings = ms.scatter_rows(bindings, torch.where(ok, res.kp_a, n_feat),
                                   torch.where(ok, slots, -1))
        free_kp = feats.valid & (bindings < 0)
        hwm = torch.maximum(hwm, torch.where(ok, slots + 1, 0).amax())

    state = fuse_duplicates(state, kf_id, cam_params, img_w, img_h)
    if do_local_ba:
        state = windowed_local_ba(state, kf_id, cam_params, model_id=model_id,
                                  use_stereo=use_stereo, bf=bf,
                                  n_free=n_free, n_window=n_window,
                                  n_lm_window=n_lm_window)
        state = cull_landmarks(state, kf_id)
    valid_pre = state.kfs.valid
    if do_kf_cull:
        state = cull_keyframes(state, kf_id)
    culled = valid_pre & ~state.kfs.valid

    # Fusion, BA and culling may have killed landmarks bound to this frame.
    lmv = state.lms.valid
    bindings = torch.where((bindings >= 0) & lmv[bindings.clamp_min(0).long()],
                           bindings, -1)
    info = torch.cat([
        ci[:1].to(torch.float32), cv[:1].to(torch.float32),
        hwm.reshape(1).to(torch.float32),
        _row(state.kfs.R, ki).reshape(-1), _row(state.kfs.t, ki)])
    return state, bindings, info, culled
