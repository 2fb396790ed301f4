"""The inertial device path: IMU windows, pose-inertial tracking and the
visual-inertial bundle adjustments.

Port of the module-level parts of ``orbslam3_byzyh_tpu/pipeline/
inertial_system.py`` (``FRAME_STEPS``, ``KF_STEPS``, ``ImuConfig``,
``ImuBuffer``, ``make_steps``, ``body_from_cam``, ``cam_from_body``,
``_gather_viba_visual``, ``_scatter_viba``) and, as free functions, the
device work of ``MonoInertialSlam``'s methods:

  * :func:`track_inertial`: ``_track_inertial`` up to and including its
    one packed read (the frame window's preintegration, the IMU
    prediction, the motion model from it with the device-side fallback to
    the prediction, the local map with stereo rows, the pose-inertial
    optimization, the found counters, ``ref_kf_matches``, the close-point
    counters);
  * :func:`build_viba` / :func:`apply_viba` (``_build_viba`` /
    ``_apply_viba``), :func:`local_inertial_ba` and
    :func:`full_inertial_ba`;
  * :func:`inertial_refit` (``_inertial_refit``) and
    :func:`rebase_gravity_scale` on the map state.

The per-keyframe inertial arrays travel in an :class:`InertialMap`: the
map state, the device-resident velocities and biases, and the host-side
chain (``kf_prev``), preintegrations and stamps. The system class that
holds the IMU schedule, the chain culling and the trajectory log is not
ported yet. Every function here runs on the tensors' device; the host
reads are the ones named in each docstring.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..models import map_state as ms
from ..ops import imu, matching
from ..solver import inertial, inertial_ba
from ..utils import cuda_graph
from . import tracking

# Preintegration capacities of the JAX package (the windows' static shapes).
FRAME_STEPS = 32      # samples per camera frame (200 Hz / 20 fps = ~10)
KF_STEPS = 512        # samples per keyframe interval (<= ~2.5 s)


@dataclasses.dataclass
class ImuConfig:
    """IMU calibration (IMU::Calib). ``T_bc``: 4x4 body <- camera
    (``IMU.T_b_c1``). The noise densities are continuous-time; the
    per-sample discrete covariance scales by the rate."""

    T_bc: np.ndarray
    gyro_noise: float = 1.7e-4
    acc_noise: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    freq: float = 200.0

    def noise_cov(self) -> np.ndarray:
        d = np.array([self.gyro_noise ** 2 * self.freq] * 3
                     + [self.acc_noise ** 2 * self.freq] * 3, np.float32)
        return np.diag(d)

    def walk_cov(self) -> np.ndarray:
        d = np.array([self.gyro_walk ** 2 / self.freq] * 3
                     + [self.acc_walk ** 2 / self.freq] * 3, np.float32)
        return np.diag(d)

    def walk_var(self) -> np.ndarray:
        return np.array([self.gyro_walk ** 2] * 3 + [self.acc_walk ** 2] * 3,
                        np.float32)


class ImuBuffer:
    """Append-only IMU sample store with O(log n) window queries."""

    def __init__(self, capacity: int = 4096):
        self.n = 0
        self.t = np.zeros(capacity, np.float64)
        self.gyr = np.zeros((capacity, 3), np.float32)
        self.acc = np.zeros((capacity, 3), np.float32)

    def append(self, t, gyr, acc):
        t = np.atleast_1d(np.asarray(t, np.float64))
        gyr = np.atleast_2d(np.asarray(gyr, np.float32))
        acc = np.atleast_2d(np.asarray(acc, np.float32))
        m = len(t)
        while self.n + m > len(self.t):
            self.t = np.concatenate([self.t, np.zeros_like(self.t)])
            self.gyr = np.concatenate([self.gyr, np.zeros_like(self.gyr)])
            self.acc = np.concatenate([self.acc, np.zeros_like(self.acc)])
        self.t[self.n:self.n + m] = t
        self.gyr[self.n:self.n + m] = gyr
        self.acc[self.n:self.n + m] = acc
        self.n += m

    def window(self, t0: float, t1: float):
        lo = np.searchsorted(self.t[:self.n], t0, "right")
        hi = np.searchsorted(self.t[:self.n], t1, "right")
        return (self.t[lo:hi], self.gyr[lo:hi], self.acc[lo:hi])


def make_steps(ts, gyr, acc, t0: float, t1: float, n_pad: int):
    """Midpoint integration steps over (t0, t1] with boundary splitting
    (Tracking::PreintegrateIMU), padded to ``n_pad`` (dt == 0 rows are
    no-ops). Returns (acc, gyr, dts) as numpy."""
    m = len(ts)
    if m == 0:
        dts = np.array([t1 - t0], np.float32)
        g = gyr[:1] if len(gyr) else np.zeros((1, 3), np.float32)
        a = acc[:1] if len(acc) else np.zeros((1, 3), np.float32)
    else:
        times = np.concatenate([[t0], ts, [t1]])
        dts = np.diff(times).astype(np.float32)
        g = np.concatenate([gyr[:1], 0.5 * (gyr[:-1] + gyr[1:]), gyr[-1:]])
        a = np.concatenate([acc[:1], 0.5 * (acc[:-1] + acc[1:]), acc[-1:]])
    k = len(dts)
    if k > n_pad:  # subsample coarsely (not at nominal rates)
        idx = np.linspace(0, k - 1, n_pad).round().astype(int)
        scale = dts.sum() / max(dts[idx].sum(), 1e-9)
        dts, g, a = dts[idx] * scale, g[idx], a[idx]
        k = n_pad
    pad = n_pad - k
    dts = np.pad(dts, (0, pad))
    g = np.pad(g.astype(np.float32), ((0, pad), (0, 0)))
    a = np.pad(a.astype(np.float32), ((0, pad), (0, 0)))
    return a, g, dts


def body_from_cam(R_cw, t_cw, R_bc, t_bc):
    """(R_wb, p_w) from a world -> camera pose and body <- camera
    extrinsics (numpy or tensors)."""
    R_bw = R_bc @ R_cw
    t_bw = R_bc @ t_cw + t_bc
    return R_bw.T, -(R_bw.T @ t_bw)


def body_from_cam_batch(R_cw, t_cw, R_bc, t_bc):
    """:func:`body_from_cam` of (K, 3, 3) / (K, 3) poses."""
    R_bw = R_bc @ R_cw
    t_bw = t_cw @ R_bc.T + t_bc
    R_wb = R_bw.transpose(-1, -2)
    return R_wb, -(R_wb @ t_bw[..., None])[..., 0]


def cam_from_body(R_wb, p_w, R_cb, t_cb):
    R_cw = R_cb @ R_wb.T
    return R_cw, t_cb - R_cw @ p_w


def walk_info(walk_var: np.ndarray, dt: float) -> np.ndarray:
    """The bias random walk's information over ``dt`` s (``_walk_info``)."""
    return (1.0 / (walk_var * max(dt, 1e-3))).astype(np.float32)


# --- The system's constants on the device -----------------------------------

class ViContext(NamedTuple):
    """What the inertial functions need of the system's configuration, on
    the device (:func:`make_context`)."""

    R_bc: torch.Tensor          # (3, 3) body <- camera
    t_bc: torch.Tensor
    R_cb: torch.Tensor          # (3, 3) camera <- body
    t_cb: torch.Tensor
    noise_cov: torch.Tensor     # (6, 6) per-sample
    walk_cov: torch.Tensor      # (6, 6) per-sample
    walk_var: np.ndarray        # (6,) host, for walk_info
    cam_params: torch.Tensor    # (4,) pinhole
    bf: float | None            # baseline x fx; None: no stereo rows
    depth_threshold: float      # the close-point depth (0 for mono)
    width: int
    height: int
    window: dict                # the local window's sizes (frame step)
    kf_ref_min_obs: int
    viba_window: int            # keyframes of the local VI-BA window
    viba_free: int              # of which the newest are free
    viba_landmarks: int         # landmark slots of a VI-BA
    full_viba_kf: int           # keyframes of the full VI-BA


def make_context(imu_cfg: ImuConfig, cam_params, bf, depth_threshold: float,
                 width: int, height: int, window: dict,
                 kf_ref_min_obs: int, viba_window: int = 24,
                 viba_free: int = 10, viba_landmarks: int = 4096,
                 full_viba_kf: int = 64, device=None) -> ViContext:
    """A :class:`ViContext` on ``device`` (``None``: the card)."""
    dev = device_mod.resolve(device)
    T = np.asarray(imu_cfg.T_bc, np.float32)
    R_bc, t_bc = T[:3, :3], T[:3, 3]
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    return ViContext(
        R_bc=f32(R_bc), t_bc=f32(t_bc), R_cb=f32(R_bc.T),
        t_cb=f32(-R_bc.T @ t_bc), noise_cov=f32(imu_cfg.noise_cov()),
        walk_cov=f32(imu_cfg.walk_cov()), walk_var=imu_cfg.walk_var(),
        cam_params=f32(np.asarray(cam_params)), bf=bf,
        depth_threshold=float(depth_threshold), width=int(width),
        height=int(height), window=dict(window),
        kf_ref_min_obs=int(kf_ref_min_obs), viba_window=viba_window,
        viba_free=viba_free, viba_landmarks=viba_landmarks,
        full_viba_kf=full_viba_kf)


def preintegrate(ts, gyr, acc, t0: float, t1: float, bias, n_pad: int,
                 ctx: ViContext, extra=None):
    """``_preintegrate``: the window's steps (:func:`make_steps`) built on
    the host, its real rows (dt > 0) padded with dt == 0 rows (no-ops, as
    in the JAX scan) to :func:`cuda_graph.bucket`'s next power of two from
    8 (so a CUDA graph serves every window of that size, and a window of
    more than 8 samples costs less than twice its samples), uploaded with the linearization bias in one
    copy, and integrated on the device. ``extra`` (a float32 array) rides
    in the same copy. Returns (PreintState, extra on the device or
    None)."""
    a, g, dts = make_steps(ts, gyr, acc, t0, t1, n_pad)
    keep = dts > 0
    k = cuda_graph.bucket(max(int(keep.sum()), 1), 8, n_pad)
    steps = np.zeros((k, 7), np.float32)
    real = np.concatenate([a[keep], g[keep], dts[keep, None]], 1)
    steps[:len(real)] = real
    extra = np.zeros(0, np.float32) if extra is None else np.asarray(
        extra, np.float32).reshape(-1)
    pack = np.concatenate([steps.reshape(-1), np.asarray(
        bias, np.float32).reshape(6), extra]).astype(np.float32)
    dev = ctx.cam_params.device
    up = device_mod.upload(pack, dev)
    steps = up[:7 * k].reshape(k, 7)
    bias_d = up[7 * k:7 * k + 6]
    pre = imu.integrate(steps[:, :3], steps[:, 3:6], steps[:, 6], bias_d,
                        ctx.noise_cov, ctx.walk_cov)
    return pre, (up[7 * k + 6:] if len(extra) else None)


def chain(kf_prev: np.ndarray, kf_id: int, max_len: int = 100000) -> list:
    """The temporal chain ending at ``kf_id``, oldest first."""
    ids = []
    k = kf_id
    while k >= 0 and len(ids) < max_len:
        ids.append(k)
        k = int(kf_prev[k])
    return ids[::-1]


# --- The frame step ---------------------------------------------------------

class ViFrameResult(NamedTuple):
    """:func:`track_inertial`'s result: ``info`` on the host, the rest on
    the device."""

    info: np.ndarray          # (20 or 22,) the one read, see track_inertial
    pose_inertial: inertial.PoseInertialResult
    bindings: torch.Tensor    # (N,) the inliers' landmarks, -1 elsewhere
    track: tracking.TrackResult   # the local map's result
    R_pred: torch.Tensor      # the IMU prediction of the body state
    v_pred: torch.Tensor
    p_pred: torch.Tensor
    used_prediction: torch.Tensor  # () the motion model's fallback taken
    n_found: torch.Tensor     # (L,) the counters after the frame
    n_visible: torch.Tensor


def track_inertial(feats, ur, depth, last_bind, last_desc, last_angle,
                   lms: ms.Landmarks, obs: ms.Observations, n_kf: int,
                   last_kf_id: int, body, bias: np.ndarray, imu_window,
                   t0: float, t1: float, ctx: ViContext, prior_H=None,
                   prior_L=None) -> ViFrameResult:
    """``MonoInertialSlam._track_inertial``'s device work on the frame's
    features ``feats`` (with the right-image u ``ur`` and ``depth``, -1
    where none, or None for a mono rig), against the map's landmarks
    ``lms`` and observations ``obs`` with ``n_kf`` live keyframes:

      1. the frame window's preintegration (``imu_window`` = the buffer's
         (ts, gyr, acc) in (t0, t1], numpy) at the host-known ``bias`` and
         the IMU prediction of the body state from ``body`` = (R_wb, p_w,
         v_w) tensors;
      2. ``track_motion_model`` from the predicted camera pose (K2, K3);
         with fewer than 10 inliers the prediction is selected on the
         device;
      3. ``track_local_map_windowed`` with the stereo rows (K2, K3s);
      4. ``pose_inertial_optimization``: the LastKeyFrame variant, or with
         ``prior_H`` (the last frame's ``H_marg``) the LastFrame variant
         (``prior_L`` its :func:`inertial.prior_sqrt`, computed by the
         caller before it queued this frame's work);
      5. the epilogue: the found / visible counters (when at least 15
         inliers), ``ref_kf_matches`` of ``last_kf_id``, the close-point
         counters, and the one read of

           info = [n_inliers, ref_matches, R_cw (9), t_cw (3), bg (3),
                   ba (3)] + [close tracked, close untracked] with depth.
    """
    dev = feats.xy.device
    R_wb, p_w, v_w = body
    pre_f, walk_d = preintegrate(*imu_window, t0, t1, bias, FRAME_STEPS,
                                 ctx, extra=walk_info(ctx.walk_var, t1 - t0))
    bias_j = pre_f.bias
    R_pred, v_pred, p_pred = imu.predict_state(R_wb, v_w, p_w, pre_f, bias_j)
    Rc_pred, tc_pred = cam_from_body(R_pred, p_pred, ctx.R_cb, ctx.t_cb)

    res = tracking.track_motion_model(
        Rc_pred, tc_pred, lms.pos, lms.valid, last_bind, last_desc,
        feats.xy, feats.level, feats.desc, feats.valid, ctx.cam_params,
        last_angle=last_angle, feats_angle=feats.angle)
    # The IMU prediction when the projection match is thin: a select on
    # the device, not a host branch.
    ok_mm = res.n_inliers >= tracking.RETRY_BELOW
    res = res._replace(R=torch.where(ok_mm, res.R, Rc_pred),
                       t=torch.where(ok_mm, res.t, tc_pred))
    use_stereo = ctx.bf is not None and ur is not None
    res = tracking.track_local_map_windowed(
        res.R, res.t, res.bindings, lms.pos, lms.desc, lms.normal,
        lms.min_dist, lms.max_dist, lms.valid, obs.kf, obs.valid, n_kf,
        feats.xy, feats.level, feats.desc, feats.valid,
        ur if use_stereo else None, ctx.bf if use_stereo else None,
        ctx.cam_params, ctx.width, ctx.height, use_stereo=use_stereo,
        **ctx.window)

    # The joint visual-inertial pose (PoseInertialOptimizationLastFrame).
    bind = res.bindings
    has = (bind >= 0) & feats.valid
    pts_w = lms.pos[bind.clamp_min(0).long()]
    inv_s2 = tracking._inv_sigma2_on(dev)[feats.level.long()]
    Rb0, pb0 = body_from_cam(res.R, res.t, ctx.R_bc, ctx.t_bc)
    bg0, ba0 = bias_j[:3], bias_j[3:]
    pr = inertial.pose_inertial_optimization(
        Rb0, pb0, v_pred, bg0, ba0, R_wb, p_w, v_w, bg0, ba0, pre_f, pts_w,
        feats.xy, inv_s2, has, ctx.cam_params, ctx.R_cb, ctx.t_cb, walk_d,
        prior_H=prior_H, obs_ur=ur if use_stereo else None,
        bf=ctx.bf if use_stereo else None, with_prior=prior_H is not None,
        prior_L=prior_L)

    # The epilogue and its one read.
    ok = pr.n_inliers >= 15
    bindings = torch.where(pr.inlier, bind, -1)
    Rc_d, tc_d = cam_from_body(pr.R, pr.p, ctx.R_cb, ctx.t_cb)
    n_lm = lms.pos.shape[0]
    add = torch.zeros(n_lm, dtype=torch.int32, device=dev).index_add(
        0, bindings.clamp_min(0).long(),
        ((bindings >= 0) & ok).to(torch.int32))
    ref_matches = tracking.ref_kf_matches(obs.kf, obs.valid, last_kf_id,
                                          ctx.kf_ref_min_obs)
    parts = [torch.stack([pr.n_inliers, ref_matches]).to(torch.float32),
             Rc_d.reshape(-1), tc_d, pr.bg, pr.ba]
    if depth is not None:
        # The stereo close-point counters (c1c).
        close = (depth > 0) & (depth < ctx.depth_threshold) & feats.valid
        tracked = bindings >= 0
        parts.append(torch.stack([(close & tracked).sum(),
                                  (close & ~tracked).sum()]).to(
                                      torch.float32))
    (info,) = device_mod.read(torch.cat(parts))   # the frame's one read
    return ViFrameResult(
        info=info, pose_inertial=pr, bindings=bindings, track=res,
        R_pred=R_pred, v_pred=v_pred, p_pred=p_pred,
        used_prediction=~ok_mm, n_found=lms.n_found + add,
        n_visible=lms.n_visible + add)


# --- The visual-inertial bundle adjustments ---------------------------------

class InertialMap(NamedTuple):
    """The map and its per-keyframe inertial state."""

    state: ms.MapState
    kf_vel: torch.Tensor       # (max_kf, 3) body velocities
    kf_bg: torch.Tensor        # (max_kf, 3) gyro biases
    kf_ba: torch.Tensor        # (max_kf, 3) accel biases
    kf_prev: np.ndarray        # (max_kf,) int32 chain predecessor, -1 none
    kf_preint: list            # per slot: PreintState prev -> this, or None
    kf_stamp: np.ndarray       # (max_kf,) float64 host stamps


def _gather_viba_visual(state: ms.MapState, ids, loc, free_kf_mask, kf_vel,
                        kf_bg, kf_ba, R_bc, t_bc, l_slots: int,
                        use_stereo: bool):
    """The device gather of a VI-BA window's states, window landmarks (the
    ``l_slots`` lowest-id landmarks seen by a free keyframe) and their
    observations in window indices."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    ids_safe = ids.clamp_min(0).long()
    R_wb, p_w = body_from_cam_batch(kfs.R[ids_safe], kfs.t[ids_safe], R_bc,
                                    t_bc)

    obs_live = obs.valid & (obs.kf >= 0)
    in_free = obs_live & free_kf_mask[obs.kf.clamp_min(0).long()]
    lm_in = in_free.any(-1) & lms.valid
    score, lsel = matching.top_k_lowest_first(lm_in.to(torch.int32), l_slots)
    lm_valid = score > 0
    okf = obs.kf[lsel]
    okp = obs.kp[lsel].clamp_min(0).long()
    oval = obs.valid[lsel] & (okf >= 0) & lm_valid[:, None]
    okf_local = torch.where(oval, loc[okf.clamp_min(0).long()], -1)
    o_valid = oval & (okf_local >= 0)
    gkf = okf.clamp_min(0).long()
    obs_uv = kfs.kp_xy[gkf, okp]
    obs_w = tracking._inv_sigma2_on(R_wb.device)[kfs.kp_level[gkf, okp].long()]
    obs_ur = (torch.where(o_valid, kfs.kp_ur[gkf, okp], -1.0)
              if use_stereo else None)
    return (R_wb, p_w, kf_vel[ids_safe], kf_bg[ids_safe], kf_ba[ids_safe],
            lms.pos[lsel], torch.where(o_valid, okf_local, -1), obs_uv,
            obs_w, o_valid, lm_valid, lsel, obs_ur)


def _scatter_viba(state: ms.MapState, res: inertial_ba.VIBAResult, ids,
                  free_rows, lsel, lm_valid, o_valid, R_cb, t_cb, kf_vel,
                  kf_bg, kf_ba):
    """The device write-back of a VI-BA result: the free keyframes' poses,
    velocities and biases, the window landmarks and their inlier gating."""
    R_cw, t_cw = inertial_ba.camera_pose(res.R_wb, res.p_w, R_cb, t_cb)
    max_kf = state.kfs.valid.shape[0]
    tgt = torch.where(free_rows, ids.clamp_min(0), max_kf)
    kfs = state.kfs._replace(R=ms.scatter_rows(state.kfs.R, tgt, R_cw),
                             t=ms.scatter_rows(state.kfs.t, tgt, t_cw))
    max_lm = state.lms.pos.shape[0]
    lm_tgt = torch.where(lm_valid, lsel, max_lm)
    lms = state.lms._replace(pos=ms.scatter_rows(state.lms.pos, lm_tgt,
                                                 res.points))
    keep = res.obs_inlier | ~o_valid
    obs = state.obs._replace(valid=ms.scatter_rows(
        state.obs.valid, lm_tgt, state.obs.valid[lsel] & keep))
    return (ms.MapState(kfs=kfs, lms=lms, obs=obs),
            ms.scatter_rows(kf_vel, tgt, res.v_w),
            ms.scatter_rows(kf_bg, tgt, res.bg),
            ms.scatter_rows(kf_ba, tgt, res.ba))


class VibaWindow(NamedTuple):
    """What :func:`apply_viba` needs of a built window."""

    ids: torch.Tensor          # (K,) keyframe slot of each window row
    free_rows: torch.Tensor    # (K,) bool
    lsel: torch.Tensor         # (l_slots,) landmark ids
    lm_valid: torch.Tensor
    o_valid: torch.Tensor


def build_viba(imap: InertialMap, ids, free_ids, n_slots: int, l_slots: int,
               prior_bias, walk_dt: float, ctx: ViContext):
    """``_build_viba``: a window of keyframes ``ids`` (``free_ids`` free)
    packed into a fixed-shape :class:`inertial_ba.VIBAProblem` of
    ``n_slots`` keyframes and ``l_slots`` landmarks. The host builds the
    small parts (ids, local index, chain edges) and uploads them in one
    copy; the states, landmarks and observations are gathered on the
    device. Returns (problem, VibaWindow)."""
    max_kf = imap.kf_vel.shape[0]
    K = n_slots
    free_set = set(int(f) for f in free_ids)
    loc = np.full(max_kf, -1, np.int32)
    ids_arr = np.zeros(K, np.int32)
    fixed = np.ones(K, bool)
    free_kf_mask = np.zeros(max_kf, bool)
    for i, k in enumerate(ids):
        loc[k] = i
        ids_arr[i] = k
        fixed[i] = k not in free_set
        free_kf_mask[k] = k in free_set
    # Inertial edges between chain-consecutive keyframes of the window.
    E = K - 1
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ev = np.zeros(E, bool)
    pre_list = []
    for k in ids:
        p = int(imap.kf_prev[k])
        if (p >= 0 and loc[p] >= 0 and imap.kf_preint[k] is not None
                and len(pre_list) < E):
            ei[len(pre_list)], ej[len(pre_list)] = loc[p], loc[k]
            ev[len(pre_list)] = True
            pre_list.append(imap.kf_preint[k])
    dev = imap.kf_vel.device
    if len(pre_list) < E:
        dummy = imu.init_state(torch.zeros(6, device=dev))
        pre_list += [dummy] * (E - len(pre_list))
    preints = imu.stack(pre_list)

    ints = device_mod.upload(np.concatenate([
        loc, ids_arr, fixed, free_kf_mask, ei, ej, ev]).astype(np.int32), dev)
    floats = device_mod.upload(np.concatenate([
        walk_info(ctx.walk_var, walk_dt),
        np.asarray(prior_bias, np.float32)]), dev)
    o = np.cumsum([0, max_kf, K, K, max_kf, E, E, E])
    loc_d, ids_d = ints[o[0]:o[1]], ints[o[1]:o[2]]
    fixed_d, free_d = ints[o[2]:o[3]] > 0, ints[o[3]:o[4]] > 0
    ei_d, ej_d, ev_d = ints[o[4]:o[5]], ints[o[5]:o[6]], ints[o[6]:o[7]] > 0

    use_stereo = ctx.bf is not None
    (R_wb, p_w, v_w, bg, ba, points, obs_kf, obs_uv, obs_w, o_valid,
     lm_valid, lsel, obs_ur) = _gather_viba_visual(
        imap.state, ids_d, loc_d, free_d, imap.kf_vel, imap.kf_bg,
        imap.kf_ba, ctx.R_bc, ctx.t_bc, l_slots, use_stereo)
    prob = inertial_ba.VIBAProblem(
        R_wb=R_wb, p_w=p_w, v_w=v_w, bg=bg, ba=ba, points=points,
        obs_kf=obs_kf, obs_uv=obs_uv, obs_w=obs_w, obs_valid=o_valid,
        lm_valid=lm_valid, edges_i=ei_d, edges_j=ej_d, preints=preints,
        edge_valid=ev_d, walk_info=floats[:6], R_cb=ctx.R_cb, t_cb=ctx.t_cb,
        cam_params=ctx.cam_params, fixed=fixed_d, prior_bias_w=floats[6:8],
        obs_ur=obs_ur,
        bf=(torch.full((), float(ctx.bf), device=dev) if use_stereo
            else None))
    return prob, VibaWindow(ids=ids_d, free_rows=~fixed_d, lsel=lsel,
                            lm_valid=lm_valid, o_valid=o_valid)


def apply_viba(imap: InertialMap, res: inertial_ba.VIBAResult,
               win: VibaWindow, ctx: ViContext) -> InertialMap:
    """``_apply_viba``: the result written back on the device."""
    state, kf_vel, kf_bg, kf_ba = _scatter_viba(
        imap.state, res, win.ids, win.free_rows, win.lsel, win.lm_valid,
        win.o_valid, ctx.R_cb, ctx.t_cb, imap.kf_vel, imap.kf_bg, imap.kf_ba)
    return imap._replace(state=state, kf_vel=kf_vel, kf_bg=kf_bg,
                         kf_ba=kf_ba)


def _window_dt(imap: InertialMap, ids) -> float:
    return max(float(imap.kf_stamp[ids[-1]] - imap.kf_stamp[ids[0]]),
               1e-2) / max(len(ids), 1)


def local_inertial_ba(imap: InertialMap, kf_id: int, map_first_kf: int,
                      ctx: ViContext) -> InertialMap:
    """``_local_inertial_ba`` (LocalInertialBA): the chain's last
    ``viba_window`` keyframes, the newest ``viba_free`` free (never the
    map's first), ``viba_landmarks`` landmark slots, stages (4, 6). No
    host read."""
    ids = chain(imap.kf_prev, kf_id, max_len=ctx.viba_window)
    ids = ids[-ctx.viba_window:]
    free_ids = [k for k in ids[-ctx.viba_free:] if k != map_first_kf]
    if not free_ids:
        return imap
    prob, win = build_viba(imap, ids, free_ids, ctx.viba_window,
                           ctx.viba_landmarks, (0.0, 0.0),
                           _window_dt(imap, ids), ctx)
    res = inertial_ba.vi_bundle_adjust(prob, stages=(4, 6))
    return apply_viba(imap, res, win, ctx)


def full_inertial_ba(imap: InertialMap, kf_id: int, prior_g: float,
                     prior_a: float, ctx: ViContext) -> InertialMap:
    """``_full_inertial_ba`` (FullInertialBA): the chain's last
    ``full_viba_kf`` keyframes, all but the oldest free, the bias prior
    (prior_g, prior_a) on the oldest, stages (5, 10). No host read."""
    ids = chain(imap.kf_prev, kf_id)[-ctx.full_viba_kf:]
    prob, win = build_viba(imap, ids, ids[1:], ctx.full_viba_kf,
                           ctx.viba_landmarks, (prior_g, prior_a),
                           _window_dt(imap, ids), ctx)
    res = inertial_ba.vi_bundle_adjust(prob, stages=(5, 10))
    return apply_viba(imap, res, win, ctx)


def rebase_gravity_scale(state: ms.MapState, R_gw: torch.Tensor,
                         s: float) -> ms.MapState:
    """``_rebase_gravity_scale`` on the map: x' = s R_gw x on the
    landmarks; the keyframes follow (R_cw' = R_cw R_gw^T, t_cw' = s t_cw).
    The trajectory log's rescale belongs to the system."""
    kfs, lms = state.kfs, state.lms
    R_wg = R_gw.T
    return state._replace(
        kfs=kfs._replace(R=kfs.R @ R_wg, t=s * kfs.t),
        lms=lms._replace(pos=s * lms.pos @ R_wg, normal=lms.normal @ R_wg,
                         min_dist=s * lms.min_dist,
                         max_dist=s * lms.max_dist))


class RefitResult(NamedTuple):
    """:func:`inertial_refit`'s solve: on the device, with its scale read."""

    scale: float               # the host read (nan when not solved)
    solve: inertial.InertialInitResult | None
    bias: np.ndarray | None    # (6,) [bg, ba] read with the scale


def inertial_refit(imap: InertialMap, kf_id: int, prior_g: float,
                   prior_a: float, fix_scale: bool, ctx: ViContext):
    """``_inertial_refit`` (InertialOptimization + ApplyScaledRotation):
    the inertial-only MAP of gravity, scale, biases and velocities over the
    chain ending at ``kf_id`` with the visual map frozen, then the map's
    rebase, the chain's velocities (rotated into the new world) and biases.
    The body states come from the camera poses on the device; the one host
    read is the scale with the biases. Returns (imap', RefitResult); the
    map is unchanged when the chain is too short (scale nan) or the scale
    is not finite or below 0.1."""
    ids = chain(imap.kf_prev, kf_id)
    if len(ids) < 3 or any(imap.kf_preint[k] is None for k in ids[1:]):
        return imap, RefitResult(float("nan"), None, None)
    dev = imap.kf_vel.device
    rows = device_mod.upload(np.asarray(ids, np.int64), dev)
    R_wb, p_w = body_from_cam_batch(imap.state.kfs.R[rows],
                                    imap.state.kfs.t[rows], ctx.R_bc,
                                    ctx.t_bc)
    preints = imu.stack([imap.kf_preint[k] for k in ids[1:]])
    res = inertial.inertial_only_optimization(
        R_wb, p_w, preints, prior_g=prior_g, prior_a=prior_a,
        fix_scale=fix_scale)
    out = device_mod.read(torch.cat([res.scale[None], res.bg, res.ba]))[0]
    scale = float(out[0])
    fit = RefitResult(scale, res, out[1:7].copy())
    if not np.isfinite(scale) or scale < 1e-1:
        return imap, fit
    R_gw = res.R_wg.T
    state = rebase_gravity_scale(imap.state, R_gw, scale)
    vel = res.vel @ R_gw.T
    n = len(ids)
    return imap._replace(
        state=state,
        kf_vel=imap.kf_vel.index_put((rows,), vel),
        kf_bg=imap.kf_bg.index_put((rows,), res.bg.expand(n, 3)),
        kf_ba=imap.kf_ba.index_put((rows,), res.ba.expand(n, 3))), fit
