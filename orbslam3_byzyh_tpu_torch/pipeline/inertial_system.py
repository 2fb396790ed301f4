"""The inertial device path: IMU windows, pose-inertial tracking and the
visual-inertial bundle adjustments.

Port of the module-level parts of ``orbslam3_byzyh_tpu/pipeline/
inertial_system.py`` (``FRAME_STEPS``, ``KF_STEPS``, ``ImuConfig`` (kept in
``ops/imu.py``, imported here),
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
chain (``kf_prev``), preintegrations and stamps. Every function here runs
on the tensors' device; the host reads are the ones named in each
docstring.

:class:`MonoInertialSlam` (the JAX class of the same name) is the system
over them: the frame loop with its IMU buffer, the keyframe chain, the
IMU schedule, the chain-aware culling and the trajectory rescale. The
stereo-inertial system is ``pipeline/stereo_inertial.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..models import map_state as ms
from ..ops import imu, matching
from ..ops.imu import ImuConfig  # noqa: F401  (the system's argument)
from ..solver import inertial, inertial_ba
from ..utils import cuda_graph, verbose
from . import mapping, tracking
from . import system as system_mod

# Preintegration capacities of the JAX package (the windows' static shapes).
FRAME_STEPS = 32      # samples per camera frame (200 Hz / 20 fps = ~10)
KF_STEPS = 512        # samples per keyframe interval (<= ~2.5 s)


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
                   prior_L=None, stage=None) -> ViFrameResult:
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
    stage = stage or (lambda name: contextlib.nullcontext())
    R_wb, p_w, v_w = body
    with stage("imu_preint"):
        pre_f, walk_d = preintegrate(*imu_window, t0, t1, bias, FRAME_STEPS,
                                     ctx, extra=walk_info(ctx.walk_var,
                                                          t1 - t0))
        bias_j = pre_f.bias
        R_pred, v_pred, p_pred = imu.predict_state(R_wb, v_w, p_w, pre_f,
                                                   bias_j)
    Rc_pred, tc_pred = cam_from_body(R_pred, p_pred, ctx.R_cb, ctx.t_cb)

    with stage("pose_pred"):
        res = tracking.track_motion_model(
            Rc_pred, tc_pred, lms.pos, lms.valid, last_bind, last_desc,
            feats.xy, feats.level, feats.desc, feats.valid, ctx.cam_params,
            last_angle=last_angle, feats_angle=feats.angle)
    with stage("lm_track"):
        # The IMU prediction when the projection match is thin: a select
        # on the device, not a host branch.
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
    velocities and biases, the window landmarks and their inlier gating.

    A repaired fault of the reference: the JAX write-back gates the outlier
    observations off but leaves ``n_obs`` and the liveness as they were, so
    a landmark can stay live with no live observation. Here a window
    landmark that lost an observation to the gate is recounted as
    ``mapping.drop_keyframe`` recounts, and dies below 2 live observations;
    the others keep their count and liveness."""
    R_cw, t_cw = inertial_ba.camera_pose(res.R_wb, res.p_w, R_cb, t_cb)
    max_kf = state.kfs.valid.shape[0]
    tgt = torch.where(free_rows, ids.clamp_min(0), max_kf)
    kfs = state.kfs._replace(R=ms.scatter_rows(state.kfs.R, tgt, R_cw),
                             t=ms.scatter_rows(state.kfs.t, tgt, t_cw))
    max_lm = state.lms.pos.shape[0]
    lm_tgt = torch.where(lm_valid, lsel, max_lm)
    keep = res.obs_inlier | ~o_valid
    before = state.obs.valid[lsel]
    win_valid = before & keep
    lost = (before & ~keep).any(-1)
    n_obs = (win_valid & (state.obs.kf[lsel] >= 0)).sum(-1).to(
        state.lms.n_obs.dtype)
    n_obs = torch.where(lost, n_obs, state.lms.n_obs[lsel])
    alive = state.lms.valid[lsel] & ~(lost & (n_obs < 2))
    lms = state.lms._replace(
        pos=ms.scatter_rows(state.lms.pos, lm_tgt, res.points),
        n_obs=ms.scatter_rows(state.lms.n_obs, lm_tgt, n_obs),
        valid=ms.scatter_rows(state.lms.valid, lm_tgt, alive))
    obs = state.obs._replace(valid=ms.scatter_rows(
        state.obs.valid, lm_tgt, win_valid))
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


# --- The monocular-inertial system ------------------------------------------


class MonoInertialSlam(system_mod.MonoSlam):
    """Monocular-inertial SLAM (System::TrackMonocular with an IMU) on
    ``device`` (``None``: the card; raises without one).

    The host frame loop of the JAX package's ``MonoInertialSlam`` over the
    functions above: the IMU buffer, the temporal keyframe chain
    (``kf_prev``) with its preintegrations (``kf_preint``) and host stamps
    (``kf_stamp``), the per-keyframe velocities and biases on the device
    (``kf_vel``, ``kf_bg``, ``kf_ba``), the IMU schedule (the init, VIBA1,
    VIBA2, the monocular scale refinement), the chain-aware keyframe
    culling and the trajectory rescale. With a vocabulary, relocalization
    runs as in ``MonoSlam`` before the IMU initialisation (an inertial
    RECENTLY_LOST frame dead-reckons on the IMU, as the JAX system's
    does), and a re-entry into an older atlas map restarts the IMU
    machinery with a fresh chain at the next keyframe
    (``_on_cross_map_reloc``). Loop closing opens after VIBA2
    (``_loops_allowed``) and solves its pose graph in 4 DoF once the IMU is
    initialised; a correction carries the body state with it
    (``_on_map_corrected``). A merge welds the other map in as
    ``MonoSlam`` does and then runs the local VI-BA (``_merge_maps``).

    Host reads, beside ``MonoSlam``'s: a tracked inertial frame's one
    packed ``info`` (``track_inertial``), with a carried prior the
    ``eigh`` of its square root, queued before the frame's extraction
    (``_queue_prior``); a RECENTLY_LOST frame's predicted pose; each cull
    one packed read (the candidate, the liveness, the biases); the init
    and each refit their scale with the biases; the scale refinement its
    scale. The JAX system reads the keyframe's pose after every inertial
    keyframe (``inertial_system.py:1105-1109``) and, where its host mirror
    is empty, a keyframe's stamp (``:319-324``); here the body is rebuilt
    on the device and ``kf_stamp`` is filled on every keyframe, so neither
    read exists."""

    def __init__(self, config, imu_cfg: ImuConfig, viba_window: int = 24,
                 viba_free: int = 10, viba_landmarks: int = 4096,
                 full_viba_kf: int = 64, device=None):
        super().__init__(config, device)
        self.imu_cfg = imu_cfg
        bf = getattr(config, "bf", None)
        self.ctx = make_context(
            imu_cfg, config.cam_params(), bf,
            config.depth_threshold if bf is not None else 0.0,
            config.width, config.height, self._window_kwargs(),
            config.kf_ref_min_obs, viba_window, viba_free, viba_landmarks,
            full_viba_kf, device=self.device)
        self.W = viba_window
        self.W_free = viba_free
        self.L_slots = viba_landmarks
        self.full_viba_kf = full_viba_kf
        # The sensor's init gates and bias priors (LocalMapping.cc:236-293):
        # mono (1e2, 1e10), 2 s; the stereo system sets (1e2, 1e5), 1 s and
        # a fixed scale.
        self.imu_init_prior = (1e2, 1e10)
        self.imu_init_min_time = 2.0
        self.imu_init_min_kf = 10
        self.imu_fix_scale = False
        self.buf = ImuBuffer()
        mk = config.max_kf
        dev = self.device
        self.kf_stamp = np.full(mk, np.nan, np.float64)
        self.kf_vel = torch.zeros((mk, 3), device=dev)
        self.kf_bg = torch.zeros((mk, 3), device=dev)
        self.kf_ba = torch.zeros((mk, 3), device=dev)
        self.kf_prev = np.full(mk, -1, np.int32)     # the temporal chain
        self.kf_preint = [None] * mk                 # preint prev -> this
        self.imu_ready = False
        self.viba_stage = 0                          # 0 init, 1 VIBA1, 2 VIBA2
        self._next_scale_refine = 25.0
        self.map_first_kf = 0
        self._body = None           # (R_wb, p_w, v_w) tensors once ready
        self._bias = np.zeros(6, np.float32)
        self._last_stamp = None
        # ConstraintPoseImu: the last frame's H_marg, None after a
        # keyframe, a rebase or a lost frame.
        self._pose_prior_H = None
        self._pending_cull = None
        self._imu_init_failures = 0
        # Set by a re-entry into an older map: the next keyframe roots a
        # fresh chain.
        self._fresh_chain = False
        if self.loop_closer is not None:
            # After the IMU init the map is metric and gravity-aligned
            # (the loop closer solves SE3, then 4 DoF after the init).
            self.loop_closer.cfg.fix_scale = True

    # ------------------------------------------------------------------
    def _imap(self) -> InertialMap:
        return InertialMap(self.state, self.kf_vel, self.kf_bg, self.kf_ba,
                           self.kf_prev, self.kf_preint, self.kf_stamp)

    def _set_imap(self, imap: InertialMap):
        self.state = imap.state
        self.kf_vel, self.kf_bg, self.kf_ba = (imap.kf_vel, imap.kf_bg,
                                               imap.kf_ba)

    def _preintegrate(self, t0: float, t1: float, bias, n_pad: int):
        return preintegrate(*self.buf.window(t0, t1), t0, t1, bias, n_pad,
                            self.ctx)[0]

    def _chain(self, kf_id: int, max_len: int = 100000) -> list:
        return chain(self.kf_prev, kf_id, max_len)

    def _chain_length(self, kf_id: int) -> int:
        return len(self._chain(kf_id))

    def _trajectory_kf_stamp(self, kf_id: int) -> float:
        """A keyframe's stamp from the host mirror (filled on every
        keyframe, the init's with the device's float32 value)."""
        return float(self.kf_stamp[kf_id])

    def _body_of(self, kf_id: int) -> tuple:
        """(R_wb, p_w, v_w) of keyframe ``kf_id``, built on the device."""
        Rb, pb = body_from_cam(self.state.kfs.R[kf_id],
                               self.state.kfs.t[kf_id], self.ctx.R_bc,
                               self.ctx.t_bc)
        return Rb, pb, self.kf_vel[kf_id]

    def _queue_prior(self):
        """The carried prior's square root, queued before the frame's own
        work: its ``eigh`` then waits only for the last frame's solve,
        which its read already waited for."""
        if (self.status == system_mod.NOT_INITIALIZED or not self.imu_ready
                or self._pose_prior_H is None):
            return None
        return inertial.prior_sqrt(self._pose_prior_H)

    def _append_imu(self, imu_data):
        if imu_data is not None and len(imu_data[0]) > 0:
            self.buf.append(np.asarray(imu_data[0], np.float64) - self.t0,
                            imu_data[1], imu_data[2])

    # ------------------------------------------------------------------
    def track(self, img: np.ndarray, stamp: float, imu_data=None):
        """Process one frame and its IMU batch (ts, gyr, acc: the samples in
        (t_prev, t]); returns Tcw (R, t) as numpy, or None."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        self._append_imu(imu_data)
        self._cur_stamp = stamp
        prior_L = self._queue_prior()
        with self._stage("orb_extract"):
            feats = self._extract(img)
        if self.status == system_mod.NOT_INITIALIZED:
            pose = self._try_initialize(feats, stamp)
            # A relocalization into an older map made no new map (the JAX
            # system seeds a chain link on that map's slot 1 here, which
            # its fresh chain never walks).
            if pose is not None and not self._fresh_chain:
                self._on_map_created(stamp)
        elif self.imu_ready:
            pose = self._track_inertial(feats, stamp, prior_L)
        else:
            pose = self._track_frame(feats, stamp)
        self._last_stamp = stamp
        if pose is not None:
            self._log_frame(stamp, pose)
        return pose

    def _on_map_created(self, stamp: float):
        """The two-keyframe initial map exists: the chain starts at
        keyframe 0, keyframe 1 carries the preintegration between them.
        Their stamps are the device's float32 values, which the JAX system
        reads back when it first needs them."""
        self.map_first_kf = 0
        self.kf_stamp[0] = float(np.float32(self._init_stamp))
        self.kf_stamp[1] = float(np.float32(stamp))
        self.kf_prev[1] = 0
        self.kf_preint[1] = self._preintegrate(
            self.kf_stamp[0], stamp, np.zeros(6, np.float32), KF_STEPS)

    # ------------------------------------------------------------------
    # Keyframes: the inertial bookkeeping around the parent's work.
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, n_inliers: int,
                           ref_matches: int | None = None) -> bool:
        if not self.imu_ready and self.n_kf >= 1 and self.last_kf_id >= 0:
            # Before the IMU init the 0.25 s cadence is the only rule
            # (Tracking.cc:4393-4400).
            dt = self._cur_stamp - self._trajectory_kf_stamp(self.last_kf_id)
            return dt >= 0.25 and self._kf_slot_available()
        if super()._need_new_keyframe(n_inliers, ref_matches):
            return True
        # After it (Tracking.cc:4501-4522): c3, a keyframe at least every
        # 0.5 s; c4, mono-inertial also on thin tracking or RECENTLY_LOST.
        if self.last_kf_id < 0:
            return False
        dt = self._cur_stamp - self._trajectory_kf_stamp(self.last_kf_id)
        c3 = dt >= 0.5
        c4 = self._depth is None and (
            15 < n_inliers < 75 or self.status == system_mod.RECENTLY_LOST)
        return (c3 or c4) and self._kf_slot_available()

    _bundle_local_ba = False

    def _create_keyframe(self, feats, track_res, stamp, R_np, t_np):
        """Drain first (it may apply a lagging cull), then this keyframe's
        chain link, its window's preintegration (``KF_STEPS``), its velocity
        and bias rows, then the parent's keyframe work (the bundle without
        its BA, ``_local_refine``, the culls; the stereo depth landmarks),
        then the IMU schedule. Returns the slot, or None."""
        self._drain_pending()
        if not self._kf_slot_available():
            return None
        prev = self.last_kf_id
        kf_id = self.n_kf
        self.kf_stamp[kf_id] = stamp
        if self._fresh_chain:
            # The first keyframe after a re-entry into an older map.
            self._fresh_chain = False
            prev = -1
            self.map_first_kf = kf_id
        self.kf_prev[kf_id] = prev
        if prev >= 0:
            self.kf_preint[kf_id] = self._preintegrate(
                self._trajectory_kf_stamp(prev), stamp, self._bias,
                KF_STEPS)
        if self.imu_ready:
            dev = self.device
            v = (self._body[2] if self._body is not None
                 else torch.zeros(3, device=dev))
            row = ms.slot_index(kf_id, dev)
            b = device_mod.upload(self._bias, dev)
            self.kf_vel = self.kf_vel.index_put((row,), v[None])
            self.kf_bg = self.kf_bg.index_put((row,), b[None, :3])
            self.kf_ba = self.kf_ba.index_put((row,), b[None, 3:])
        got = super()._create_keyframe(feats, track_res, stamp, R_np, t_np)
        if got is None:
            # No keyframe was made (the map is full): no chain link either.
            self.kf_prev[kf_id] = -1
            self.kf_preint[kf_id] = None
            self.kf_stamp[kf_id] = np.nan
            return None
        self._imu_schedule(kf_id, stamp)
        return kf_id

    def _local_refine(self, kf_id: int, counts, order):
        if not self.imu_ready:
            return super()._local_refine(kf_id, counts, order)
        self._set_imap(local_inertial_ba(self._imap(), kf_id,
                                         self.map_first_kf, self.ctx))

    # ------------------------------------------------------------------
    # The chain-aware keyframe culling (LocalMapping.cc:1177-1240).
    # ------------------------------------------------------------------
    def _successors(self, n: int) -> np.ndarray:
        nxt = np.full(self.cfg.max_kf, -1, np.int32)
        for j in range(n):
            p = int(self.kf_prev[j])
            if p >= 0:
                nxt[p] = j
        return nxt

    def _maybe_cull_keyframes(self, kf_id: int):
        """Inertial KeyFrameCulling: a redundant chain keyframe may go only
        if its successor's preintegration gap stays under 3 s; the
        successor's preintegration is then re-integrated across the gap
        from the buffer's raw samples. The redundancy score is dispatched
        here and read at the next keyframe's drain (a read now would wait
        for the whole keyframe's device queue)."""
        if self.n_kf < 8:
            return
        n = self.n_kf
        nxt = self._successors(n)
        recent = set(self._chain(kf_id)[-3:])
        stamps = self.kf_stamp
        eligible = np.zeros(self.cfg.max_kf, bool)
        for k in range(n):
            if k == self.map_first_kf or k in recent:
                continue
            p, nx = int(self.kf_prev[k]), int(nxt[k])
            if p < 0 or nx < 0:
                continue
            if (np.isnan(stamps[nx]) or np.isnan(stamps[p])
                    or stamps[nx] - stamps[p] >= 3.0):   # LocalMapping.cc:1228
                continue
            eligible[k] = True
        if not eligible.any():
            return
        self._pending_cull = mapping.cull_candidate(
            self.state, device_mod.upload(eligible, self.device))

    def _apply_pending_cull(self):
        """The lagging cull decision, in one packed read with the liveness
        and the biases, re-validated against the current chain."""
        pend = self._pending_cull
        if pend is None:
            return
        self._pending_cull = None
        out, valid, bg, ba = device_mod.read(pend, self.state.kfs.valid,
                                             self.kf_bg, self.kf_ba)
        best = int(out[0])
        if out[1] < 0.9:
            return
        if best == self.map_first_kf or int(self.kf_prev[best]) < 0:
            return
        if valid[best] <= 0:
            return
        nx = -1
        for j in range(self.n_kf):
            if int(self.kf_prev[j]) == best:
                nx = j
                break
        if nx < 0 or best in self._chain(self.last_kf_id)[-3:]:
            return
        self._cull_chain_keyframe(best, nx, np.concatenate([bg[nx], ba[nx]]),
                                  valid > 0)

    def _drain_pending(self):
        super()._drain_pending()
        self._apply_pending_cull()

    def _cull_chain_keyframe(self, best: int, nx: int, bias_nx: np.ndarray,
                             valid: np.ndarray):
        """Drop chain keyframe ``best`` (``valid``: the liveness before,
        ``bias_nx``: its successor's [bg, ba], both host values): the
        successor's preintegration re-integrated over (t_prev, t_next] at
        its bias (MergePrevious with Reintegrate's exactness), the chain
        relinked, the spanning tree and the frame records reattached."""
        stamps = self.kf_stamp
        p = int(self.kf_prev[best])
        self.kf_preint[nx] = self._preintegrate(
            float(stamps[p]), float(stamps[nx]), bias_nx, KF_STEPS)
        self.kf_prev[nx] = p
        self.kf_prev[best] = -1
        self.kf_preint[best] = None
        self.state = mapping.drop_keyframe(self.state, best)
        after = valid.copy()
        after[best] = False
        self.kf_parent[:] = self._resolve_dead_parents(self.kf_parent, after)
        if any(r == best for r in self._traj.refs):
            dead = np.zeros(self.cfg.max_kf, bool)
            dead[best] = True
            parent_of = np.full(self.cfg.max_kf, -1, np.int64)
            parent_of[best] = p
            self._traj.rebase(dead, parent_of, *self._host_poses())

    def _force_cull_keyframes(self, n: int) -> int:
        """The capacity valve, chain-aware: up to ``n`` redundancy-ranked
        culls with the preintegration re-integrated across each gap; the
        chain gap may reach 10 s; the map's first keyframe, keyframe 0 and
        the 8 newest live ones are protected."""
        count = 0
        for _ in range(n):
            nk = self.n_kf
            stamps = self.kf_stamp
            nxt = self._successors(nk)
            valid = device_mod.read(self.state.kfs.valid)[0] > 0
            recent = set(np.flatnonzero(valid)[-8:].tolist())
            eligible = np.zeros(self.cfg.max_kf, bool)
            for k in range(nk):
                if k == self.map_first_kf or k == 0 or k in recent:
                    continue
                p, nx = int(self.kf_prev[k]), int(nxt[k])
                if p < 0 or nx < 0:
                    continue
                if (np.isnan(stamps[nx]) or np.isnan(stamps[p])
                        or stamps[nx] - stamps[p] >= 10.0):
                    continue
                eligible[k] = True
            if not eligible.any():
                break
            out, bg, ba = device_mod.read(mapping.cull_candidate(
                self.state, device_mod.upload(eligible, self.device),
                min_seen=0), self.kf_bg, self.kf_ba)
            best = int(out[0])
            if out[1] < 0 or not eligible[best]:
                break
            nx = int(nxt[best])
            self._cull_chain_keyframe(best, nx, np.concatenate([bg[nx],
                                                                ba[nx]]),
                                      valid)
            count += 1
        return count

    def _on_keyframes_compacted(self, old2new: np.ndarray):
        """Remap the per-keyframe inertial arrays after the compaction."""
        mk = self.cfg.max_kf
        live = np.flatnonzero(old2new >= 0)
        new_ids = old2new[live]
        rows = device_mod.upload(np.stack([live, new_ids]).astype(np.int64),
                                 self.device)
        for name in ("kf_vel", "kf_bg", "kf_ba"):
            arr = getattr(self, name)
            setattr(self, name, torch.zeros_like(arr).index_put(
                (rows[1],), arr[rows[0]]))
        stamps_new = np.full(mk, np.nan, np.float64)
        stamps_new[new_ids] = self.kf_stamp[live]
        self.kf_stamp = stamps_new
        prev_new = np.full(mk, -1, np.int32)
        preint_new = [None] * mk
        for old, new in zip(live, new_ids):
            p = int(self.kf_prev[old])
            prev_new[new] = old2new[p] if p >= 0 else -1
            preint_new[new] = self.kf_preint[old]
        self.kf_prev = prev_new
        self.kf_preint = preint_new
        self.map_first_kf = max(int(old2new[self.map_first_kf]), 0)

    # ------------------------------------------------------------------
    # The IMU init and the VI-BA schedule (LocalMapping.cc:236-294).
    # ------------------------------------------------------------------
    def _imu_schedule(self, kf_id: int, stamp: float):
        span = stamp - self._trajectory_kf_stamp(self.map_first_kf)
        if not self.imu_ready:
            if (self._chain_length(kf_id) >= self.imu_init_min_kf
                    and span >= self.imu_init_min_time):
                self._initialize_imu(kf_id)
            return
        if self.viba_stage == 1 and span > 5.0:
            # VIBA1: InitializeIMU(1, 1e5) then the full VI-BA
            # (LocalMapping.cc:274-276).
            self._inertial_refit(kf_id, prior_g=1.0, prior_a=1e5)
            self._full_inertial_ba(kf_id, prior_g=1.0, prior_a=1e5)
            self.viba_stage = 2
            self._refresh_inertial_context(kf_id)
        elif self.viba_stage == 2 and span > 15.0:
            # VIBA2: InitializeIMU(0, 0) (LocalMapping.cc:288-290).
            self._inertial_refit(kf_id, prior_g=0.0, prior_a=0.0)
            self._full_inertial_ba(kf_id, prior_g=0.0, prior_a=0.0)
            self.viba_stage = 3
            self._refresh_inertial_context(kf_id)
        elif (self.viba_stage >= 3 and not self.imu_fix_scale
                and span > self._next_scale_refine):
            # The monocular scale check at 25, 35, ... s (ScaleRefinement,
            # LocalMapping.cc:1846, :298-308).
            self._scale_refinement(kf_id)
            self._next_scale_refine += 10.0

    def _refresh_inertial_context(self, kf_id: int):
        """Re-seed the frame context from the newest keyframe ``kf_id``
        after a full VI-BA moved the map: the body (on the device), the
        matching pose, the prior dropped; and in one read the keyframe's
        biases (the frames' new linearization bias, UpdateFrameIMU) with
        its pose for the ref cache."""
        self._body = self._body_of(kf_id)
        if self._last is not None:
            self._last["R"] = self.state.kfs.R[kf_id]
            self._last["t"] = self.state.kfs.t[kf_id]
        self._vel = None
        self._pose_prior_H = None
        bg, ba, R, t = device_mod.read(self.kf_bg[kf_id], self.kf_ba[kf_id],
                                       self.state.kfs.R[kf_id],
                                       self.state.kfs.t[kf_id])
        self._bias = np.concatenate([bg, ba])
        self._set_ref_cache(kf_id, R, t)

    def _loops_allowed(self) -> bool:
        """The inertial loop guard: the map IMU-initialised and past VIBA2
        (LoopClosing.cc:407-430)."""
        return self.imu_ready and self.viba_stage >= 2

    def _merge_maps(self, kf_id: int, other_idx: int, cand: int, corr):
        """The visual weld and merge BA of ``MonoSlam`` (MergeLocal2: the
        active map keeps its gravity-aligned metric frame, the other map
        moves into it), then, with the IMU initialised, MergeInertialBA
        (Optimizer.cc:6017) as the local VI-BA around ``kf_id`` and the
        body re-set on its result. The VI-BA's window is the active map's
        chain from ``kf_id`` (``kf_prev``), which no transplanted slot
        joins (``Atlas.merge`` leaves their chain links -1), so it reads no
        transplanted slot's velocity or biases (which the weld does not
        move)."""
        super()._merge_maps(kf_id, other_idx, cand, corr)
        if self.imu_ready:
            self._set_imap(local_inertial_ba(self._imap(), kf_id,
                                             self.map_first_kf, self.ctx))
            self._body = self._body_of(kf_id)
            if self._last is not None:
                self._last["R"] = self.state.kfs.R[kf_id]
                self._last["t"] = self.state.kfs.t[kf_id]
            self._refresh_ref_cache()

    def _on_map_corrected(self, kf_id: int):
        """After a loop closure or a GBA merge the body follows the
        corrected last-frame pose, and the world-frame velocity turns with
        the anchor's world correction (CorrectLoop moves the current
        keyframe's velocity through the Sim3 too); the carried prior's
        linearization point moved, so it is dropped."""
        super()._on_map_corrected(kf_id)
        if (self.imu_ready and self.last_kf_id == kf_id
                and self._last is not None and self._body is not None):
            dev = self.device
            R_l, t_l = (device_mod.upload(np.asarray(x, np.float32), dev)
                        for x in (self._last["R"], self._last["t"]))
            Rb, pb = body_from_cam(R_l, t_l, self.ctx.R_bc, self.ctx.t_bc)
            v = self._body[2]
            if self._corr_Rw is not None:
                v = device_mod.upload(self._corr_Rw, dev) @ v
            self._body = (Rb, pb, v)
            self._pose_prior_H = None

    def _rebase_gravity_scale(self, R_gw: torch.Tensor, s: float):
        """x' = s R_gw x on the map (``rebase_gravity_scale``), the frame
        records' rescale, and the prior dropped. A background GBA's
        snapshot is in the old world: it is aborted."""
        self._gba_abort()
        self.state = rebase_gravity_scale(self.state, R_gw, s)
        self._traj.rescale(s)
        self._pose_prior_H = None

    def _scale_refinement(self, kf_id: int):
        """The scale and gravity re-fit with the biases pinned
        (InertialOptimization's scale variant, Optimizer.cc:4067); applied
        when |s - 1| > 0.002 (LocalMapping.cc:1866). One read: s."""
        ids = self._chain(kf_id)
        if len(ids) < 4 or any(self.kf_preint[k] is None for k in ids[1:]):
            return
        rows = device_mod.upload(np.asarray(ids, np.int64), self.device)
        R_wb, p_w = body_from_cam_batch(self.state.kfs.R[rows],
                                        self.state.kfs.t[rows],
                                        self.ctx.R_bc, self.ctx.t_bc)
        res = inertial.inertial_only_optimization(
            R_wb, p_w, imu.stack([self.kf_preint[k] for k in ids[1:]]),
            prior_g=1e10, prior_a=1e10, fix_scale=False)
        s = float(device_mod.read(res.scale)[0])
        if not np.isfinite(s) or s < 1e-1 or abs(s - 1.0) <= 0.002:
            return
        R_gw = res.R_wg.T
        self._rebase_gravity_scale(R_gw, s)
        self.kf_vel = self.kf_vel.index_put(
            (rows,), s * self.kf_vel[rows] @ R_gw.T)
        if self._body is not None:
            self._body = self._body_of(kf_id)
        if self._last is not None:
            self._last["R"] = self.state.kfs.R[kf_id]
            self._last["t"] = self.state.kfs.t[kf_id]
        self._vel = None
        self._refresh_ref_cache()

    def _inertial_refit(self, kf_id: int, prior_g: float, prior_a: float):
        """InertialOptimization + ApplyScaledRotation (``inertial_refit``)
        with the frame records' rescale. Returns the scale, or None when
        the chain is too short to solve."""
        imap, fit = inertial_refit(self._imap(), kf_id, prior_g, prior_a,
                                   self.imu_fix_scale, self.ctx)
        if fit.solve is None:
            return None
        if not np.isfinite(fit.scale) or fit.scale < 1e-1:
            return fit.scale
        self._set_imap(imap)
        self._traj.rescale(fit.scale)
        self._pose_prior_H = None
        self._bias = fit.bias.astype(np.float32)
        return fit.scale

    def _full_inertial_ba(self, kf_id: int, prior_g: float, prior_a: float):
        self._set_imap(full_inertial_ba(self._imap(), kf_id, prior_g,
                                        prior_a, self.ctx))

    def _initialize_imu(self, kf_id: int):
        """InitializeIMU (LocalMapping.cc:1516): the refit, then the full
        VI-BA under the init's bias prior. Five non-finite solves condemn
        the active map (mbBadImu, LocalMapping.cc:186-193)."""
        scale = self._inertial_refit(kf_id, *self.imu_init_prior)
        if scale is None:
            return
        if not np.isfinite(scale):
            self._imu_init_failures += 1
            if self._imu_init_failures >= 5:
                verbose.print_mess("bad IMU detected: resetting active map")
                self._imu_init_failures = 0
                self._handle_lost(None, None)
            return
        if scale < 1e-1:
            return
        self.imu_ready = True
        self.viba_stage = 1
        if self.loop_closer is not None:
            # Gravity pins roll and pitch: loop corrections drop to 4 DoF.
            self.loop_closer.inertial_4dof = True
        self._full_inertial_ba(kf_id, *self.imu_init_prior)
        self._body = self._body_of(kf_id)
        if self._last is not None:
            self._last["R"] = self.state.kfs.R[kf_id]
            self._last["t"] = self.state.kfs.t[kf_id]
        self._vel = None
        self._refresh_ref_cache()

    # ------------------------------------------------------------------
    # The inertial frame (Track with an IMU).
    # ------------------------------------------------------------------
    def _track_inertial(self, feats, stamp, prior_L=None):
        """``track_inertial`` and the host's side of it: RECENTLY_LOST
        dead-reckons on the IMU prediction for the grace period; a tracked
        frame carries its ``H_marg`` as the next frame's prior; a keyframe
        drops it and rebuilds the body from the keyframe on the device."""
        last = self._last
        res = track_inertial(
            feats, self._ur, self._depth, last["bindings"],
            last["feats"].desc, last["feats"].angle, self.state.lms,
            self.state.obs, self.n_kf, self.last_kf_id, self._body,
            self._bias, self.buf.window(self._last_stamp, stamp),
            self._last_stamp, stamp, self.ctx, prior_H=self._pose_prior_H,
            prior_L=prior_L, **self._stage_kwargs())
        info = res.info
        n_inliers = int(info[0])
        ref_matches = max(int(info[1]), 1)
        self._close_counts = ((int(info[20]), int(info[21]))
                              if self._depth is not None else (0, 0))
        if n_inliers < 15:
            # RECENTLY_LOST: the IMU dead-reckoning grace (Tracking.cc:2925).
            self._pose_prior_H = None
            self.status = system_mod.RECENTLY_LOST
            self.lost_frames += 1
            self._body = (res.R_pred, res.p_pred, res.v_pred)
            if self.lost_frames > self.lost_grace:
                self._handle_lost(feats, stamp)
                return None
            Rc, tc = device_mod.read(*cam_from_body(
                res.R_pred, res.p_pred, self.ctx.R_cb, self.ctx.t_cb))
            self._last = dict(feats=feats, bindings=res.track.bindings,
                              R=Rc, t=tc, stamp=stamp)
            return (Rc, tc)

        self.status = system_mod.OK
        self.lost_frames = 0
        pr = res.pose_inertial
        self._body = (pr.R, pr.p, pr.v)
        self._bias = info[14:20].astype(np.float32)
        self._pose_prior_H = pr.H_marg
        R_np = info[2:11].reshape(3, 3).astype(np.float32)
        t_np = info[11:14].astype(np.float32)
        self.state = self.state._replace(lms=self.state.lms._replace(
            n_found=res.n_found, n_visible=res.n_visible))
        self._last = dict(feats=feats, bindings=res.bindings, R=R_np,
                          t=t_np, stamp=stamp)
        self.frames_since_kf += 1
        if not self.localization_only and self._need_new_keyframe(
                n_inliers, ref_matches):
            pose = device_mod.upload(np.concatenate([R_np.ravel(), t_np]),
                                     self.device)
            tr = tracking.TrackResult(R=pose[:9].reshape(3, 3), t=pose[9:],
                                      bindings=res.bindings,
                                      n_inliers=pr.n_inliers)
            self._create_keyframe(feats, tr, stamp, R_np, t_np)
            # The bundle and the VI-BA may have moved the keyframe: the body
            # follows it (on the device), and the prior's linearization
            # point moved.
            self._pose_prior_H = None
            self._body = self._body_of(self.last_kf_id)
        return (R_np, t_np)

    # ------------------------------------------------------------------
    def _reset_inertial_machinery(self):
        self.imu_ready = False
        self.viba_stage = 0
        self._next_scale_refine = 25.0
        self._body = None
        self._bias = np.zeros(6, np.float32)
        self._pose_prior_H = None
        self._pending_cull = None
        self.kf_prev[:] = -1
        self.kf_preint = [None] * self.cfg.max_kf
        self.kf_stamp[:] = np.nan

    def _on_cross_map_reloc(self, cand: int):
        """A relocalization re-entered an older map, whose chain bookkeeping
        was cleared when it was left: the IMU machinery restarts, a fresh
        chain roots at the next keyframe and the IMU init runs again. The
        host stamps of the map's keyframes come back in one read (the JAX
        system reads each lazily, ``inertial_system.py:319-324``)."""
        self._reset_inertial_machinery()
        self._fresh_chain = True
        valid, stamp = device_mod.read(self.state.kfs.valid,
                                       self.state.kfs.stamp)
        live = valid > 0
        self.kf_stamp[live] = stamp[live]

    def _handle_lost(self, feats, stamp):
        super()._handle_lost(feats, stamp)
        self._reset_inertial_machinery()
