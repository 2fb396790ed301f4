"""Entry points: the per-frame tracking step, the monocular frame step, and
their example inputs.

``tracking_step`` is the flagship per-frame computation (ORB extraction +
local-map tracking + motion-only pose optimization), with the same
arguments and results as ``orbslam3_byzyh_tpu.graft.tracking_step``.

``mono_frame_step`` is what the monocular system runs on every tracked
frame (``MonoSlam._extract`` then ``tracking.frame_step``) at the EuRoC
monocular configuration; ``mono_reference_fallback`` is its
reference-keyframe fallback. ``euroc_mono_scene`` builds a map at that
configuration's full capacity that a frame tracks against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import convert
from .ops import camera as cam
from .ops import fast_orb, lie
from .pipeline import tracking

N_FEATURES = 1024
# The initial pose of the lifted scene: exp([rho, phi]) off the identity.
LIFTED_POSE_XI = (0.01, -0.01, 0.02, 0.003, -0.002, 0.002)
# The EuRoC-mono scene's last-frame pose, and the retry case's predicted
# pose: 0.1 rad about y, ~46 px at fx 458, outside the 15 px window.
LAST_POSE_XI = (0.02, -0.01, 0.03, 0.015, -0.01, 0.01)
RETRY_PRED_XI = (0.05, 0.0, 0.0, 0.0, 0.1, 0.0)


class MonoConfig(NamedTuple):
    """A monocular deployment's constants (the port's own copy). The
    defaults are EuRoC's cam0 as ``scripts/run_euroc_mono.py`` ships it:
    ``configs/EuRoC_mono.yaml`` (752x480 pinhole + radtan, 1200 ORB
    features over 8 levels at scale 1.2, FAST 20/7), the runner's map
    capacity (1024 keyframes, 65536 landmarks) and the system's defaults
    (12 observations a landmark; a local window of 20 voted + 4 recent
    keyframes and 4096 landmarks; TrackedMapPoints(3))."""

    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    dist: tuple = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
    n_features: int = 1200
    n_levels: int = 8
    scale: float = 1.2
    max_kf: int = 1024
    max_lm: int = 65536
    max_obs: int = 12
    n_local_kf: int = 20
    n_local_lm: int = 4096
    recent_kf: int = 4
    kf_ref_min_obs: int = 3


EUROC_MONO = MonoConfig()


class MonoFrameArgs(NamedTuple):
    """``mono_frame_step``'s arguments, in order: the frame, the poses, the
    map, the last frame, the covisibility, the counters and the camera."""

    img: object          # (H, W) float32
    R_pred: object       # (3, 3) motion-model prediction of Tcw
    t_pred: object
    R_last: object       # (3, 3) last frame's Tcw
    t_last: object
    lm_pos: object       # (L, 3) and the rest of the landmark rows
    lm_desc: object      # (L, 8) descriptor words
    lm_normal: object
    lm_min_d: object
    lm_max_d: object
    lm_valid: object
    last_bind: object    # (N,) landmark of each last-frame keypoint, -1 none
    last_desc: object    # (N, 8)
    last_angle: object   # (N,)
    obs_kf: object       # (L, O) observing keyframe ids, -1 none
    obs_valid: object    # (L, O)
    ref_kf: object       # () reference keyframe id
    n_kf: object         # () live keyframes
    n_found: object      # (L,) int32
    n_visible: object    # (L,) int32
    cam_params: object   # (4,) fx, fy, cx, cy
    dist: object         # (4,) k1, k2, p1, p2


def tracking_step(img, R, t, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                  lm_valid, cam_params):
    """One tracking frame: extract ORB features, project the local map,
    match, and run motion-only pose optimization. img: (H, W) float32.
    Returns (R, t, n_inliers)."""
    feats = fast_orb.extract(img, n_features=N_FEATURES)
    bindings = torch.full((N_FEATURES,), -1, dtype=torch.int32,
                          device=img.device)
    res = tracking.track_local_map(
        R, t, bindings,
        lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
        feats.xy, feats.level, feats.desc, feats.valid,
        cam_params, int(img.shape[1]), int(img.shape[0]))
    return res.R, res.t, res.n_inliers


def mono_extract(img, cam_params, dist, cfg: MonoConfig = EUROC_MONO):
    """``MonoSlam._extract`` for a pinhole + radtan camera: ORB features
    with their keypoints undistorted onto the pinhole."""
    feats = fast_orb.extract(img, n_features=cfg.n_features,
                             n_levels=cfg.n_levels, scale=cfg.scale)
    return feats._replace(xy=cam.undistort_pixels(cam_params, dist,
                                                  feats.xy))


def _mono_window(cfg: MonoConfig) -> dict:
    return dict(max_kf=cfg.max_kf, n_local_kf=cfg.n_local_kf,
                n_local_lm=cfg.n_local_lm, recent_kf=cfg.recent_kf)


def mono_frame_step(img, R_pred, t_pred, R_last, t_last,
                    lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
                    last_bind, last_desc, last_angle, obs_kf, obs_valid,
                    ref_kf, n_kf, n_found, n_visible, cam_params, dist,
                    cfg: MonoConfig = EUROC_MONO):
    """One monocular tracking frame, as ``MonoSlam._track_frame`` runs it:
    extract and undistort ``cfg.n_features`` features, then
    ``tracking.frame_step`` (motion model with its widened retry, the local
    window, counters). Arguments as :class:`MonoFrameArgs`. Returns
    (TrackResult, info, n_found, n_visible); ``info`` is the 16-float
    vector the caller reads back."""
    f = mono_extract(img, cam_params, dist, cfg)
    dev = f.xy.device
    return tracking.frame_step(
        R_pred, t_pred, R_last, t_last,
        lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
        last_bind, last_desc, last_angle,
        f.xy, f.level, f.desc, f.valid, f.angle,
        torch.full((cfg.n_features,), -1.0, device=dev),
        torch.zeros((), device=dev), torch.zeros((), device=dev),
        obs_kf, obs_valid, ref_kf, cfg.kf_ref_min_obs, n_kf,
        n_found, n_visible, cam_params, cfg.width, cfg.height,
        **_mono_window(cfg))


def mono_reference_fallback(feats, args: MonoFrameArgs,
                            cfg: MonoConfig = EUROC_MONO):
    """The reference-keyframe fallback ``MonoSlam._track_frame`` runs when
    the frame step keeps fewer than 15 inliers: ``track_reference_keyframe``
    from the last pose, then the local map against the window. In the
    scene the reference keyframe holds the last frame's keypoints and
    bindings. Returns a TrackResult."""
    fb = tracking.track_reference_keyframe(
        args.R_last, args.t_last, args.last_desc, args.last_angle,
        args.last_bind >= 0, args.last_bind, args.lm_pos, args.lm_valid,
        feats.xy, feats.level, feats.desc, feats.valid, feats.angle,
        args.cam_params)
    return tracking.track_local_map_windowed(
        fb.R, fb.t, fb.bindings, args.lm_pos, args.lm_desc, args.lm_normal,
        args.lm_min_d, args.lm_max_d, args.lm_valid, args.obs_kf,
        args.obs_valid, args.n_kf, feats.xy, feats.level, feats.desc,
        feats.valid, None, None, args.cam_params, cfg.width, cfg.height,
        **_mono_window(cfg))


def example_image(h: int, w: int) -> np.ndarray:
    """The example frame: uniform noise in [0, 255), from seed 0."""
    return np.random.default_rng(0).uniform(0, 255, (h, w)).astype(np.float32)


def example_arrays(h: int = 480, w: int = 640, n_lm: int = 4096):
    """numpy version of ``example_tracking_args``: a noise image against
    random landmarks (the JAX package's example, value for value).
    Descriptors are uint32, as in the JAX package."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    lm_pos = np.stack([rng.uniform(-5, 5, n_lm), rng.uniform(-4, 4, n_lm),
                       rng.uniform(3, 12, n_lm)], -1).astype(np.float32)
    lm_desc = rng.integers(0, 2 ** 32, (n_lm, 8), dtype=np.uint32)
    normal = lm_pos / np.linalg.norm(lm_pos, axis=-1, keepdims=True)
    cam_params = np.array([400.0, 400.0, w / 2, h / 2], np.float32)
    return (img, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), lm_pos,
            lm_desc, normal, np.full((n_lm,), 0.5, np.float32),
            np.full((n_lm,), 40.0, np.float32), np.ones((n_lm,), bool),
            cam_params)


def example_tracking_args(h: int = 480, w: int = 640, n_lm: int = 4096,
                          device=None):
    """The tracking step's example inputs as tensors on ``device`` (``None``:
    the card; raises without one).

    The landmarks are random, so almost nothing matches (the step ends
    with a single inlier); :func:`lifted_scene` gives a scene that tracks.
    """
    return convert.tree_to_torch(example_arrays(h, w, n_lm), device)


def lifted_scene(feats_xy, feats_level, feats_desc, feats_valid,
                 h: int = 480, w: int = 640, n_lm: int = 4096, seed: int = 0):
    """A map that the example image tracks against (numpy in and out).

    Each of the frame's own features (numpy, from either package) is lifted
    to a depth drawn from U(3, 12) m along its ray, keeps its descriptor,
    gets the normal along the ray and the scale range of
    MapPoint::UpdateNormalAndDepth (max_d = dist * 1.2^level, min_d =
    max_d / 1.2^7). The remaining landmark slots hold the example's random
    distractors. The true pose is the identity; the returned start pose is
    exp(LIFTED_POSE_XI). Returns the tracking step's 10 arguments.
    """
    img, _, _, lm_pos, lm_desc, normal, min_d, max_d, valid, cam = \
        example_arrays(h, w, n_lm)
    xy = np.asarray(feats_xy, np.float64)
    n = xy.shape[0]
    fx, fy, cx, cy = (float(c) for c in cam)
    depth = np.random.default_rng(seed).uniform(3, 12, n)
    ray = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy,
                    np.ones(n)], -1)
    pos = ray * depth[:, None]
    dist = np.linalg.norm(pos, axis=-1)
    scale_max = dist * 1.2 ** np.asarray(feats_level, np.float64)

    lm_pos, normal = lm_pos.copy(), normal.copy()
    lm_desc, valid = lm_desc.copy(), valid.copy()
    min_d, max_d = min_d.copy(), max_d.copy()
    lm_pos[:n] = pos
    normal[:n] = pos / dist[:, None]
    lm_desc[:n] = np.asarray(feats_desc).view(np.uint32)
    max_d[:n] = scale_max
    min_d[:n] = scale_max / 1.2 ** 7
    valid[:n] = np.asarray(feats_valid, bool)

    R0, t0 = lie.se3_exp(torch.tensor(LIFTED_POSE_XI, dtype=torch.float64))
    return (img, R0.numpy().astype(np.float32), t0.numpy().astype(np.float32),
            lm_pos.astype(np.float32), lm_desc, normal.astype(np.float32),
            min_d.astype(np.float32), max_d.astype(np.float32), valid, cam)


def _pose(xi) -> tuple:
    R, t = lie.se3_exp(torch.tensor(xi, dtype=torch.float64))
    return R.numpy().astype(np.float32), t.numpy().astype(np.float32)


def _observe(rng, obs_kf, obs_valid, rows, pool, lo: int, hi: int):
    """Each landmark row observed by lo..hi distinct keyframes of pool."""
    hi = min(hi, len(pool), obs_kf.shape[1])
    picks = np.argsort(rng.random((len(rows), len(pool))), 1)[:, :hi]
    n_obs = rng.integers(lo, hi + 1, len(rows))
    seen = np.arange(hi)[None, :] < n_obs[:, None]
    obs_kf[rows, :hi] = np.where(seen, np.asarray(pool)[picks], -1)
    obs_valid[rows, :hi] = seen


def euroc_mono_scene(feats_xy, feats_level, feats_desc, feats_angle,
                     feats_valid, cfg: MonoConfig = EUROC_MONO,
                     case: str = "normal", n_live_kf: int = 200,
                     seed: int = 0) -> MonoFrameArgs:
    """A map at ``cfg``'s full capacity that the example frame tracks
    against (numpy in and out; the true pose is the identity).

    Each of the frame's own (undistorted) features is lifted to a depth
    drawn from U(3, 12) m along its ray, keeps its descriptor, gets the
    normal along the ray and the scale range of
    MapPoint::UpdateNormalAndDepth, and sits at a scattered landmark slot.
    The last frame holds the same keypoints, 85 % of them bound to their
    landmarks (the motion model's share); the local-map search must find
    the rest. The lifted landmarks are observed by 3-5 of the 10 newest
    keyframes; ``n_local_lm`` random distractors by 2-4 of them too, so the
    window's candidates outnumber its rows and the bound landmarks must rank
    first; ``max_lm / 4`` more random landmarks only by old keyframes,
    outside the window.

    ``case`` = "normal": the predicted pose is exp(LIFTED_POSE_XI), within
    the motion model's 15 px window. "retry": it is exp(RETRY_PRED_XI), so
    the motion model keeps fewer than 10 inliers and the retry from the
    last pose (exp(LAST_POSE_XI) in both cases) with its 30 px window
    tracks. Returns :class:`MonoFrameArgs`.
    """
    if case not in ("normal", "retry"):
        raise ValueError(f"case: 'normal' or 'retry', got {case!r}")
    rng = np.random.default_rng(seed)
    L, O = cfg.max_lm, cfg.max_obs
    n_kf = min(n_live_kf, cfg.max_kf)
    if n_kf < 40:
        raise ValueError(f"n_live_kf: at least 40 keyframes, got {n_kf}")
    xy = np.asarray(feats_xy, np.float64)
    level = np.asarray(feats_level, np.float64)
    valid = np.asarray(feats_valid, bool)
    n = xy.shape[0]

    depth = rng.uniform(3, 12, n)
    ray = np.stack([(xy[:, 0] - cfg.cx) / cfg.fx,
                    (xy[:, 1] - cfg.cy) / cfg.fy, np.ones(n)], -1)
    pos = ray * depth[:, None]
    dist = np.linalg.norm(pos, axis=-1)
    max_d = dist * cfg.scale ** level
    bound = valid & (rng.random(n) < 0.85)

    n_dis = cfg.n_local_lm
    n_old = L // 4
    slots = rng.permutation(L)[:n + n_dis + n_old]
    lifted, others = slots[:n], slots[n:]
    m = len(others)
    rand_pos = np.stack([rng.uniform(-5, 5, m), rng.uniform(-4, 4, m),
                         rng.uniform(3, 12, m)], -1)

    lm_pos = np.zeros((L, 3))
    lm_normal = np.zeros((L, 3))
    lm_min_d, lm_max_d = np.zeros(L), np.zeros(L)
    lm_desc = np.zeros((L, 8), np.uint32)
    lm_valid = np.zeros(L, bool)
    lm_pos[lifted], lm_normal[lifted] = pos, pos / dist[:, None]
    lm_max_d[lifted] = max_d
    lm_min_d[lifted] = max_d / cfg.scale ** (cfg.n_levels - 1)
    lm_desc[lifted] = np.asarray(feats_desc).view(np.uint32)
    lm_valid[lifted] = valid
    lm_pos[others] = rand_pos
    lm_normal[others] = rand_pos / np.linalg.norm(rand_pos, axis=-1,
                                                  keepdims=True)
    lm_min_d[others], lm_max_d[others] = 0.5, 40.0
    lm_desc[others] = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    lm_valid[others] = True

    obs_kf = np.full((L, O), -1, np.int32)
    obs_valid = np.zeros((L, O), bool)
    local = np.arange(n_kf - 10, n_kf)
    _observe(rng, obs_kf, obs_valid, lifted, local, 3, 5)
    _observe(rng, obs_kf, obs_valid, others[:n_dis], local, 2, 4)
    _observe(rng, obs_kf, obs_valid, others[n_dis:], np.arange(n_kf - 30),
             2, 5)
    n_visible = np.where(lm_valid, rng.integers(1, 30, L), 0)
    n_found = rng.integers(0, n_visible + 1)

    R_pred, t_pred = _pose(LIFTED_POSE_XI if case == "normal"
                           else RETRY_PRED_XI)
    R_last, t_last = _pose(LAST_POSE_XI)
    f32 = np.float32
    return MonoFrameArgs(
        img=example_image(cfg.height, cfg.width),
        R_pred=R_pred, t_pred=t_pred, R_last=R_last, t_last=t_last,
        lm_pos=lm_pos.astype(f32), lm_desc=lm_desc,
        lm_normal=lm_normal.astype(f32), lm_min_d=lm_min_d.astype(f32),
        lm_max_d=lm_max_d.astype(f32), lm_valid=lm_valid,
        last_bind=np.where(bound, lifted, -1).astype(np.int32),
        last_desc=np.asarray(feats_desc).view(np.uint32),
        last_angle=np.asarray(feats_angle, f32),
        obs_kf=obs_kf, obs_valid=obs_valid,
        ref_kf=np.int32(n_kf - 1), n_kf=np.int32(n_kf),
        n_found=n_found.astype(np.int32), n_visible=n_visible.astype(np.int32),
        cam_params=np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], f32),
        dist=np.array(cfg.dist, f32))
