"""Entry points: the per-frame tracking step, the monocular frame step, the
monocular keyframe step, and their example inputs.

``tracking_step`` is the flagship per-frame computation (ORB extraction +
local-map tracking + motion-only pose optimization), with the same
arguments and results as ``orbslam3_byzyh_tpu.graft.tracking_step``.

``mono_frame_step`` is what the monocular system runs on every tracked
frame (``MonoSlam._extract`` then ``tracking.frame_step``) at the EuRoC
monocular configuration; ``mono_reference_fallback`` is its
reference-keyframe fallback. ``euroc_mono_scene`` builds a map at that
configuration's full capacity that a frame tracks against.

``mono_keyframe_step`` is the one device dispatch ``MonoSlam._create_keyframe``
makes for each new keyframe (``mapping.keyframe_bundle`` with the visual
system's local BA and keyframe culling). ``euroc_mono_map`` builds a map at
the EuRoC-mono capacity in which every stage of that step has work.

``mono_initialize`` is the device half of ``MonoSlam._try_initialize``: it
builds the initial map from a reference frame and the current frame
(two-view H/F RANSAC, the two first keyframes and their landmarks at
median-depth scale, the full-map BA). ``euroc_mono_two_view`` builds the
second frame for it from the reference frame's own features.

``stereo_frame_step`` is what the stereo system runs on every tracked
frame (``stereo_extract``: the ORB features of both images and the stereo
match; then ``tracking.frame_step`` with the stereo rows) at the KITTI
stereo configuration (``KITTI_STEREO``); ``kitti_stereo_pair`` and
``kitti_stereo_scene`` build its example pair and a map that tracks. The
stereo and RGB-D systems' configurations and frames for the card's runs
(``stereo_frames``, ``stereo_golden_config``, ``kitti_golden_config``,
``tum_rgbd_golden_config``) follow, then the stereo-inertial device path's
steps (``vi_frame_step``, ``vi_keyframe_step``, ``vi_initialize``); the
inertial systems' configurations, frames and gates
(``stereo_inertial_golden_config``, ``mono_inertial_golden_config``,
``euroc_vi_golden_config``, ``vi_stereo_frames``, ``vi_mono_frames``,
``vi_gates``) follow. The non-rectified ("fisheye") stereo rig and the
Kannala-Brandt camera close the file: ``TUMVI_512_STEREO_INERTIAL`` (a
``FisheyeRigConfig``), ``fisheye_stereo_extract`` (the fisheye systems'
extraction: each camera's keypoints rectified onto its virtual pinhole,
then ``stereo.fisheye_stereo_match``), ``kb8_warp`` (a pinhole render seen
through a KB8 camera, in numpy), and the cells' frames, configurations and
gates (``fisheye_frames``, ``fisheye_stereo_golden_config``,
``fisheye_gates``, ``tumvi_vi_frames``, ``tumvi_vi_golden_config``).
Place recognition ends it: ``relocalize``, the device half of one map's
relocalization attempt, and the relocalization cells' frames,
configuration and gates (``reloc_sequence``, ``reloc_golden_config``,
``reloc_run_gates`` against the JAX run's ``RELOC_JAX``). Loop closing
follows: ``loop_closing_step``, the device half of one keyframe's loop
closing (detection; on a loop the correction, the fusion and the global
BA), ``euroc_loop_map``, a drifted circuit at the EuRoC-mono capacity
that closes a loop, and cell (k)'s configuration and the JAX run's
decisions (``loop_golden_config``, ``LOOP_JAX``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import convert
from . import device as device_mod
from .models import map_state as ms
from .ops import camera as cam
from .ops import fast_orb, geometry, lie, matching, pnp
from .pipeline import mapping, tracking

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
    keyframes and 4096 landmarks; TrackedMapPoints(3); the keyframe
    bundle's local BA over the keyframe and its 8 best covisible
    neighbours, 32 keyframes and 4096 landmarks in all, and triangulation
    against 3 neighbours; the two-view initialisation's gate of 100
    matches)."""

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
    local_window: int = 8
    ba_window: int = 32
    ba_lm_window: int = 4096
    triangulation_neighbors: int = 3
    min_init_matches: int = 100


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
    dist: object         # (4,) k1, k2, p1, p2; None for a pinhole camera


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


def mono_extract(img, cam_params, dist, cfg: MonoConfig = EUROC_MONO,
                 kb8=None):
    """``MonoSlam._extract``: ORB features, their keypoints rectified onto
    the pinhole ``cam_params``: with ``kb8`` (the Kannala-Brandt k0..k3, a
    (4,) tensor) unprojected through the fisheye model of the same
    intrinsics and projected onto the virtual pinhole, else undistorted
    when ``dist`` (radtan k1, k2, p1, p2) is given. Rectification moves
    the keypoints only: the descriptors are read off the raw image."""
    feats = fast_orb.extract(img, n_features=cfg.n_features,
                             n_levels=cfg.n_levels, scale=cfg.scale)
    if kb8 is not None:
        ray = cam.kb8_unproject(torch.cat([cam_params, kb8]), feats.xy)
        return feats._replace(xy=cam.pinhole_project(cam_params, ray))
    if dist is None:                   # a pinhole camera
        return feats
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
                     seed: int = 0, depth=None) -> MonoFrameArgs:
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
    tracks. ``depth`` (N,), when given, replaces the drawn depths (the
    stereo scene lifts each feature to its stereo depth). Returns
    :class:`MonoFrameArgs`.
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

    drawn = rng.uniform(3, 12, n)
    depth = drawn if depth is None else np.asarray(depth, np.float64)
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
        dist=None if cfg.dist is None else np.array(cfg.dist, f32))


# --- The keyframe step ------------------------------------------------------

def mono_keyframe_step(state, kf_id, R, t, stamp, feats, bindings,
                       cam_params, n_lm_hwm, cfg: MonoConfig = EUROC_MONO,
                       do_kf_cull: bool = True, ur=None, bf=None,
                       do_local_ba: bool = True):
    """What ``MonoSlam._create_keyframe`` runs on the device for a new
    keyframe: ``mapping.keyframe_bundle`` at ``cfg``'s windows, monocular
    (``ur`` all -1), with the local BA on and keyframe culling when
    ``do_kf_cull`` (the system culls once the map holds 8 keyframes).
    ``state`` is a ``map_state.MapState``; ``feats`` the frame's features
    (``xy``, ``level``, ``angle``, ``desc``, ``valid``); ``bindings`` (N,)
    int32 the tracked landmark of each keypoint. A stereo or RGB-D system
    passes the keypoints' right-image u as ``ur`` and its baseline x fx as
    ``bf`` (a Python float): the bundle then runs its stereo rows. An
    inertial system passes ``do_local_ba=False`` (and no culling): it runs
    its own visual-inertial BA after the bundle. Returns (state',
    bindings', info, culled) as the JAX package's ``keyframe_bundle``
    does."""
    if ur is None:
        ur = torch.full((cfg.n_features,), -1.0, device=feats.xy.device)
    return mapping.keyframe_bundle(
        state, kf_id, R, t, stamp, feats, ur, bindings, cam_params,
        n_lm_hwm, float(cfg.width), float(cfg.height),
        use_stereo=bf is not None, bf=0.0 if bf is None else float(bf),
        n_neighbors=cfg.triangulation_neighbors,
        n_free=cfg.local_window + 1, n_window=cfg.ba_window,
        n_lm_window=cfg.ba_lm_window, do_kf_cull=do_kf_cull,
        do_local_ba=do_local_ba)


class MonoMap(NamedTuple):
    """``mono_keyframe_step``'s arguments as numpy (the map with the JAX
    package's dtypes: descriptors uint32), and the scene's truth."""

    state: ms.MapState       # numpy leaves
    kf_id: int               # the new keyframe's slot
    R: np.ndarray            # (3, 3) its pose as tracking gave it
    t: np.ndarray
    stamp: float
    feats: fast_orb.FrameFeatures   # numpy leaves, desc uint32
    bindings: np.ndarray     # (N,) int32
    cam_params: np.ndarray   # (4,) float32
    n_lm_hwm: int
    R_true: np.ndarray       # the new keyframe's true pose
    t_true: np.ndarray
    cull_kf: int             # the planted redundant keyframe


def mono_map_args(m: MonoMap, device=None) -> tuple:
    """``mono_keyframe_step``'s first nine arguments from a :class:`MonoMap`,
    as tensors on ``device`` (``None``: the card)."""
    feats = fast_orb.FrameFeatures(*convert.tree_to_torch(m.feats, device))
    return (convert.map_state_to_torch(m.state, device), m.kf_id,
            convert.to_torch(m.R, device), convert.to_torch(m.t, device),
            m.stamp, feats, convert.to_torch(m.bindings, device),
            convert.to_torch(m.cam_params, device), m.n_lm_hwm)


def _rodrigues(w) -> np.ndarray:
    """so(3) vector -> rotation matrix (float64)."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _path_pose(k: int, spacing: float):
    """Keyframe k's true pose on a smooth path along +x, looking along +z:
    (R_cw, t_cw, camera centre)."""
    c = np.array([spacing * k, 0.08 * np.sin(0.07 * k),
                  0.05 * np.sin(0.05 * k)])
    R_wc = _rodrigues([0.02 * np.sin(0.04 * k), 0.03 * np.sin(0.03 * k),
                       0.01 * np.sin(0.05 * k)])
    return R_wc.T, -R_wc.T @ c, c


def _perturb(rng, R, t, rot: float, trans: float):
    """A pose with about ``rot`` rad and ``trans`` m of noise."""
    dR = _rodrigues(rng.normal(0, rot, 3))
    return dR @ R, dR @ t + rng.normal(0, trans, 3)


# euroc_mono_map's keyframe spacing along its path, m.
_SPACING = 0.15
# Level of a scene point: ORB's share of features per octave at 1.2.
_LEVEL_P = np.array([0.3, 0.22, 0.16, 0.12, 0.08, 0.06, 0.04, 0.02])


def euroc_mono_map(cfg: MonoConfig = EUROC_MONO, case: str = "normal",
                   seed: int = 0, n_live_kf: int = 200,
                   view_points: int = 7000, path=None, bf=None,
                   ur_depth: float = 0.0) -> MonoMap:
    """A map at ``cfg``'s capacity and a new keyframe for it (numpy in and
    out), in which every stage of ``mono_keyframe_step`` has work.

    A field of 3D points (about ``view_points`` in each view) is seen by
    ``n_live_kf`` keyframes on a smooth path, 0.15 m apart. Each view
    picks ``cfg.n_features`` of its visible points as keypoints: the
    projection with 0.3 px noise, the point's level, and its 256-bit
    descriptor with 0-8 bits flipped. A point seen by at least two
    keyframes is a landmark, observed by its 2..``max_obs`` most recent
    views (2 and 3 observations 20 % each); its position carries 1 cm of
    noise and the keyframe poses about 0.3 mrad and 2 mm. The new keyframe
    sits in slot ``n_live_kf`` with the pose tracking gave it (about 1.5
    mrad and 1 cm off) and the tracked bindings. Planted:

      * 70 % of the points it sees are not mapped yet (triangulation);
      * 8 % of its mapped keypoints were missed by tracking (fusion: a new
        observation, or a duplicate of a landmark that triangulation
        recreates there);
      * the newest keyframes observe more landmarks than the BA window;
      * 2 % of the landmarks were found in fewer than 20 % of the frames
        that saw them (landmark culling);
      * keyframe ``n_live_kf // 2`` has every one of its landmarks
        observed at least 4 times (keyframe culling).

    ``case`` = "normal": the map holds what the views give. "full": old
    landmarks, observed by 2-3 keyframes of the first half, fill all but
    2/3 of ``n_features`` slots, so the capacity valve retires the oldest
    and the slot allocation recycles.

    ``path(k)``, when given, replaces the path: keyframe k's true (R_cw,
    t_cw, camera centre) for k = 0..n_live_kf. ``bf``, when given, gives
    each keypoint closer than ``ur_depth`` m its right-image u, u - bf / z
    with 0.3 px of noise (``kp_ur``; -1 elsewhere).
    """
    if case not in ("normal", "full"):
        raise ValueError(f"case: 'normal' or 'full', got {case!r}")
    rng = np.random.default_rng(seed)
    K, nf, O, L = n_live_kf, cfg.n_features, cfg.max_obs, cfg.max_lm
    if K + 1 > cfg.max_kf or K < 12:
        raise ValueError(f"n_live_kf: 12..{cfg.max_kf - 1}, got {K}")
    p_cull = K // 2
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    W, H = cfg.width, cfg.height
    poses = [_path_pose(k, _SPACING) if path is None else path(k)
             for k in range(K + 1)]

    # The point field: a slab in front of the path, as dense as asked.
    half_w = 10.0 * max(cx, W - cx) / fx + 1.0
    lo = np.array([-half_w, -5.5, 4.0])
    hi = np.array([_SPACING * K + half_w, 5.5, 10.0])

    def project(k, X):
        R, t, _ = poses[k]
        pc = X @ R.T + t
        z = pc[:, 2]
        uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
        ok = ((z > 0.1) & (uv[:, 0] >= 8) & (uv[:, 0] < W - 8)
              & (uv[:, 1] >= 8) & (uv[:, 1] < H - 8))
        return uv, ok, z

    pilot = rng.uniform(lo, hi, (20000, 3))
    frac = max(project(K // 2, pilot)[1].mean(), 1e-6)
    n_pts = int(view_points / frac)
    X = rng.uniform(lo, hi, (n_pts, 3))
    base = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    p_level = rng.choice(8, n_pts, p=_LEVEL_P).astype(np.int32)
    p_angle = rng.uniform(-np.pi, np.pi, n_pts)

    # Each view's keypoints.
    kp_pt = np.full((K + 1, nf), -1, np.int64)
    kp_xy = np.zeros((K + 1, nf, 2), np.float32)
    kp_desc = np.zeros((K + 1, nf, 8), np.uint32)
    kp_level = np.zeros((K + 1, nf), np.int32)
    kp_angle = np.zeros((K + 1, nf), np.float32)
    kp_ur = np.full((K + 1, nf), -1.0, np.float32)
    for k in range(K + 1):
        uv, ok, z = project(k, X)
        vis = np.flatnonzero(ok)
        pick = rng.permutation(vis)[:nf]
        n = len(pick)
        kp_pt[k, :n] = pick
        kp_xy[k, :n] = uv[pick] + rng.normal(0, 0.3, (n, 2))
        flips = np.zeros((n, 8), np.uint32)
        n_bits = rng.integers(0, 9, n)
        for j in range(8):
            pos = rng.integers(0, 256, n)
            bit = np.left_shift(np.uint32(1), (pos % 32).astype(np.uint32))
            flips[np.arange(n), pos // 32] ^= np.where(j < n_bits, bit,
                                                       np.uint32(0))
        kp_desc[k, :n] = base[pick] ^ flips
        kp_level[k, :n] = p_level[pick]
        kp_angle[k, :n] = p_angle[pick] + rng.normal(0, 0.02, n)
        if bf is not None:
            zk = z[pick]
            kp_ur[k, :n] = np.where(
                zk < ur_depth, kp_xy[k, :n, 0] - bf / zk
                + rng.normal(0, 0.3, n), -1.0)
    kp_valid = kp_pt >= 0

    # Appearances in the old views, chronological per point.
    kk, ii = np.nonzero(kp_valid[:K])
    pts = kp_pt[kk, ii]
    order = np.lexsort((kk, pts))
    pts, kk, ii = pts[order], kk[order], ii[order]
    count = np.bincount(pts, minlength=n_pts)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    from_end = start[pts] + count[pts] - np.arange(len(pts))   # 1 = newest

    # Which points are landmarks, and how many views observe each.
    new_pts = kp_pt[K][kp_valid[K]]
    shared = np.zeros(n_pts, bool)
    shared[new_pts] = True
    unmapped = shared & (rng.random(n_pts) < 0.7)
    mapped = (count >= 2) & ~unmapped
    c_obs = rng.choice(np.arange(2, O + 1), n_pts,
                       p=np.r_[0.2, 0.2, np.full(O - 3, 0.6 / (O - 3))])
    # The planted keyframe: each of its landmarks gets >= 4 observations,
    # or the point stays unmapped.
    is_p = kk == p_cull
    rank_p = np.zeros(n_pts, np.int64)
    rank_p[pts[is_p]] = from_end[is_p]
    with_p = rank_p > 0
    extend = with_p & (rank_p <= O) & (count >= 4)
    c_obs = np.where(extend, np.maximum(np.maximum(c_obs, rank_p), 4), c_obs)
    mapped &= ~(with_p & (rank_p <= c_obs) & (count < 4))
    c_obs = np.minimum(c_obs, count)
    keep = mapped[pts] & (from_end <= c_obs[pts])
    lm_pts = np.flatnonzero(mapped)
    n_lm = len(lm_pts)

    # Landmark slots: scattered in the normal case; the full case fills all
    # but 2/3 of a frame's features with old landmarks.
    n_fill = 0 if case == "normal" else L - n_lm - 2 * nf // 3
    if n_lm + max(n_fill, 0) > L or n_fill < 0:
        raise ValueError(f"{n_lm} landmarks do not fit {L} slots")
    slots = rng.permutation(L)
    lm_slot = np.full(n_pts, -1, np.int64)
    lm_slot[lm_pts] = slots[:n_lm]
    fill_slots = slots[n_lm:n_lm + n_fill]

    obs_kf = np.full((L, O), -1, np.int32)
    obs_kp = np.full((L, O), -1, np.int32)
    obs_valid = np.zeros((L, O), bool)
    kept = np.flatnonzero(keep)
    col = c_obs[pts[kept]] - from_end[kept]       # oldest kept first
    rows = lm_slot[pts[kept]]
    obs_kf[rows, col] = kk[kept]
    obs_kp[rows, col] = ii[kept]
    obs_valid[rows, col] = True

    # Landmark rows (empty slots as map_state.empty_map makes them).
    pos = np.zeros((L, 3))
    desc = np.zeros((L, 8), np.uint32)
    normal = np.zeros((L, 3))
    min_d, max_d = np.zeros(L), np.full(L, 1e9)
    n_obs = np.zeros(L, np.int32)
    n_found = np.zeros(L, np.int32)
    n_visible = np.zeros(L, np.int32)
    first_kf = np.zeros(L, np.int32)
    valid = np.zeros(L, bool)
    sl = lm_slot[lm_pts]
    centres = np.stack([p[2] for p in poses])
    okf = obs_kf[sl]
    ov = obs_valid[sl]
    rays = X[lm_pts][:, None, :] - centres[np.maximum(okf, 0)]
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    mean_ray = (rays * ov[..., None]).sum(1)
    last = okf[np.arange(n_lm), ov.sum(1) - 1]
    d_ref = np.linalg.norm(X[lm_pts] - centres[last], axis=-1)
    pos[sl] = X[lm_pts] + rng.normal(0, 0.01, (n_lm, 3))
    desc[sl] = base[lm_pts]
    normal[sl] = mean_ray / np.linalg.norm(mean_ray, axis=-1, keepdims=True)
    max_d[sl] = d_ref * cfg.scale ** p_level[lm_pts]
    min_d[sl] = max_d[sl] / cfg.scale ** (cfg.n_levels - 1)
    n_obs[sl] = ov.sum(1)
    first_kf[sl] = okf[:, 0]
    valid[sl] = True
    vis_n = rng.integers(3, 40, n_lm)
    ratio = np.where(rng.random(n_lm) < 0.02, rng.uniform(0, 0.2, n_lm),
                     rng.uniform(0.4, 1.0, n_lm))
    n_visible[sl] = vis_n
    n_found[sl] = np.floor(ratio * vis_n)

    if n_fill:
        # Old landmarks behind every camera, seen by 2-3 keyframes of the
        # first half (never the planted one).
        pool = np.setdiff1d(np.arange(1, K // 2), [p_cull])
        m = np.arange(n_fill)
        n_o = rng.integers(2, 4, n_fill)
        kfs_f = np.sort(np.argsort(rng.random((n_fill, len(pool))), 1)[:, :3],
                        1)
        for j in range(3):
            on = j < n_o
            obs_kf[fill_slots[on], j] = pool[kfs_f[on, j]]
            obs_kp[fill_slots[on], j] = rng.integers(0, nf, int(on.sum()))
            obs_valid[fill_slots[on], j] = True
        fpos = rng.uniform([-20, -5, -20], [0, 5, -10], (n_fill, 3))
        pos[fill_slots] = fpos
        desc[fill_slots] = rng.integers(0, 2 ** 32, (n_fill, 8),
                                        dtype=np.uint32)
        normal[fill_slots] = [0.0, 0.0, -1.0]
        min_d[fill_slots], max_d[fill_slots] = 0.5, 40.0
        n_obs[fill_slots] = n_o
        first_kf[fill_slots] = pool[kfs_f[m, 0]]
        n_visible[fill_slots] = rng.integers(3, 40, n_fill)
        n_found[fill_slots] = n_visible[fill_slots]
        valid[fill_slots] = True

    # Keyframes: the old ones with pose noise; slot K stays empty.
    Rk = np.tile(np.eye(3), (cfg.max_kf, 1, 1))
    tk = np.zeros((cfg.max_kf, 3))
    for k in range(K):
        R, t, _ = poses[k]
        Rk[k], tk[k] = (R, t) if k == 0 else _perturb(rng, R, t, 3e-4, 2e-3)

    def slab(a, fill):
        out = np.full((cfg.max_kf,) + a.shape[1:], fill, a.dtype)
        out[:K] = a[:K]
        return out

    f32 = np.float32
    kf_valid = np.zeros(cfg.max_kf, bool)
    kf_valid[:K] = True
    state = ms.MapState(
        kfs=ms.KeyFrames(
            R=Rk.astype(f32), t=tk.astype(f32),
            stamp=(0.25 * np.arange(cfg.max_kf) * kf_valid).astype(f32),
            kp_xy=slab(kp_xy, 0), kp_level=slab(kp_level, 0),
            kp_angle=slab(kp_angle, 0), kp_desc=slab(kp_desc, 0),
            kp_valid=slab(kp_valid, False),
            kp_ur=slab(kp_ur, -1.0), valid=kf_valid),
        lms=ms.Landmarks(
            pos=pos.astype(f32), desc=desc, normal=normal.astype(f32),
            min_dist=min_d.astype(f32), max_dist=max_d.astype(f32),
            n_obs=n_obs, n_found=n_found, n_visible=n_visible,
            first_kf=first_kf, valid=valid),
        obs=ms.Observations(kf=obs_kf, kp=obs_kp, valid=obs_valid))

    # The new keyframe as tracking leaves it: its mapped keypoints bound,
    # 8 % of them missed.
    R_true, t_true, _ = poses[K]
    R_new, t_new = _perturb(rng, R_true, t_true, 1.5e-3, 1e-2)
    slot_of = lm_slot[np.maximum(kp_pt[K], 0)]
    bound = kp_valid[K] & (slot_of >= 0) & (rng.random(nf) >= 0.08)
    feats = fast_orb.FrameFeatures(
        xy=kp_xy[K], level=kp_level[K], angle=kp_angle[K],
        response=np.zeros(nf, f32), desc=kp_desc[K], valid=kp_valid[K])
    return MonoMap(
        state=state, kf_id=K, R=R_new.astype(f32), t=t_new.astype(f32),
        stamp=float(np.float32(0.25 * K)), feats=feats,
        bindings=np.where(bound, slot_of, -1).astype(np.int32),
        cam_params=np.array([fx, fy, cx, cy], f32),
        n_lm_hwm=int(np.flatnonzero(valid).max()) + 1,
        R_true=R_true.astype(f32), t_true=t_true.astype(f32),
        cull_kf=p_cull)


# --- The initialisation -----------------------------------------------------

class InitResult(NamedTuple):
    """``mono_initialize``'s result. On failure ``state`` is the map as it
    was and ``bindings``, ``R`` and ``t`` are None."""

    success: bool
    state: ms.MapState
    bindings: object         # (N,) int32 landmark of each current keypoint
    R: object                # (3, 3) keyframe 1's pose after the BA
    t: object
    info: dict


# The three reads of device values on the host that ``_try_initialize`` makes
# for each attempt, by name; ``mono_initialize`` makes the same ones.
INIT_HOST_READS = ("n_matches", "success", "good and points")


def mono_initialize(state, ref, cur, ref_stamp: float, cur_stamp: float,
                    cam_params, generator: torch.Generator = None,
                    idx=None, cfg: MonoConfig = EUROC_MONO,
                    draw=None) -> InitResult:
    """The device half of ``MonoSlam._try_initialize`` against the reference
    frame ``ref``: ``match_for_initialization`` (K2's window mode), the
    two-view solve, the median-depth scale, keyframes 0 (identity) and 1,
    a landmark for each good point, the full-map BA with keyframe 1 free,
    and the current frame's bindings. ``ref`` and ``cur`` are the frames'
    features (``xy``, ``level``, ``angle``, ``desc``, ``valid``); ``state``
    the (empty) map. The RANSAC's (200, 8) sample indices are ``idx``, or
    ``draw(matched)`` of the (N,) matched mask, or are drawn from
    ``generator`` (a generator of the tensors' device) over the matched
    rows.

    The host reads ``INIT_HOST_READS``, as the JAX system does. ``info``
    names the reads it made and holds ``n_matches``, ``used_h``, ``n_good``
    (the new landmarks), ``median_depth``, ``idx`` and ``reason``: None, or
    why it failed ("matches", "two_view", "good" or "depth")."""
    dev = ref.xy.device
    info = {"host_reads": list(INIT_HOST_READS[:1]), "reason": None}

    def failed(reason):
        info["reason"] = reason
        return InitResult(False, state, None, None, None, info)

    mj = tracking.match_for_initialization(
        ref.xy, ref.desc, ref.valid, ref.level, cur.xy, cur.desc, cur.valid,
        cur.level, ref_angle=ref.angle, cur_angle=cur.angle)
    matched = mj >= 0
    info["n_matches"] = int(matched.sum())
    if info["n_matches"] < cfg.min_init_matches:
        return failed("matches")

    if idx is None and draw is not None:
        idx = draw(matched)
    if idx is None:
        if generator is None:
            raise ValueError("mono_initialize: give the RANSAC's indices "
                             "(idx) or a generator to draw them")
        idx = geometry.sample_indices(
            generator, geometry.N_ITERS, geometry.SAMPLE_SIZE,
            matched.to(torch.float32) + 1e-9)
    info["idx"] = idx
    K = mapping._intrinsics(cam_params)
    kp_cur = mj.clamp_min(0)
    res = geometry.two_view_reconstruct(idx, ref.xy, cur.xy[kp_cur.long()], K,
                                        matched)
    info["host_reads"].append(INIT_HOST_READS[1])
    success, info["used_h"] = torch.stack([res.success,
                                           res.used_h]).tolist()
    if not success:
        return failed("two_view")

    info["host_reads"].append(INIT_HOST_READS[2])
    host = torch.cat([res.points, res.good[:, None].to(torch.float32)],
                     1).cpu().numpy()
    good, X = host[:, 3] > 0, host[:, :3]
    info["n_good"] = int(good.sum())
    if info["n_good"] < 50:
        return failed("good")
    med_depth = float(np.median(X[good][:, 2]))
    info["median_depth"] = med_depth
    if med_depth <= 0:
        return failed("depth")
    # float32 products with a float32 scale, as the JAX system's numpy
    # arithmetic makes them.
    inv_md = 1.0 / med_depth
    X_scaled = res.points * inv_md
    R1, t1 = res.R, res.t * inv_md

    n_feat = ref.xy.shape[0]
    zero3 = torch.zeros(3, device=dev)
    state = ms.add_keyframe(state, 0, torch.eye(3, device=dev), zero3,
                            ref_stamp, ref)
    state = ms.add_keyframe(state, 1, R1, t1, cur_stamp, cur)
    slots = torch.cumsum(res.good, 0) - 1
    da = torch.linalg.vector_norm(X_scaled, dim=-1)
    normal = X_scaled / da.clamp_min(1e-9)[:, None]
    max_dist = da * torch.pow(cfg.scale, ref.level.to(torch.float32))
    min_dist = max_dist / cfg.scale ** (cfg.n_levels - 1)
    state = ms.add_landmarks(
        state, slots, X_scaled, ref.desc, 0,
        torch.arange(n_feat, dtype=torch.int32, device=dev), 1, kp_cur,
        res.good, normal, min_dist, max_dist)

    # Keyframe 1 free; an index write of a Python value would synchronise.
    free = torch.arange(state.kfs.valid.shape[0], device=dev) == 1
    state = mapping.local_ba(state, free, cam_params)

    n_cur = cur.xy.shape[0]
    tgt = torch.where(res.good & matched, kp_cur, n_cur)
    bindings = ms.scatter_rows(
        torch.full((n_cur,), -1, dtype=torch.int32, device=dev),
        tgt, torch.where(res.good, slots, -1))
    return InitResult(True, state, bindings, state.kfs.R[1], state.kfs.t[1],
                      info)


class TwoViewScene(NamedTuple):
    """``euroc_mono_two_view``'s frames (numpy, descriptors uint32) and the
    truth: the second camera's pose (x2 = R x1 + t, t in m)."""

    ref: fast_orb.FrameFeatures
    cur: fast_orb.FrameFeatures
    R: np.ndarray
    t: np.ndarray


# The second camera of euroc_mono_two_view's cases: so(3) vector and centre
# (m) in the first camera's frame.
_TWO_VIEW_ROT = (0.01, -0.03, 0.005)
_TWO_VIEW_CENTRE = (0.2, 0.01, 0.02)


def _wrap_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def euroc_mono_two_view(feats, cfg: MonoConfig = EUROC_MONO,
                        case: str = "general", seed: int = 0) -> TwoViewScene:
    """The second frame of a two-view initialisation, made from the
    reference frame's own undistorted features ``feats`` (``xy``,
    ``level``, ``angle``, ``desc``, ``valid``; numpy or tensors): each
    reference keypoint gets a depth and is projected through a second
    camera (0.3 px of noise, 0-4 descriptor bits flipped, its level kept,
    its angle turned by about 0.02 rad); the keypoints left in view are
    shuffled among random distractors up to ``cfg.n_features``.

    ``case`` = "general": depths U(2, 8) m, the second camera 0.2 m to the
    side and turned by about 2 degrees (most points have more than 1 degree
    of parallax; F should win). "planar": the points lie on one plane 1.5 m
    ahead, turned by 0.8 rad about the vertical axis (H should win: its
    runner-up candidate keeps about 60 % of its points, against the 75 %
    that would make the choice ambiguous). "rotation": the same turn
    with no baseline (the initialisation must fail)."""
    if case not in ("general", "planar", "rotation"):
        raise ValueError(f"case: 'general', 'planar' or 'rotation', "
                         f"got {case!r}")
    to_np = (lambda a: convert.to_numpy(a) if isinstance(a, torch.Tensor)
             else np.asarray(a))
    xy = to_np(feats.xy).astype(np.float64)
    level = to_np(feats.level).astype(np.int32)
    angle = to_np(feats.angle).astype(np.float32)
    desc = to_np(feats.desc).astype(np.int32, copy=False).view(np.uint32)
    valid = to_np(feats.valid).astype(bool)
    n = xy.shape[0]
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    ray = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy, np.ones(n)],
                   -1)
    if case == "planar":
        normal = _rodrigues([0.0, 0.8, 0.0]) @ np.array([0.0, 0.0, 1.0])
        depth = 1.5 / (ray @ normal)
    else:
        depth = rng.uniform(2.0, 8.0, n)
    X = ray * depth[:, None]
    R = _rodrigues(_TWO_VIEW_ROT)
    centre = np.zeros(3) if case == "rotation" else np.array(_TWO_VIEW_CENTRE)
    t = -R @ centre
    pc = X @ R.T + t
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy], -1)
    uv += rng.normal(0.0, 0.3, uv.shape)
    keep = (valid & (pc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height))
    kept = np.flatnonzero(keep)
    m = len(kept)
    nf = cfg.n_features
    if m > nf:
        raise ValueError(f"{m} keypoints in view exceed {nf} features")

    flips = np.zeros((m, 8), np.uint32)
    n_bits = rng.integers(0, 5, m)
    for j in range(4):
        pos = rng.integers(0, 256, m)
        bit = np.left_shift(np.uint32(1), (pos % 32).astype(np.uint32))
        flips[np.arange(m), pos // 32] ^= np.where(j < n_bits, bit,
                                                   np.uint32(0))
    n_dis = nf - m
    cur_xy = np.concatenate([uv[kept], np.stack([
        rng.uniform(0, cfg.width, n_dis), rng.uniform(0, cfg.height, n_dis)],
        -1)])
    cur_level = np.concatenate([level[kept],
                                rng.choice(level[valid], n_dis)])
    cur_angle = np.concatenate([
        _wrap_angle(angle[kept] + rng.normal(0.0, 0.02, m)),
        rng.uniform(-np.pi, np.pi, n_dis)])
    cur_desc = np.concatenate([desc[kept] ^ flips,
                               rng.integers(0, 2 ** 32, (n_dis, 8),
                                            dtype=np.uint32)])
    order = rng.permutation(nf)
    f32 = np.float32
    cur = fast_orb.FrameFeatures(
        xy=cur_xy[order].astype(f32), level=cur_level[order].astype(np.int32),
        angle=cur_angle[order].astype(f32), response=np.zeros(nf, f32),
        desc=cur_desc[order], valid=np.ones(nf, bool))
    ref = fast_orb.FrameFeatures(
        xy=xy.astype(f32), level=level, angle=angle,
        response=np.zeros(n, f32), desc=desc, valid=valid)
    return TwoViewScene(ref=ref, cur=cur, R=R.astype(f32), t=t.astype(f32))


# --- The monocular system ---------------------------------------------------

def mono_slam_config(cfg) -> MonoConfig:
    """The :class:`MonoConfig` of a ``pipeline.system.SlamConfig``: the
    constants the entry points take, from the system's configuration (the
    ORB pyramid stays at 8 levels of 1.2, as the system's extraction)."""
    return MonoConfig(
        width=int(cfg.width), height=int(cfg.height), fx=float(cfg.fx),
        fy=float(cfg.fy), cx=float(cfg.cx), cy=float(cfg.cy),
        dist=(None if cfg.dist is None
              else tuple(float(d) for d in np.asarray(cfg.dist))),
        n_features=cfg.n_features, max_kf=cfg.max_kf, max_lm=cfg.max_lm,
        max_obs=cfg.max_obs, n_local_kf=cfg.local_kf_window,
        n_local_lm=cfg.local_lm_window, recent_kf=cfg.recent_kf_window,
        kf_ref_min_obs=cfg.kf_ref_min_obs, local_window=cfg.local_window,
        ba_window=cfg.ba_window, ba_lm_window=cfg.ba_lm_window,
        triangulation_neighbors=cfg.triangulation_neighbors,
        min_init_matches=cfg.min_init_matches)


GOLDEN_FRAMES = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                 / "frames_golden_mono.npz")


class GoldenFrames(NamedTuple):
    """The golden regression run's input: ``SynthWorld(seed=3)`` rendered at
    t = 0.0, 0.1, ..., 4.4 s (``scripts/make_torch_golden_frames.py``)."""

    frames: np.ndarray       # (45, 480, 640) uint8
    stamps: np.ndarray       # (45,) float64 s
    R: np.ndarray            # (45, 3, 3) true world->camera poses
    t: np.ndarray            # (45, 3)
    centres: np.ndarray      # (45, 3) float64 true camera centres
    camera: np.ndarray       # fx, fy, cx, cy, width, height


def golden_frames(path=GOLDEN_FRAMES) -> GoldenFrames:
    """Load the golden frames fixture."""
    with np.load(path) as z:
        return GoldenFrames(**{k: z[k] for k in GoldenFrames._fields})


# The golden run's recorded result (tests/golden/golden_mono.json) and its
# gate (tests/test_golden.py): at least 44 - 2 frames in the trajectory and
# a Horn-scaled ATE below 1.5 x 0.0086 + 0.002 m.
GOLDEN_N_FRAMES = 44
GOLDEN_ATE_M = 0.0086
GOLDEN_ATE_GATE_M = 1.5 * GOLDEN_ATE_M + 0.002
GOLDEN_N_KF_LIVE = 29
GOLDEN_N_LM_LIVE = 1902


def golden_slam_config(**changes):
    """The frozen golden config (``tests/test_golden.py``): the world's
    640x480 pinhole (fx = fy = 400), 1536 features, 48 keyframe and 4096
    landmark slots, 8 observations, 10 fps, the 60-match init gate and
    TrackedMapPoints(1) (the synthetic world's dense keyframe cadence).
    ``changes`` replace fields."""
    from .pipeline.system import SlamConfig
    cfg = SlamConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                     height=480, n_features=1536, max_kf=48, max_lm=4096,
                     max_obs=8, fps=10, min_init_matches=60,
                     kf_ref_min_obs=1)
    return dataclasses.replace(cfg, **changes)


# The EuRoC-mono run's frames: the golden frames padded on the right to
# EuRoC's 752 columns with the world's background value.
EUROC_PAD_VALUE = 30


def euroc_golden_config(**changes):
    """The golden frames at the EuRoC-mono capacity (:data:`EUROC_MONO`: 8
    ORB levels of 1.2, 1024 keyframe and 65536 landmark slots, 12
    observations, a window of 20 + 4 keyframes and 4096 landmarks, the
    bundle's windows) on 752x480 frames, with the synthetic world's
    settings: its pinhole camera (no radtan), 10 fps, the 60-match init
    gate, TrackedMapPoints(1) and 1536 features. With EuRoC's 1200 features
    the world's frames never initialise: adjacent frames keep about 120
    level-0 matches but too little parallax, frames 0.2 s apart about 55,
    under the gate, so the reference frame keeps moving on. ``changes``
    replace fields."""
    from .pipeline.system import SlamConfig
    e = EUROC_MONO
    cfg = SlamConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=e.width,
                     height=e.height, n_features=1536,
                     max_kf=e.max_kf, max_lm=e.max_lm, max_obs=e.max_obs,
                     fps=10, local_window=e.local_window,
                     ba_window=e.ba_window, ba_lm_window=e.ba_lm_window,
                     local_kf_window=e.n_local_kf,
                     local_lm_window=e.n_local_lm,
                     recent_kf_window=e.recent_kf, min_init_matches=60,
                     kf_ref_min_obs=1)
    return dataclasses.replace(cfg, **changes)


def pad_frames(frames: np.ndarray, width: int = EUROC_MONO.width,
               value: int = EUROC_PAD_VALUE) -> np.ndarray:
    """(F, H, W) frames padded on the right to ``width`` columns of
    ``value``."""
    f, h, w = frames.shape
    out = np.full((f, h, width), value, frames.dtype)
    out[:, :, :w] = frames
    return out


# --- Rectified stereo and RGB-D ---------------------------------------------

class RigConfig(NamedTuple):
    """A rectified stereo (or RGB-D) deployment: the left camera's
    :class:`MonoConfig` and the rig's constants (the port's own copy)."""

    mono: MonoConfig
    bf: float              # baseline x fx (Camera.bf)
    th_depth: float = 35.0  # Stereo.ThDepth
    min_z: float = 0.3     # the closest depth the stereo search admits

    @property
    def depth_threshold(self) -> float:
        """The close-point depth: bf / fx x ThDepth."""
        return self.bf / self.mono.fx * self.th_depth


# KITTI odometry 00-02 as ``scripts/run_kitti.py --stereo --no-vocabulary``
# runs it (``configs/KITTI00-02.yaml``): the rectified 1241x376 pair with no
# distortion, bf = 0.53716 x 718.856, ThDepth 35 (close points within
# 18.80 m), 2000 features over 8 levels at 1.2, the runner's 1024 keyframe
# and 65536 landmark slots, and the system's windows.
KITTI_STEREO = RigConfig(
    mono=MonoConfig(width=1241, height=376, fx=718.856, fy=718.856,
                    cx=607.1928, cy=185.2157, dist=None, n_features=2000),
    bf=0.53716 * 718.856, th_depth=35.0)
# The example pair's right image is the left one shifted this many pixels
# left: a fronto-parallel plane at bf / 32 (12.07 m at KITTI's bf).
KITTI_PAIR_SHIFT = 32


class StereoFrameArgs(NamedTuple):
    """``stereo_frame_step``'s arguments: the rectified pair, then
    :class:`MonoFrameArgs`' fields after its image."""

    img_l: object
    img_r: object
    R_pred: object
    t_pred: object
    R_last: object
    t_last: object
    lm_pos: object
    lm_desc: object
    lm_normal: object
    lm_min_d: object
    lm_max_d: object
    lm_valid: object
    last_bind: object
    last_desc: object
    last_angle: object
    obs_kf: object
    obs_valid: object
    ref_kf: object
    n_kf: object
    n_found: object
    n_visible: object
    cam_params: object
    dist: object


def _no_stage(name: str):
    return contextlib.nullcontext()


def stereo_extract(img_l, img_r, cam_params, dist,
                   rig: RigConfig = KITTI_STEREO, stage=_no_stage):
    """``StereoSlam``'s extraction: the ORB features of each image (K1 once
    each), then ``stereo.stereo_match`` of the left keypoints into the right
    image (plain PyTorch). img_l / img_r: (H, W) float32. ``stage(name)``:
    the caller's stage timer ("orb_extract", "stereo_match"). Returns (left
    features, right features, StereoMatchResult)."""
    from .ops import stereo
    with stage("orb_extract"):
        f_l = mono_extract(img_l, cam_params, dist, rig.mono)
        f_r = mono_extract(img_r, cam_params, dist, rig.mono)
    with stage("stereo_match"):
        m = stereo.stereo_match(f_l.xy, f_l.level, f_l.desc, f_l.valid,
                                f_r.xy, f_r.level, f_r.desc, f_r.valid,
                                img_l, img_r, rig.bf, rig.min_z)
    return f_l, f_r, m


def stereo_frame_step(img_l, img_r, R_pred, t_pred, R_last, t_last,
                      lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                      lm_valid, last_bind, last_desc, last_angle, obs_kf,
                      obs_valid, ref_kf, n_kf, n_found, n_visible,
                      cam_params, dist, rig: RigConfig = KITTI_STEREO):
    """One stereo tracking frame, as ``StereoSlam.track`` runs it:
    ``stereo_extract``, then ``tracking.frame_step(use_stereo=True)`` (the
    mono motion model, the local window, the final pose optimization with
    the stereo rows on K3s, the close-point counters). Arguments as
    :class:`StereoFrameArgs`. Returns (TrackResult, info, n_found,
    n_visible, StereoMatchResult)."""
    f, _, m = stereo_extract(img_l, img_r, cam_params, dist, rig)
    cfg = rig.mono
    res, info, n_found, n_visible = tracking.frame_step(
        R_pred, t_pred, R_last, t_last,
        lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
        last_bind, last_desc, last_angle,
        f.xy, f.level, f.desc, f.valid, f.angle, m.u_right,
        float(rig.bf), float(rig.depth_threshold),
        obs_kf, obs_valid, ref_kf, cfg.kf_ref_min_obs, n_kf,
        n_found, n_visible, cam_params, cfg.width, cfg.height,
        use_stereo=True, **_mono_window(cfg))
    return res, info, n_found, n_visible, m


def kitti_stereo_pair(rig: RigConfig = KITTI_STEREO):
    """The example pair at the rig's size: ``example_image`` and the same
    image shifted ``KITTI_PAIR_SHIFT`` px left (wrapped round), a
    fronto-parallel plane at bf / 32. float32 numpy (left, right)."""
    left = example_image(rig.mono.height, rig.mono.width)
    return left, np.roll(left, -KITTI_PAIR_SHIFT, axis=1)


def kitti_stereo_scene(feats_xy, feats_level, feats_desc, feats_angle,
                       feats_valid, depth, case: str = "normal",
                       rig: RigConfig = KITTI_STEREO,
                       seed: int = 0) -> StereoFrameArgs:
    """A map at the rig's full capacity that the example pair tracks
    against (numpy in and out; the true pose is the identity), built as
    :func:`euroc_mono_scene` builds it, with each of the left frame's own
    features lifted to its stereo depth (``depth`` (N,), as
    ``stereo_extract`` gave it; the plane's bf / 32 where there is none)."""
    depth = np.asarray(depth, np.float64)
    plane = rig.bf / KITTI_PAIR_SHIFT
    scene = euroc_mono_scene(
        feats_xy, feats_level, feats_desc, feats_angle, feats_valid,
        cfg=rig.mono, case=case, seed=seed,
        depth=np.where(depth > 0, depth, plane))
    left, right = kitti_stereo_pair(rig)
    return StereoFrameArgs(left, right, *scene[1:])


def rig_config(cfg) -> RigConfig:
    """The :class:`RigConfig` of a ``pipeline.stereo_system.StereoConfig``."""
    return RigConfig(mono=mono_slam_config(cfg), bf=float(cfg.bf),
                     th_depth=float(cfg.th_depth), min_z=float(cfg.min_z))


STEREO_FRAMES = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                 / "frames_stereo.npz")


class StereoFrames(NamedTuple):
    """The stereo and RGB-D runs' input: ``SynthWorld(seed=11)`` rendered
    as a rectified pair (baseline 0.2 m) with the left camera's depth image
    at t = 0.0, 0.1, ..., 2.9 s (``scripts/make_torch_stereo_frames.py``)."""

    left: np.ndarray         # (30, 480, 640) uint8
    right: np.ndarray        # (30, 480, 640) uint8
    depth: np.ndarray        # (30, 480, 640) uint16, z x depth_factor
    stamps: np.ndarray       # (30,) float64 s
    R: np.ndarray            # (30, 3, 3) true world->left-camera poses
    t: np.ndarray            # (30, 3)
    centres: np.ndarray      # (30, 3) float64 true left camera centres
    camera: np.ndarray       # fx, fy, cx, cy, width, height
    baseline: float
    depth_factor: float


def stereo_frames(path=STEREO_FRAMES) -> StereoFrames:
    """Load the stereo frames fixture."""
    with np.load(path) as z:
        return StereoFrames(**{k: (z[k] if z[k].ndim else float(z[k]))
                               for k in StereoFrames._fields})


# The stereo runs' gate (tests/test_stereo_system.py): more than 20 frames
# associated, the ATE without scale alignment under 0.12 m, and the path
# length within 5 % of the truth.
STEREO_MIN_FRAMES = 20
STEREO_ATE_GATE_M = 0.12
STEREO_PATH_TOL = 0.05
# The JAX package's RgbdSlam on the same frames at TUM1's settings
# (``scripts/stereo_reference_jax.py rgbd`` on the CPU): 30 frames, ATE
# without scale alignment 0.007657 m. The RGB-D runs' gate: that frame
# count +- 1 and an ATE under 1.5 x 0.007657 + 0.002 m.
RGBD_JAX_FRAMES = 30
RGBD_JAX_ATE_M = 0.007657241287320005


def stereo_golden_config(**changes):
    """``tests/test_stereo_system.py``'s configuration: the world's 640x480
    pinhole (fx = fy = 400), bf = 0.2 x 400 = 80, ThDepth 35, 1024
    features, 32 keyframe / 4096 landmark slots, 8 observations, 10 fps,
    TrackedMapPoints(1). ``changes`` replace fields."""
    from .pipeline.stereo_system import StereoConfig
    cfg = StereoConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                       height=480, n_features=1024, max_kf=32, max_lm=4096,
                       max_obs=8, fps=10, kf_ref_min_obs=1, bf=80.0,
                       th_depth=35.0)
    return dataclasses.replace(cfg, **changes)


# The KITTI-capacity run's frames: the stereo frames padded on the right to
# KITTI's 1241 columns with the world's background and cropped to its 376
# rows, 52..427 (so cy = 240 - 52 = 188).
KITTI_CROP_TOP = 52


def kitti_frames(frames: np.ndarray, rig: RigConfig = KITTI_STEREO,
                 value: int = EUROC_PAD_VALUE) -> np.ndarray:
    """(F, 480, 640) frames padded right to the rig's width with ``value``
    and cropped to its height from row ``KITTI_CROP_TOP``."""
    top = KITTI_CROP_TOP
    return pad_frames(frames, rig.mono.width, value)[
        :, top:top + rig.mono.height]


def kitti_golden_config(**changes):
    """The stereo frames at :data:`KITTI_STEREO`'s size and capacity: 2000
    features, 1024 keyframe / 65536 landmark slots, 12 observations,
    ThDepth 35, the system's windows, on 1241x376 frames
    (:func:`kitti_frames`), with the synthetic world's camera (fx = fy =
    400, bf = 80, cx = 320, cy = 188), 10 fps and TrackedMapPoints(1).
    ``changes`` replace fields."""
    from .pipeline.stereo_system import StereoConfig
    k = KITTI_STEREO.mono
    cfg = StereoConfig(fx=400.0, fy=400.0, cx=320.0,
                       cy=240.0 - KITTI_CROP_TOP, width=k.width,
                       height=k.height, n_features=k.n_features,
                       max_kf=k.max_kf, max_lm=k.max_lm, max_obs=k.max_obs,
                       fps=10, kf_ref_min_obs=1, bf=80.0,
                       th_depth=KITTI_STEREO.th_depth)
    return dataclasses.replace(cfg, **changes)


def tum_rgbd_golden_config(**changes):
    """The stereo frames' left images and depth at TUM1's RGB-D settings
    (``configs/TUM1_rgbd.yaml`` as ``scripts/run_tum_rgbd.py`` runs it):
    1000 features, bf 40, ThDepth 40, DepthMapFactor 5000, 1024 keyframe /
    65536 landmark slots, 12 observations; with the synthetic world's camera
    (fx = fy = 400, 640x480), 10 fps and TrackedMapPoints(1). ``changes``
    replace fields."""
    from .pipeline.stereo_system import RgbdConfig
    cfg = RgbdConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                     height=480, n_features=1000, max_kf=1024, max_lm=65536,
                     max_obs=12, fps=10, kf_ref_min_obs=1, bf=40.0,
                     th_depth=40.0, depth_scale=5000.0)
    return dataclasses.replace(cfg, **changes)


# --- The stereo-inertial device path ----------------------------------------

class ViConfig(NamedTuple):
    """A visual-inertial deployment: the rig, the IMU, the VI-BA sizes and
    the IMU-initialisation gates (the port's own copy of
    ``MonoInertialSlam``'s defaults and ``StereoInertialSlam``'s gates)."""

    rig: RigConfig
    imu: object                   # ops.imu.ImuConfig
    viba_window: int = 24         # local VI-BA keyframes
    viba_free: int = 10           # of which the newest are free
    viba_landmarks: int = 4096    # VI-BA landmark slots
    full_viba_kf: int = 64        # full VI-BA keyframes
    init_prior: tuple = (1e2, 1e5)   # bias prior (gyro, accel) at the init
    fix_scale: bool = True        # stereo: the init keeps the scale


# EuRoC's IMU.T_b_c1 (body <- left camera), configs/EuRoC_stereo_inertial.yaml.
EUROC_T_BC = np.array(
    [[0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
     [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
     [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
     [0.0, 0.0, 0.0, 1.0]], np.float32)


def _euroc_stereo_inertial() -> ViConfig:
    from .ops.imu import ImuConfig
    return ViConfig(
        rig=RigConfig(
            mono=MonoConfig(width=752, height=480, fx=436.2443, fy=436.2443,
                            cx=364.4412, cy=256.9517, dist=None,
                            n_features=1200),
            bf=48.0208, th_depth=60.0),
        imu=ImuConfig(T_bc=EUROC_T_BC, gyro_noise=1.7e-4, acc_noise=2.0e-3,
                      gyro_walk=1.9393e-5, acc_walk=3.0e-3, freq=200.0))


# EuRoC stereo-inertial as ``scripts/run_euroc_stereo_inertial.py
# --no-vocabulary`` runs it (``configs/EuRoC_stereo_inertial.yaml``): the
# pair rectified to a pinhole with no distortion (fx = fy = 436.2443, cx =
# 364.4412, cy = 256.9517, bf = 48.0208, so a 0.1101 m baseline, from the
# JAX package's ``io/rectify.build_rectification``: host-side OpenCV
# preprocessing the card's machine lacks, so they are constants here),
# ThDepth 60 (close points within 6.605 m), 1200 features over 8 levels at
# 1.2, 20 fps; the IMU at 200 Hz with the yaml's noise, walk and T_b_c1;
# 1024 keyframe, 65536 landmark and 12 observation slots; the VI-BA sizes
# of MonoInertialSlam and the stereo IMU-init gates.
EUROC_STEREO_INERTIAL = _euroc_stereo_inertial()


def mono_inertial_gates(cfg: ViConfig) -> ViConfig:
    """``cfg`` with the monocular IMU-init gates: the (1e2, 1e10) prior, a
    free scale."""
    return cfg._replace(init_prior=(1e2, 1e10), fix_scale=False)


def vi_context(cfg: ViConfig = EUROC_STEREO_INERTIAL, device=None,
               stereo: bool = True):
    """The inertial functions' constants (``inertial_system.ViContext``) of
    ``cfg`` on ``device`` (``None``: the card); ``stereo=False`` leaves the
    stereo rows out (a monocular map)."""
    from .pipeline import inertial_system as vi
    m = cfg.rig.mono
    return vi.make_context(
        cfg.imu, [m.fx, m.fy, m.cx, m.cy], cfg.rig.bf if stereo else None,
        cfg.rig.depth_threshold if stereo else 0.0, m.width, m.height,
        _mono_window(m), m.kf_ref_min_obs, cfg.viba_window, cfg.viba_free,
        cfg.viba_landmarks, cfg.full_viba_kf, device=device)


class ViFrameArgs(NamedTuple):
    """``vi_frame_step``'s arguments: the pair, the last frame, the map,
    the inertial state and the IMU samples. Tensors on the device, except
    where noted (host values, as the system keeps them)."""

    img_l: object            # (H, W) float32
    img_r: object
    last_bind: object        # (N,) int32
    last_desc: object        # (N, 8)
    last_angle: object       # (N,)
    lms: object              # map_state.Landmarks
    obs: object              # map_state.Observations
    n_kf: int                # host: live keyframes
    last_kf_id: int          # host: the reference keyframe
    body: tuple              # (R_wb, p_w, v_w) the last frame's body state
    bias: np.ndarray         # host (6,): [bg, ba]
    imu: tuple               # host: (ts, gyr, acc) samples in (t0, t1]
    t0: float                # host: the last frame's stamp
    t1: float                # host: this frame's stamp
    prior_H: object          # (15, 15) the last frame's H_marg, or None


def vi_frame_step(args: ViFrameArgs, ctx, cfg: ViConfig = EUROC_STEREO_INERTIAL):
    """One stereo-inertial tracking frame, as ``StereoInertialSlam.track``
    runs ``_track_inertial``: with a carried prior its square root first
    (``inertial.prior_sqrt``, the one synchronisation besides the read:
    ``torch.linalg.eigh``, here while the device is idle), then
    ``stereo_extract`` (K1 twice and the stereo match) and
    ``inertial_system.track_inertial`` (the window's preintegration and
    prediction, the motion model from it (K2, K3) with the fallback to the
    prediction, the local map with stereo rows (K2, K3s), the pose-inertial
    optimization, the epilogue and its one packed read). ``ctx``:
    :func:`vi_context` of ``cfg``. Returns (ViFrameResult, left features,
    StereoMatchResult)."""
    from .pipeline import inertial_system as vi
    from .solver import inertial
    prior_L = (None if args.prior_H is None
               else inertial.prior_sqrt(args.prior_H))
    f, _, m = stereo_extract(args.img_l, args.img_r, ctx.cam_params, None,
                             cfg.rig)
    res = vi.track_inertial(
        f, m.u_right, m.depth, args.last_bind, args.last_desc,
        args.last_angle, args.lms, args.obs, args.n_kf, args.last_kf_id,
        args.body, args.bias, args.imu, args.t0, args.t1, ctx,
        prior_H=args.prior_H, prior_L=prior_L)
    return res, f, m


def vi_keyframe_step(imap, kf_id: int, map_first_kf: int, ctx):
    """``MonoInertialSlam._local_inertial_ba`` for a new keyframe
    ``kf_id``: the visual-inertial BA over the chain's last
    ``viba_window`` keyframes (the newest ``viba_free`` free) and
    ``viba_landmarks`` landmark slots, stages (4, 6), written back to the
    map. ``imap``: an ``inertial_system.InertialMap``. No host read."""
    from .pipeline import inertial_system as vi
    return vi.local_inertial_ba(imap, kf_id, map_first_kf, ctx)


def vi_initialize(imap, kf_id: int, ctx, cfg: ViConfig = EUROC_STEREO_INERTIAL):
    """The device work of ``MonoInertialSlam._initialize_imu`` at keyframe
    ``kf_id``: ``inertial_refit`` (the inertial-only solve of gravity,
    scale, biases and velocities over the chain, ``cfg.init_prior``, the
    scale fixed with ``cfg.fix_scale``; the map's gravity and scale rebase),
    then, when the scale came out finite and at least 0.1, the full VI-BA
    over up to ``full_viba_kf`` keyframes with the same bias prior, stages
    (5, 10). One host read: the scale with the biases. Returns (imap',
    RefitResult, whether it initialised)."""
    from .pipeline import inertial_system as vi
    imap, fit = vi.inertial_refit(imap, kf_id, cfg.init_prior[0],
                                  cfg.init_prior[1], cfg.fix_scale, ctx)
    if not np.isfinite(fit.scale) or fit.scale < 1e-1:
        return imap, fit, False
    imap = vi.full_inertial_ba(imap, kf_id, cfg.init_prior[0],
                               cfg.init_prior[1], ctx)
    return imap, fit, True


# The stereo-inertial example pair's right image is the left one shifted
# this many pixels: a fronto-parallel plane at bf / 12 = 4.0017 m, inside
# EuRoC's 6.605 m close-point depth.
VI_PAIR_SHIFT = 12
# The frame step's IMU window: a frame period of 0.05 s (20 fps) sampled at
# 200 Hz, the samples offset by half a period from the frames (boundary
# splitting on both ends: 11 steps).
VI_T0, VI_T1 = 10.0, 10.05
# euroc_vi_scene's true body motion over the window (constant): body rate
# (rad/s), world acceleration (m/s^2), velocity at the frame (m/s); and the
# IMU's bias [bg, ba].
VI_OMEGA = (0.1, -0.2, 0.15)
VI_ACCEL = (0.3, -0.2, 0.1)
VI_VEL = (0.5, 0.1, -0.2)
VI_BIAS = (0.002, -0.001, 0.0015, 0.03, -0.02, 0.01)


def euroc_vi_pair(cfg: ViConfig = EUROC_STEREO_INERTIAL):
    """The example pair at the rig's size: ``example_image`` and the same
    image shifted ``VI_PAIR_SHIFT`` px left (wrapped round). float32 numpy
    (left, right)."""
    m = cfg.rig.mono
    left = example_image(m.height, m.width)
    return left, np.roll(left, -VI_PAIR_SHIFT, axis=1)


def _so3_log_np(R) -> np.ndarray:
    """Rotation -> so(3) vector (float64, away from pi)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (0.5 if th < 1e-9 else th / (2.0 * np.sin(th)))


class ViScene(NamedTuple):
    """``vi_frame_step``'s inputs as numpy (the map's rows as
    :class:`MonoFrameArgs` names them) and the truth: the frame's camera
    is at the identity, its body state ``R_true``, ``p_true``,
    ``v_true``."""

    img_l: np.ndarray
    img_r: np.ndarray
    scene: MonoFrameArgs     # the map and the last frame (its img unused)
    body: tuple              # (R_wb, p_w, v_w) the last frame's estimate
    bias: np.ndarray         # (6,)
    imu: tuple               # (ts, gyr, acc) in (t0, t1]
    t0: float
    t1: float
    prior_H: np.ndarray | None
    R_true: np.ndarray       # body state at t1
    p_true: np.ndarray
    v_true: np.ndarray


def euroc_vi_scene(feats_xy, feats_level, feats_desc, feats_angle,
                   feats_valid, depth, case: str = "keyframe",
                   cfg: ViConfig = EUROC_STEREO_INERTIAL,
                   seed: int = 0) -> ViScene:
    """A frame that ``vi_frame_step`` tracks (numpy in and out): the map of
    :func:`euroc_mono_scene` at ``cfg``'s capacity, the left frame's own
    features lifted to their stereo depths (``depth`` (N,) from
    ``stereo_extract`` of :func:`euroc_vi_pair`; the plane's bf / 12 where
    there is none), with the true camera at the identity; and an IMU
    window (``VI_T0``, ``VI_T1``] of 200 Hz samples of a body moving at
    constant rate ``VI_OMEGA`` and world acceleration ``VI_ACCEL`` with the
    known bias ``VI_BIAS``. The last frame's body state is the truth at
    ``VI_T0`` off by about 0.5 mrad, 2 mm and 0.02 m/s (the system's
    estimate).

    ``case`` = "keyframe": no prior (the LastKeyFrame variant). "prior": a
    carried 15 x 15 marginal prior, one eigenvalue slightly negative (the
    PSD projection must act). "fallback": the last frame keeps only 8
    bindings, so the motion model finds fewer than 10 inliers and the IMU
    prediction is taken."""
    if case not in ("keyframe", "prior", "fallback"):
        raise ValueError(f"case: 'keyframe', 'prior' or 'fallback', "
                         f"got {case!r}")
    rig = cfg.rig
    depth = np.asarray(depth, np.float64)
    plane = rig.bf / VI_PAIR_SHIFT
    scene = euroc_mono_scene(
        feats_xy, feats_level, feats_desc, feats_angle, feats_valid,
        cfg=rig.mono, case="normal", seed=seed,
        depth=np.where(depth > 0, depth, plane))
    if case == "fallback":
        bound = np.flatnonzero(scene.last_bind >= 0)
        keep = np.full_like(scene.last_bind, -1)
        keep[bound[:8]] = scene.last_bind[bound[:8]]
        scene = scene._replace(last_bind=keep)
    left, right = euroc_vi_pair(cfg)

    rng = np.random.default_rng(seed + 1)
    T = np.asarray(cfg.imu.T_bc, np.float64)
    R_bc, t_bc = T[:3, :3], T[:3, 3]
    R1 = R_bc.T                         # the camera at the identity
    p1 = -R_bc.T @ t_bc
    w = np.array(VI_OMEGA)
    a_w = np.array(VI_ACCEL)
    v1 = np.array(VI_VEL)
    g = np.array([0.0, 0.0, -9.81])
    bias = np.array(VI_BIAS)

    def state(t):
        d = t - VI_T1
        return (R1 @ _rodrigues(w * d), v1 + a_w * d,
                p1 + v1 * d + 0.5 * a_w * d * d)

    period = 1.0 / cfg.imu.freq
    ts = VI_T0 + period / 2 + period * np.arange(
        int(round((VI_T1 - VI_T0) / period)))
    gyr = np.tile(w + bias[:3], (len(ts), 1))
    acc = np.stack([state(t)[0].T @ (a_w - g) for t in ts]) + bias[3:]
    R0, v0, p0 = state(VI_T0)
    R0 = R0 @ _rodrigues(rng.normal(0, 5e-4 / np.sqrt(3), 3))
    dp = rng.normal(0, 2e-3 / np.sqrt(3), 3)
    dv = rng.normal(0, 2e-2 / np.sqrt(3), 3)

    prior_H = None
    if case == "prior":
        # The last frame's pose firmly held (information 1e5 to 1e6) and
        # about 0.2 mm off, its velocity about 0.1 m/s off and weakly held
        # (1 to 10): the joint solve must take the velocity from the
        # inertial link to the tracked pose, far from the prediction. The
        # biases held at 1e6 (gyro) and 1e4 (accel). Each block in a random
        # basis; the smallest eigenvalue -1e-3 (a float32 Schur complement
        # is only nearly PSD).
        dp, dv = dp / 10, dv * 5
        lams = ([-1e-3] + list(np.logspace(5.0, 6.0, 5)),
                np.logspace(0.0, 1.0, 3), [1e6] * 3, [1e4] * 3)
        prior_H = np.zeros((15, 15))
        i = 0
        for lam in lams:
            Q, _ = np.linalg.qr(rng.normal(size=(len(lam), len(lam))))
            prior_H[i:i + len(lam), i:i + len(lam)] = (Q * lam) @ Q.T
            i += len(lam)
    p0 = p0 + dp
    v0 = v0 + dv
    f32 = np.float32
    return ViScene(
        img_l=left, img_r=right, scene=scene,
        body=(R0.astype(f32), p0.astype(f32), v0.astype(f32)),
        bias=bias.astype(f32),
        imu=(ts, gyr.astype(f32), acc.astype(f32)), t0=VI_T0, t1=VI_T1,
        prior_H=None if prior_H is None else prior_H.astype(f32),
        R_true=R1.astype(f32), p_true=p1.astype(f32), v_true=v1.astype(f32))


def vi_frame_args(s: ViScene, device=None) -> ViFrameArgs:
    """:class:`ViFrameArgs` of a :class:`ViScene` on ``device`` (``None``:
    the card)."""
    t = lambda a: convert.to_torch(a, device)
    sc = s.scene
    n_obs = np.asarray(sc.obs_valid).sum(-1).astype(np.int32)
    lms = ms.Landmarks(
        pos=t(sc.lm_pos), desc=t(sc.lm_desc), normal=t(sc.lm_normal),
        min_dist=t(sc.lm_min_d), max_dist=t(sc.lm_max_d), n_obs=t(n_obs),
        n_found=t(sc.n_found), n_visible=t(sc.n_visible),
        first_kf=t(np.zeros_like(n_obs)), valid=t(sc.lm_valid))
    obs = ms.Observations(kf=t(sc.obs_kf), kp=t(np.zeros_like(sc.obs_kf)),
                          valid=t(sc.obs_valid))
    return ViFrameArgs(
        img_l=t(s.img_l), img_r=t(s.img_r), last_bind=t(sc.last_bind),
        last_desc=t(sc.last_desc), last_angle=t(sc.last_angle), lms=lms,
        obs=obs, n_kf=int(sc.n_kf), last_kf_id=int(sc.ref_kf),
        body=tuple(t(a) for a in s.body), bias=s.bias, imu=s.imu, t0=s.t0,
        t1=s.t1, prior_H=None if s.prior_H is None else t(s.prior_H))


# --- The keyframe and init steps' maps --------------------------------------

# euroc_mono_map's frame (camera-like: y down, z forward) -> the inertial
# world (z up, gravity along -z): forward becomes +y, down becomes -z.
_Q_WORLD = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
_KF_DT = 0.25          # euroc_mono_map's keyframe stamps, s


def _vi_truth(cfg: ViConfig, n_views: int, centre0, rot0, bias):
    """A body trajectory whose keyframe states are exactly what the
    preintegration of its IMU samples gives (as tests/test_inertial.py's
    chains are made): 200 Hz samples (bias added) of the analytic camera
    path ``centre0(t)``, ``rot0(t)`` (R_wc, in euroc_mono_map's frame)
    taken into the inertial world, then the true states rolled forward from
    t = 0 through each keyframe interval's integration steps in float64.
    Returns (ts, gyr, acc, R_wb (V, 3, 3), p_w (V, 3), v_w (V, 3)) at the
    keyframe stamps k * 0.25 s."""
    from .pipeline import inertial_system as vi
    T = np.asarray(cfg.imu.T_bc, np.float64)
    R_bc, t_bc = T[:3, :3], T[:3, 3]
    g = np.array([0.0, 0.0, -9.81])
    Q = _Q_WORLD

    def body(t):
        R_wc = Q @ rot0(t)
        return R_wc @ R_bc.T, Q @ centre0(t) - R_wc @ R_bc.T @ t_bc

    h = 1e-3
    n_s = int(round(_KF_DT * (n_views - 1) * cfg.imu.freq))
    ts = np.arange(n_s + 1) / cfg.imu.freq
    gyr = np.zeros((len(ts), 3))
    acc = np.zeros((len(ts), 3))
    for i, t in enumerate(ts):
        (Rm, pm), (R, p), (Rp, pp) = body(t - h), body(t), body(t + h)
        gyr[i] = _so3_log_np(Rm.T @ Rp) / (2 * h)
        acc[i] = R.T @ ((pp - 2 * p + pm) / (h * h) - g)
    gyr_m = (gyr + bias[:3]).astype(np.float32)
    acc_m = (acc + bias[3:]).astype(np.float32)

    R, p = body(0.0)
    v = (body(h)[1] - body(-h)[1]) / (2 * h)
    Rs, ps, vs = [R], [p], [v]
    for k in range(1, n_views):
        t0, t1 = _KF_DT * (k - 1), _KF_DT * k
        sel = (ts > t0) & (ts <= t1)
        a, w, dts = vi.make_steps(ts[sel], gyr_m[sel], acc_m[sel], t0, t1,
                                  vi.KF_STEPS)
        for aj, wj, dt in zip(a.astype(np.float64) - bias[3:],
                              w.astype(np.float64) - bias[:3],
                              dts.astype(np.float64)):
            if dt <= 0:
                continue
            p = p + v * dt + 0.5 * g * dt * dt + 0.5 * R @ aj * dt * dt
            v = v + g * dt + R @ aj * dt
            R = R @ _rodrigues(wj * dt)
        Rs.append(R)
        ps.append(p)
        vs.append(v)
    return ts, gyr_m, acc_m, np.stack(Rs), np.stack(ps), np.stack(vs)


def _kf_preints(cfg: ViConfig, ts, gyr, acc, ks, bias) -> dict:
    """Keyframe k's preintegration over (stamp k-1, stamp k] at
    linearization bias ``bias`` (6,), for each k of ``ks``: numpy
    PreintStates from the port's ``imu.integrate`` on the CPU (all
    intervals as one batch, cut to the longest one's samples)."""
    from .ops import imu
    from .pipeline import inertial_system as vi
    steps = []
    for k in ks:
        t0, t1 = _KF_DT * (k - 1), _KF_DT * k
        sel = (ts > t0) & (ts <= t1)
        steps.append(vi.make_steps(ts[sel], gyr[sel], acc[sel], t0, t1,
                                   vi.KF_STEPS))
    # The real rows come first: cut the padding that none of them needs.
    n = max(int(np.flatnonzero(d > 0)[-1]) + 1 for _, _, d in steps)
    a, w, dts = (torch.from_numpy(np.stack([s[i][:n] for s in steps]))
                 for i in range(3))
    b = torch.from_numpy(np.tile(np.asarray(bias, np.float32), (len(ks), 1)))
    pre = imu.integrate(a, w, dts, b,
                        torch.from_numpy(cfg.imu.noise_cov()),
                        torch.from_numpy(cfg.imu.walk_cov()))
    return {k: imu.PreintState(*(x[i].numpy() for x in pre))
            for i, k in enumerate(ks)}


class ViMap(NamedTuple):
    """A map with its inertial state (numpy, the JAX package's dtypes) and
    the truth."""

    state: ms.MapState
    kf_vel: np.ndarray       # (max_kf, 3) the system's estimates
    kf_bg: np.ndarray
    kf_ba: np.ndarray
    kf_prev: np.ndarray      # (max_kf,) int32 chain
    kf_preint: list          # per slot: numpy PreintState or None
    kf_stamp: np.ndarray     # (max_kf,) float64
    kf_id: int               # the newest keyframe
    map_first_kf: int
    R_true: np.ndarray       # (K, 3, 3) true R_cw of the live keyframes
    t_true: np.ndarray       # (K, 3)
    v_true: np.ndarray       # (K, 3) true body velocities (world)
    bias_true: np.ndarray    # (6,)
    R_vw: np.ndarray         # the map's world <- the gravity-aligned world
    scale: float             # metric = scale x map units


def vi_map_args(m: ViMap, device=None):
    """An ``inertial_system.InertialMap`` of a :class:`ViMap` on ``device``
    (``None``: the card)."""
    return convert.inertial_map_to_torch(
        m.state, m.kf_vel, m.kf_bg, m.kf_ba, m.kf_prev, m.kf_preint,
        m.kf_stamp, device)


def _vi_map(cfg: ViConfig, n_live_kf: int, centre0, rot0, bias, n_preint,
            seed: int, R_vw, scale: float, stereo: bool, view_points: int,
            perturb, bias_lin) -> ViMap:
    """The map of :func:`euroc_mono_map` on the rolled true path of
    :func:`_vi_truth`, taken into the inertial world, then into the map's
    world x' = R_vw x / scale; the chain 0 -> 1 -> ... -> K-1 with the
    last ``n_preint`` keyframes' preintegrations, linearized at
    ``bias_lin``; ``perturb(rng, R_cw, t_cw, v, k)`` gives keyframe k's
    estimates (R_cw, t_cw, v, bias (6,))."""
    K = n_live_kf
    ts, gyr, acc, Rwb, pw, vw = _vi_truth(cfg, K + 1, centre0, rot0, bias)
    T = np.asarray(cfg.imu.T_bc, np.float64)
    R_cb = T[:3, :3].T
    t_cb = -R_cb @ T[:3, 3]
    Q = _Q_WORLD
    R_cw = np.einsum("ij,kjl->kil", R_cb, Rwb.transpose(0, 2, 1))
    t_cw = t_cb - np.einsum("kij,kj->ki", R_cw, pw)
    centres = pw + np.einsum("kij,j->ki", Rwb, T[:3, 3])

    def path(k):                        # in euroc_mono_map's frame
        return R_cw[k] @ Q, t_cw[k], Q.T @ centres[k]

    m = euroc_mono_map(cfg.rig.mono, seed=seed, n_live_kf=K,
                       view_points=view_points, path=path,
                       bf=cfg.rig.bf if stereo else None,
                       ur_depth=cfg.rig.depth_threshold)
    st = m.state
    # euroc_mono_map's frame -> the inertial world -> the map's world.
    M = np.asarray(R_vw, np.float64) @ Q
    kfs, lms = st.kfs, st.lms
    R_new = np.einsum("kij,lj->kil", kfs.R.astype(np.float64), M)
    t_new = kfs.t.astype(np.float64) / scale
    rng = np.random.default_rng(seed + 7)
    v_est = np.zeros((cfg.rig.mono.max_kf, 3))
    b_est = np.zeros((cfg.rig.mono.max_kf, 6))
    for k in range(K):
        R_new[k], t_new[k], v_est[k], b_est[k] = perturb(
            rng, R_new[k], t_new[k], vw[k], k)
    valid = lms.valid
    f32 = np.float32
    state = st._replace(
        kfs=kfs._replace(R=R_new.astype(f32), t=t_new.astype(f32)),
        lms=lms._replace(
            pos=np.where(valid[:, None], lms.pos @ M.T / scale,
                         lms.pos).astype(f32),
            normal=np.where(valid[:, None], lms.normal @ M.T,
                            lms.normal).astype(f32),
            min_dist=np.where(valid, lms.min_dist / scale,
                              lms.min_dist).astype(f32),
            max_dist=np.where(valid, lms.max_dist / scale,
                              lms.max_dist).astype(f32)))
    max_kf = cfg.rig.mono.max_kf
    kf_prev = np.full(max_kf, -1, np.int32)
    kf_prev[1:K] = np.arange(K - 1)
    pre = _kf_preints(cfg, ts, gyr, acc, list(range(max(K - n_preint, 1), K)),
                      bias_lin)
    kf_preint = [pre.get(k) for k in range(max_kf)]
    kf_stamp = np.full(max_kf, np.nan)
    kf_stamp[:K] = _KF_DT * np.arange(K)
    R_true = np.einsum("kij,lj->kil", R_cw[:K], np.asarray(R_vw, np.float64))
    return ViMap(
        state=state, kf_vel=v_est.astype(f32), kf_bg=b_est[:, :3].astype(f32),
        kf_ba=b_est[:, 3:].astype(f32), kf_prev=kf_prev,
        kf_preint=kf_preint, kf_stamp=kf_stamp, kf_id=K - 1, map_first_kf=0,
        R_true=R_true.astype(f32), t_true=(t_cw[:K] / scale).astype(f32),
        v_true=vw[:K].astype(f32), bias_true=np.asarray(bias, f32),
        R_vw=np.asarray(R_vw, f32), scale=float(scale))


# euroc_vi_map's IMU bias and the estimates' offsets from it.
VI_MAP_BIAS = (0.001, -0.0015, 0.0005, 0.02, 0.01, -0.015)


def euroc_vi_map(cfg: ViConfig = EUROC_STEREO_INERTIAL, seed: int = 0,
                 n_live_kf: int = 200, view_points: int = 7000,
                 stereo: bool = True) -> ViMap:
    """A map at ``cfg``'s capacity for ``vi_keyframe_step`` (numpy in and
    out): :func:`euroc_mono_map`'s (``n_live_kf`` keyframes 0.25 s and 0.15
    m apart, its landmarks, observations and keypoints, with the stereo
    keypoints' u_r when ``stereo``) on a smooth path in the gravity-aligned
    world, chained 0 -> 1 -> ... -> K-1, the chain's last ``viba_window``
    keyframes carrying their preintegrations of 200 Hz samples of the true
    motion (with bias ``VI_MAP_BIAS``, at which they are linearized; the
    truth is what the integrator makes of the samples). The system's
    estimates: every keyframe pose is off by 0.3 mrad and 2 mm as in
    euroc_mono_map, its velocity and bias the truth; the newest
    ``viba_free`` keyframes' poses by 2 mrad and 2 cm more, their
    velocities by 0.05 m/s and their biases by 5e-4 rad/s and 1e-2 m/s^2.
    The new keyframe is ``kf_id`` = K - 1."""
    K = n_live_kf

    def centre0(t):                      # euroc_mono_map's path, k = 4 t
        return np.array([0.6 * t, 0.08 * np.sin(0.28 * t),
                         0.05 * np.sin(0.2 * t)])

    def rot0(t):
        return _rodrigues([0.02 * np.sin(0.16 * t), 0.03 * np.sin(0.12 * t),
                           0.01 * np.sin(0.2 * t)])

    bias = np.asarray(VI_MAP_BIAS)

    def perturb(rng, R, t, v, k):
        if k < K - cfg.viba_free:
            return R, t, v, bias
        R, t = _perturb(rng, R, t, 2e-3 / np.sqrt(3), 2e-2 / np.sqrt(3))
        return R, t, v + rng.normal(0, 0.05 / np.sqrt(3), 3), bias + (
            np.concatenate([rng.normal(0, 5e-4, 3), rng.normal(0, 1e-2, 3)]))

    return _vi_map(cfg, K, centre0, rot0, bias, cfg.viba_window, seed,
                   np.eye(3), 1.0, stereo, view_points, perturb, bias)


# euroc_vi_init's visual world: tilted away from gravity by these angles
# (deg, about x then y), and for the monocular case scaled down by this.
VI_INIT_TILT = (8.0, -5.0)
VI_INIT_SCALE = 2.0
VI_INIT_BIAS = (0.004, -0.003, 0.002, 0.0, 0.0, 0.0)


def euroc_vi_init(cfg: ViConfig = EUROC_STEREO_INERTIAL, case: str = "stereo",
                  seed: int = 0, n_live_kf: int = 12,
                  view_points: int = 7000) -> ViMap:
    """A chain for ``vi_initialize`` (numpy in and out): ``n_live_kf``
    keyframes 0.25 s apart (2.75 s at 12: over the 1 s and 2 s of chain
    that the stereo and mono systems wait for) on an excited path (about 1 m/s^2 and 0.1 rad/s
    of wobble, so that the accelerometer sees the scale), every keyframe
    with its preintegration (gyro bias ``VI_INIT_BIAS``), in a map world
    tilted by ``VI_INIT_TILT`` away from gravity. ``case`` = "stereo": the
    metric map with the keypoints' u_r; "mono": the map scaled down by
    ``VI_INIT_SCALE`` and no u_r. Velocities and biases are zero (the
    system's state before the init)."""
    if case not in ("stereo", "mono"):
        raise ValueError(f"case: 'stereo' or 'mono', got {case!r}")
    from scipy.spatial.transform import Rotation
    R_vw = Rotation.from_euler("xy", VI_INIT_TILT, degrees=True).as_matrix()

    def centre0(t):
        return np.array([0.6 * t + 0.25 * np.sin(2.3 * t),
                         0.2 * np.sin(1.9 * t + 0.5),
                         0.15 * np.sin(2.7 * t)])

    def rot0(t):
        return _rodrigues([0.08 * np.sin(1.5 * t), 0.1 * np.sin(1.1 * t),
                           0.06 * np.sin(1.7 * t)])

    def perturb(rng, R, t, v, k):
        return R, t, np.zeros(3), np.zeros(6)

    return _vi_map(cfg, n_live_kf, centre0, rot0, np.asarray(VI_INIT_BIAS),
                   n_live_kf, seed, R_vw,
                   1.0 if case == "stereo" else VI_INIT_SCALE,
                   case == "stereo", view_points, perturb, np.zeros(6))


# --- The inertial systems ---------------------------------------------------

VI_STEREO_FRAMES = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                    / "frames_vi_stereo.npz")
VI_MONO_FRAMES = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                  / "frames_vi_mono.npz")


class ViFrames(NamedTuple):
    """The inertial runs' input (``scripts/make_torch_vi_frames.py``):
    ``SynthWorld(motion="excited")`` rendered at 10 fps with its 200 Hz IMU
    samples, the noise drawn as the JAX package's tests draw it."""

    left: np.ndarray         # (F, 480, 640) uint8, the (left) frames
    right: np.ndarray | None  # (F, 480, 640) uint8; None for mono
    stamps: np.ndarray       # (F,) float64 s
    R: np.ndarray            # (F, 3, 3) true world->camera poses
    t: np.ndarray            # (F, 3)
    centres: np.ndarray      # (F, 3) float64 true camera centres
    vel: np.ndarray          # (F, 3) float64 true world velocities
    imu_t: np.ndarray        # (M,) float64 sample stamps
    imu_gyr: np.ndarray      # (M, 3) float32
    imu_acc: np.ndarray      # (M, 3) float32
    imu_start: np.ndarray    # (F + 1,) frame i's samples: [start[i], start[i+1])
    camera: np.ndarray       # fx, fy, cx, cy, width, height

    def imu(self, i: int):
        """Frame ``i``'s IMU batch (ts, gyr, acc) as ``track`` takes it,
        or None (the first frame)."""
        lo, hi = self.imu_start[i], self.imu_start[i + 1]
        if hi <= lo:
            return None
        return self.imu_t[lo:hi], self.imu_gyr[lo:hi], self.imu_acc[lo:hi]


def _vi_frames(path, mono: bool) -> ViFrames:
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    return ViFrames(left=d["frames"] if mono else d["left"],
                    right=None if mono else d["right"],
                    **{k: d[k] for k in ViFrames._fields[2:]})


def vi_stereo_frames(path=VI_STEREO_FRAMES) -> ViFrames:
    """tests/test_stereo_inertial.py's run: rectified pairs of
    ``SynthWorld(seed=11, motion="excited")`` (baseline 0.2 m) at t =
    0.0-3.9 s, IMU noise from ``default_rng(5)``."""
    return _vi_frames(path, mono=False)


def vi_mono_frames(path=VI_MONO_FRAMES) -> ViFrames:
    """tests/test_inertial_system.py's run: ``SynthWorld(seed=3,
    motion="excited")`` at t = 0.0-6.4 s, IMU noise from
    ``default_rng(7)``."""
    return _vi_frames(path, mono=True)


class ViSlamSetup(NamedTuple):
    """An inertial system's arguments: ``cls(config, imu, **viba,
    device=...)``."""

    config: object           # SlamConfig / StereoConfig
    imu: object              # ops.imu.ImuConfig
    viba: dict               # viba_window, viba_free, viba_landmarks, full_viba_kf


# The JAX package's inertial tests' VI-BA sizes (12 keyframes, 6 free, 1024
# landmark slots, a 32-keyframe full VI-BA).
VI_TEST_VIBA = dict(viba_window=12, viba_free=6, viba_landmarks=1024,
                    full_viba_kf=32)


def _identity_imu(imu=None):
    from .ops.imu import ImuConfig
    base = ImuConfig(T_bc=np.eye(4, dtype=np.float32)) if imu is None else imu
    return dataclasses.replace(base, T_bc=np.eye(4, dtype=np.float32))


def stereo_inertial_golden_config(**changes) -> ViSlamSetup:
    """tests/test_stereo_inertial.py's configuration: the world's 640x480
    pinhole (fx = fy = 400), bf = 0.2 x 400 = 80, ThDepth 35, 1024
    features, 48 keyframe / 4096 landmark slots, 8 observations, 10 fps,
    TrackedMapPoints(1); the IMU at ``ImuConfig``'s defaults with T_bc = I;
    VI-BA 12 / 6 / 1024 / 32. ``changes`` replace config fields."""
    return ViSlamSetup(stereo_golden_config(max_kf=48, **changes),
                       _identity_imu(), dict(VI_TEST_VIBA))


def mono_inertial_golden_config(**changes) -> ViSlamSetup:
    """tests/test_inertial_system.py's configuration: the world's pinhole,
    1536 features, 64 keyframe / 4096 landmark slots, 8 observations, 10
    fps, the 60-match init gate, TrackedMapPoints(1); the IMU at
    ``ImuConfig``'s defaults with T_bc = I; VI-BA 12 / 6 / 1024 / 32."""
    return ViSlamSetup(golden_slam_config(max_kf=64, **changes),
                       _identity_imu(), dict(VI_TEST_VIBA))


def euroc_vi_golden_config(**changes) -> ViSlamSetup:
    """The stereo VI frames padded to 752x480 (:func:`pad_frames`) at
    :data:`EUROC_STEREO_INERTIAL`'s capacity: 1200 features, 1024 keyframe
    / 65536 landmark slots, 12 observations, the system's windows, ThDepth
    60, the EuRoC IMU's noise and VI-BA 24 / 10 / 4096 / 64. Cut to the
    synthetic world: its pinhole (fx = fy = 400, cx = 320, cy = 240) and
    bf = 80, T_bc = I, 10 fps, TrackedMapPoints(1)."""
    from .pipeline.stereo_system import StereoConfig
    e, c = EUROC_MONO, EUROC_STEREO_INERTIAL
    m = c.rig.mono
    cfg = StereoConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0,
                       width=m.width, height=m.height,
                       n_features=m.n_features, max_kf=e.max_kf,
                       max_lm=e.max_lm, max_obs=e.max_obs, fps=10,
                       local_window=e.local_window, ba_window=e.ba_window,
                       ba_lm_window=e.ba_lm_window,
                       local_kf_window=e.n_local_kf,
                       local_lm_window=e.n_local_lm,
                       recent_kf_window=e.recent_kf, kf_ref_min_obs=1,
                       bf=80.0, th_depth=c.rig.th_depth)
    return ViSlamSetup(dataclasses.replace(cfg, **changes),
                       _identity_imu(c.imu),
                       dict(viba_window=c.viba_window,
                            viba_free=c.viba_free,
                            viba_landmarks=c.viba_landmarks,
                            full_viba_kf=c.full_viba_kf))


# The inertial runs' gates (tests/test_stereo_inertial.py:59-82,
# tests/test_inertial_system.py:55-127).
VI_STEREO_MIN_FRAMES = 35
VI_STEREO_ATE_GATE_M = 0.15
VI_SPEED_TOL_MPS = 0.3
VI_MONO_MIN_FRAMES = 50
VI_MONO_POST_S = 3.0
VI_MONO_SCALE_TOL = 0.25
VI_MONO_ATE_GATE_M = 0.30
VI_MONO_GRAVITY_DEG = 10.0
# The JAX package's systems on the same frames at the same settings
# (``scripts/vi_reference_jax.py stereo | mono`` on the CPU): the stereo
# ATE without scale alignment (40 frames), and the mono ATE after 3 s,
# Horn-scaled (56 frames, scale 1.0888, gravity 0.67 deg). The stereo
# runs' gate: under 1.5 x it + 0.002 m; the mono value is reported beside.
VI_STEREO_JAX_ATE_M = 0.006702072395316809
VI_STEREO_JAX_ATE_GATE_M = 1.5 * VI_STEREO_JAX_ATE_M + 0.002
VI_MONO_JAX_ATE_M = 0.014323114190358425


def vi_gates(kind: str, traj, t0: float, frames: ViFrames, v_est) -> dict:
    """The inertial tests' measures of a trajectory ``traj`` (the system's
    (stamp, R_cw, t_cw) list, stamps relative to ``t0``) against the
    fixture ``frames``; ``v_est`` the last body velocity. ``kind``
    "stereo": the camera-centre ATE without scale alignment; "mono": after
    ``VI_MONO_POST_S``, Horn-scaled, its scale and the gravity axis's
    angle, and over all frames the largest error and its p90. Both: the
    speed error at the last frame. Returns a dict; ``ok`` holds the gate
    (the JAX comparison is the caller's)."""
    from .utils import evaluate
    stamps = np.array([s for s, _, _ in traj], np.float64) + t0
    est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                  np.stack([t for _, _, t in traj])).astype(
                                      np.float64)
    idx = np.array([int(np.argmin(np.abs(frames.stamps - s)))
                    for s in stamps])
    gt = frames.centres[idx]
    v_gt = frames.vel[idx[-1]]
    out = {"frames": len(traj), "speed_err_mps": float(abs(
        np.linalg.norm(np.asarray(v_est, np.float64))
        - np.linalg.norm(v_gt)))}
    if kind == "stereo":
        _, _, _, ate = evaluate.horn_align(est, gt, with_scale=False)
        out["ate_m"] = float(ate)
        out["ok"] = bool(len(traj) >= VI_STEREO_MIN_FRAMES
                         and ate < VI_STEREO_ATE_GATE_M
                         and out["speed_err_mps"] < VI_SPEED_TOL_MPS)
        return out
    post = stamps >= VI_MONO_POST_S
    s, R, _, ate = evaluate.horn_align(est[post], gt[post], with_scale=True)
    s_all, R_all, t_all, _ = evaluate.horn_align(est, gt, with_scale=True)
    err = np.linalg.norm(s_all * est @ R_all.T + t_all - gt, axis=-1)
    p90 = float(np.quantile(err, 0.90))
    grav = float(np.degrees(np.arccos(np.clip(R[2, 2], -1, 1))))
    out.update(post_frames=int(post.sum()), scale=float(s), ate_m=float(ate),
               gravity_deg=grav, max_err_m=float(err.max()), p90_err_m=p90)
    out["ok"] = bool(len(traj) >= VI_MONO_MIN_FRAMES and post.sum() >= 20
                     and abs(s - 1.0) < VI_MONO_SCALE_TOL
                     and ate < VI_MONO_ATE_GATE_M
                     and grav < VI_MONO_GRAVITY_DEG
                     and err.max() < max(4.0 * p90, 0.15)
                     and out["speed_err_mps"] < VI_SPEED_TOL_MPS)
    return out


# --- Non-rectified (fisheye) stereo and the Kannala-Brandt camera -----------

class FisheyeRigConfig(NamedTuple):
    """A non-rectified stereo deployment (the port's own copy of its
    constants): the left camera's :class:`MonoConfig` (its pinhole
    intrinsics are the virtual pinhole the keypoints are rectified onto)
    with its Kannala-Brandt k0..k3 (``kb8``, or None for a pinhole), the
    right camera's intrinsics ``cam2``, Kannala-Brandt ``kb8_2`` and radtan
    ``dist2`` (None: the left camera's, as the JAX ``MonoSlam._extract``'s
    overrides fall back), the left -> right transform (x_r = R_rl x_l +
    t_rl), bf = baseline x fx and ThDepth."""

    mono: MonoConfig
    cam2: tuple
    kb8: tuple | None
    kb8_2: tuple | None
    dist2: tuple | None
    R_rl: np.ndarray         # (3, 3) float32
    t_rl: np.ndarray         # (3,) float32
    bf: float
    th_depth: float = 35.0

    @property
    def depth_threshold(self) -> float:
        """The close-point depth: bf / fx x ThDepth."""
        return self.bf / self.mono.fx * self.th_depth


# TUM-VI's 512x512 stereo-inertial rig as ``scripts/run_tumvi.py --stereo
# --no-vocabulary`` runs it (``configs/TUM-VI_512_stereo_inertial.yaml``):
# both cameras Kannala-Brandt; Stereo.Tlr (x_c1 = Tlr x_c2) inverted into
# R_rl = R^T, t_rl = -R^T t (run_tumvi.py:99-101); bf = |t_lr| x fx1
# (:107); ThDepth 35; 1000 features over 8 levels at 1.2, 20 fps; the IMU at
# 200 Hz with the yaml's noise, walk and T_b_c1; the runner's 1024 keyframe
# and 65536 landmark slots with 12 observations.
TUMVI_CAM1 = (190.97847715128717, 190.9733070521226, 254.93170605935475,
              256.8974428996504)
TUMVI_KB8_1 = (0.0034823894022493434, 0.0007150348452162257,
               -0.0020532361418706202, 0.00020293673591811182)
TUMVI_CAM2 = (190.44236969414825, 190.4344384721956, 252.59949716835982,
              254.91723064636983)
TUMVI_KB8_2 = (0.0034003170790442797, 0.001766278153469831,
               -0.00266312569781606, 0.0003299517423931039)
TUMVI_TLR = np.array(
    [[0.999999445773493, 0.000791687752817, 0.000694034010224,
      0.101063427414194],
     [-0.000823363992158, 0.998899461915674, 0.046895490788700,
      0.001946204678584],
     [-0.000656143613644, -0.046896036240590, 0.998899560146304,
      0.001015350132563]])
TUMVI_T_BC = np.array(
    [[-0.9995250378696743, 0.0075019185074052044, -0.02989013031643309,
      0.045574835649698026],
     [0.029615343885863205, -0.03439736061393144, -0.998969345370175,
      -0.071161801837997044],
     [-0.008522328211654736, -0.9993800792498829, 0.03415885127385616,
      -0.044681254117144367],
     [0.0, 0.0, 0.0, 1.0]], np.float32)


def _tumvi_512_stereo_inertial() -> ViConfig:
    from .ops.imu import ImuConfig
    R_lr, t_lr = TUMVI_TLR[:, :3], TUMVI_TLR[:, 3]
    rig = FisheyeRigConfig(
        mono=MonoConfig(width=512, height=512, fx=TUMVI_CAM1[0],
                        fy=TUMVI_CAM1[1], cx=TUMVI_CAM1[2], cy=TUMVI_CAM1[3],
                        dist=None, n_features=1000),
        cam2=TUMVI_CAM2, kb8=TUMVI_KB8_1, kb8_2=TUMVI_KB8_2, dist2=None,
        R_rl=R_lr.T.astype(np.float32),
        t_rl=(-R_lr.T @ t_lr).astype(np.float32),
        bf=float(np.linalg.norm(t_lr) * TUMVI_CAM1[0]), th_depth=35.0)
    return ViConfig(rig=rig, imu=ImuConfig(
        T_bc=TUMVI_T_BC, gyro_noise=0.00016, acc_noise=0.0028,
        gyro_walk=0.000022, acc_walk=0.00086, freq=200.0))


TUMVI_512_STEREO_INERTIAL = _tumvi_512_stereo_inertial()


def fisheye_rig_config(cfg) -> FisheyeRigConfig:
    """The :class:`FisheyeRigConfig` of a
    ``pipeline.stereo_system.FisheyeStereoConfig``."""
    tup = lambda a: None if a is None else tuple(
        float(x) for x in np.asarray(a).reshape(-1))
    return FisheyeRigConfig(
        mono=mono_slam_config(cfg), cam2=tup(cfg.cam2), kb8=tup(cfg.kb8),
        kb8_2=tup(cfg.kb8_2), dist2=tup(cfg.dist2),
        R_rl=np.asarray(cfg.R_rl, np.float32),
        t_rl=np.asarray(cfg.t_rl, np.float32), bf=float(cfg.bf),
        th_depth=float(cfg.th_depth))


class FisheyeRigTensors(NamedTuple):
    """A :class:`FisheyeRigConfig`'s constants as tensors on one device,
    the right camera's overrides resolved."""

    cam_l: torch.Tensor      # (4,)
    kb8_l: torch.Tensor | None
    dist_l: torch.Tensor | None
    cam_r: torch.Tensor      # (4,)
    kb8_r: torch.Tensor | None
    dist_r: torch.Tensor | None
    R_rl: torch.Tensor       # (3, 3)
    t_rl: torch.Tensor       # (3,)


def fisheye_rig_tensors(rig: FisheyeRigConfig, device) -> FisheyeRigTensors:
    """Upload ``rig``'s constants (float32) to ``device`` once; the right
    camera's Kannala-Brandt and radtan coefficients fall back to the left
    camera's where the rig gives none (the JAX ``MonoSlam._extract``'s
    overrides)."""
    from . import device as device_mod

    def up(x):
        return (None if x is None else device_mod.upload(
            np.asarray(x, np.float32), device))

    m = rig.mono
    kb8_r = rig.kb8 if rig.kb8_2 is None else rig.kb8_2
    dist_r = m.dist if rig.dist2 is None else rig.dist2
    return FisheyeRigTensors(
        cam_l=up([m.fx, m.fy, m.cx, m.cy]), kb8_l=up(rig.kb8),
        dist_l=None if m.dist is None else up(np.asarray(m.dist)[:4]),
        cam_r=up(rig.cam2), kb8_r=up(kb8_r),
        dist_r=None if dist_r is None else up(np.asarray(dist_r)[:4]),
        R_rl=up(rig.R_rl), t_rl=up(rig.t_rl))


def fisheye_stereo_extract(img_l, img_r, rig: FisheyeRigConfig,
                           tensors: FisheyeRigTensors | None = None,
                           stage=_no_stage):
    """``FisheyeStereoSlam``'s extraction: the ORB features of each image
    (K1 once each), each camera's keypoints rectified onto its virtual
    pinhole, then ``stereo.fisheye_stereo_match`` (K2's none mode over
    both frames' descriptors, the DLT and its gates). img_l / img_r: (H, W)
    float32 raw images. ``tensors``: :func:`fisheye_rig_tensors` of
    ``rig`` on the images' device (made here when None); ``stage``: as
    :func:`stereo_extract`'s. Returns (left features, right features,
    FisheyeStereoResult)."""
    from .ops import stereo
    t = tensors or fisheye_rig_tensors(rig, img_l.device)
    with stage("orb_extract"):
        f_l = mono_extract(img_l, t.cam_l, t.dist_l, rig.mono, kb8=t.kb8_l)
        f_r = mono_extract(img_r, t.cam_r, t.dist_r, rig.mono, kb8=t.kb8_r)
    with stage("stereo_match"):
        m = stereo.fisheye_stereo_match(
            f_l.xy, f_l.level, f_l.desc, f_l.valid, f_r.xy, f_r.level,
            f_r.desc, f_r.valid, t.cam_l, t.cam_r, t.R_rl, t.t_rl)
    return f_l, f_r, m


def _kb8_unproject_np(params, uv, iters: int = 10) -> np.ndarray:
    """``camera.kb8_unproject`` in float64 numpy: (..., 2) -> (..., 3)."""
    fx, fy, cx, cy, k0, k1, k2, k3 = np.asarray(params, np.float64)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = np.sqrt(mx * mx + my * my)
    theta = np.minimum(r_d, np.pi / 2.0)
    r_c = theta.copy()
    for _ in range(iters):
        th2 = theta * theta
        f = theta * (1 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3)))) - r_c
        fp = 1 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2
                                                        + th2 * 9 * k3)))
        theta = theta - f / fp
    scale = np.where(r_d < 1e-12, 1.0, np.tan(theta) / np.maximum(r_d, 1e-12))
    return np.stack([mx * scale, my * scale, np.ones_like(mx)], -1)


def kb8_warp(img: np.ndarray, pinhole, kb8_params, out_hw,
             background: int = 30) -> np.ndarray:
    """A pinhole render seen through a Kannala-Brandt camera of the same
    orientation (numpy only): each output pixel's ray (a float64 KB8
    unprojection with ``kb8_params`` = [fx, fy, cx, cy, k0..k3]) projected
    into ``img`` through ``pinhole`` = [fx, fy, cx, cy], bilinearly
    sampled; ``background`` where the ray leaves the render. Returns
    (out_h, out_w) uint8 (rounded)."""
    h_out, w_out = out_hw
    v, u = np.mgrid[0:h_out, 0:w_out].astype(np.float64)
    ray = _kb8_unproject_np(kb8_params, np.stack([u, v], -1))
    fx, fy, cx, cy = np.asarray(pinhole, np.float64)
    x = fx * ray[..., 0] + cx
    y = fy * ray[..., 1] + cy
    h, w = img.shape
    x0, y0 = np.floor(x), np.floor(y)
    inside = (x0 >= 0) & (y0 >= 0) & (x0 <= w - 2) & (y0 <= h - 2)
    xi = np.clip(x0, 0, w - 2).astype(np.int64)
    yi = np.clip(y0, 0, h - 2).astype(np.int64)
    ax, ay = x - x0, y - y0
    src = np.asarray(img, np.float64)
    val = ((1 - ay) * ((1 - ax) * src[yi, xi] + ax * src[yi, xi + 1])
           + ay * ((1 - ax) * src[yi + 1, xi] + ax * src[yi + 1, xi + 1]))
    out = np.where(inside, val, float(background))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


FISHEYE_FRAMES = (Path(__file__).resolve().parents[1] / "tests" / "golden"
                  / "frames_fisheye.npz")


class FisheyeFrames(NamedTuple):
    """The non-rectified stereo run's input
    (``scripts/make_torch_fisheye_frames.py``): ``SynthWorld(seed=13)``
    rendered by a left pinhole camera and a right one 0.2 m along its x
    axis and yawed 3 degrees, at t = 0.0, 0.1, ..., 2.9 s; and the depth
    image of the stereo-inertial fixture's first left frame."""

    left: np.ndarray         # (30, 480, 640) uint8
    right: np.ndarray        # (30, 480, 640) uint8
    stamps: np.ndarray       # (30,) float64 s
    R: np.ndarray            # (30, 3, 3) true world->left-camera poses
    t: np.ndarray            # (30, 3)
    centres: np.ndarray      # (30, 3) float64 true left camera centres
    camera: np.ndarray       # fx, fy, cx, cy, width, height
    R_rl: np.ndarray         # (3, 3) float32 left -> right camera
    t_rl: np.ndarray         # (3,) float32
    vi_depth0: np.ndarray    # (480, 640) uint16, z x depth_factor
    depth_factor: float


def fisheye_frames(path=FISHEYE_FRAMES) -> FisheyeFrames:
    """Load the fisheye frames fixture."""
    with np.load(path) as z:
        return FisheyeFrames(**{k: (z[k] if z[k].ndim else float(z[k]))
                                for k in FisheyeFrames._fields})


# The non-rectified stereo run's gate (tests/test_fisheye_stereo_system.py):
# more than 20 frames associated, the ATE without scale alignment under
# 0.15 m, and the path length within 8 % of the truth.
FISHEYE_MIN_FRAMES = 20
FISHEYE_ATE_GATE_M = 0.15
FISHEYE_PATH_TOL = 0.08
# The JAX package's FisheyeStereoSlam on the same frames at the same
# settings (``scripts/fisheye_reference_jax.py stereo`` on the CPU): 29
# frames, the ATE without scale alignment. The port's runs are also held
# under 1.5 x it + 0.002 m.
FISHEYE_JAX_ATE_M = 0.016867899653505894
FISHEYE_JAX_ATE_GATE_M = 1.5 * FISHEYE_JAX_ATE_M + 0.002


def fisheye_gates(traj, t0: float, frames: FisheyeFrames) -> dict:
    """tests/test_fisheye_stereo_system.py's measures of a trajectory
    ``traj`` (the system's (stamp, R_cw, t_cw) list, stamps relative to
    ``t0``) against the fixture ``frames``: the frames, the camera-centre
    ATE without scale alignment (each frame against the nearest true
    stamp), the path length's relative error. ``ok`` holds the test's gate
    (the JAX comparison is the caller's)."""
    from .utils import evaluate
    stamps = np.array([s for s, _, _ in traj], np.float64) + t0
    est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                  np.stack([t for _, _, t in traj])).astype(
                                      np.float64)
    idx = np.array([int(np.argmin(np.abs(frames.stamps - s)))
                    for s in stamps])
    gt = frames.centres[idx]
    _, _, _, ate = evaluate.horn_align(est, gt, with_scale=False)
    length = float(np.linalg.norm(np.diff(est, axis=0), axis=-1).sum())
    true_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
    out = {"frames": len(traj), "ate_m": float(ate), "path_m": length,
           "true_path_m": true_len,
           "path_err": abs(length - true_len) / true_len}
    out["ok"] = bool(len(traj) > FISHEYE_MIN_FRAMES
                     and ate < FISHEYE_ATE_GATE_M
                     and out["path_err"] < FISHEYE_PATH_TOL)
    return out


def fisheye_stereo_golden_config(frames: FisheyeFrames | None = None,
                                 **changes):
    """``tests/test_fisheye_stereo_system.py``'s configuration: the world's
    640x480 pinhole on both cameras (no fisheye model: the rig is
    non-rectified, not distorted), the fixture's R_rl / t_rl, bf = 0.2 x
    400 = 80, ThDepth 35, 1024 features, 32 keyframe / 4096 landmark slots,
    8 observations, 10 fps, TrackedMapPoints(1), the one-frame init's gates
    lowered to 60 depth points and 40 landmarks. ``changes`` replace
    fields."""
    from .pipeline.stereo_system import FisheyeStereoConfig
    g = frames if frames is not None else fisheye_frames()
    fx, fy, cx, cy, w, h = (float(x) for x in g.camera)
    cfg = FisheyeStereoConfig(
        kf_ref_min_obs=1, fx=fx, fy=fy, cx=cx, cy=cy, width=int(w),
        height=int(h), n_features=1024, max_kf=32, max_lm=4096, max_obs=8,
        fps=10, cam2=np.array([fx, fy, cx, cy], np.float32),
        R_rl=g.R_rl, t_rl=g.t_rl, bf=0.2 * fx, th_depth=35.0,
        min_init_depth_points=60, min_init_landmarks=40)
    return dataclasses.replace(cfg, **changes)


# The TUM-VI-sized cells' cameras: the world's focal length (fx = fy = 400)
# on TUM-VI's 512x512 image and Kannala-Brandt coefficients, centred.
TUMVI_WORLD_CAM = (400.0, 400.0, 255.5, 255.5)
# The JAX package's FisheyeStereoInertialSlam on the warped frames
# (``scripts/fisheye_reference_jax.py vi`` on the CPU: the cell's cameras,
# rig and 1000 features with the map cut to 48 / 4096 / 8 slots and VI-BA
# 12 / 6 / 1024 / 32): 40 frames, the ATE without scale alignment. The
# port's (h) runs are held under 1.5 x it + 0.002 m.
TUMVI_VI_JAX_ATE_M = 0.02481336387907233
TUMVI_VI_JAX_ATE_GATE_M = 1.5 * TUMVI_VI_JAX_ATE_M + 0.002
# That run's map and VI-BA sizes: the CPU runs of cell (h) use them.
TUMVI_VI_CPU_SLOTS = dict(max_kf=48, max_lm=4096, max_obs=8)
TUMVI_VI_CPU_VIBA = dict(viba_window=12, viba_free=6, viba_landmarks=1024,
                         full_viba_kf=32)


def tumvi_kb8_pair(left: np.ndarray, right: np.ndarray,
                   camera=(400.0, 400.0, 320.0, 240.0)):
    """A rectified pinhole pair (``camera``'s intrinsics) seen through the
    TUM-VI 512 rig's two Kannala-Brandt cameras at
    :data:`TUMVI_WORLD_CAM` (:func:`kb8_warp`, background 30). Returns
    (left, right) (512, 512) uint8."""
    size = (TUMVI_512_STEREO_INERTIAL.rig.mono.height,
            TUMVI_512_STEREO_INERTIAL.rig.mono.width)
    return (kb8_warp(left, camera, TUMVI_WORLD_CAM + TUMVI_KB8_1, size),
            kb8_warp(right, camera, TUMVI_WORLD_CAM + TUMVI_KB8_2, size))


def tumvi_vi_frames(frames: ViFrames | None = None) -> ViFrames:
    """The stereo-inertial fixture (:func:`vi_stereo_frames`) with both
    cameras' frames warped to TUM-VI's 512x512 Kannala-Brandt pair
    (:func:`tumvi_kb8_pair`); the IMU and the truth unchanged."""
    g = frames if frames is not None else vi_stereo_frames()
    cam = tuple(float(x) for x in g.camera[:4])
    pairs = [tumvi_kb8_pair(l_, r_, cam) for l_, r_ in zip(g.left, g.right)]
    return g._replace(left=np.stack([p[0] for p in pairs]),
                      right=np.stack([p[1] for p in pairs]))


def tumvi_vi_golden_config(**changes) -> ViSlamSetup:
    """The stereo VI frames warped to TUM-VI's 512x512 Kannala-Brandt pair
    (:func:`tumvi_vi_frames`) at :data:`TUMVI_512_STEREO_INERTIAL`'s
    capacity: 1000 features, 1024 keyframe / 65536 landmark slots, 12
    observations, the system's windows, ThDepth 35, VI-BA 24 / 10 / 4096 /
    64. Cut to the synthetic world: its focal length on both cameras (fx =
    fy = 400, cx = cy = 255.5, TUM-VI's KB8 coefficients), its untilted
    rig (R_rl = I, t_rl = (-0.2, 0, 0), bf = 80) for TUM-VI's Tlr, the
    fixture's IMU (``ImuConfig``'s defaults, T_bc = I), 10 fps,
    TrackedMapPoints(1), and the one-frame init's gates at the JAX fisheye
    test's 60 depth points and 40 landmarks (the fisheye match keeps about
    110 of the world's 1000 keypoints; at the defaults, 300 and 100, no
    frame initialises). ``changes`` replace config fields."""
    from .pipeline.stereo_system import FisheyeStereoConfig
    e, c = EUROC_MONO, TUMVI_512_STEREO_INERTIAL
    m = c.rig.mono
    fx, fy, cx, cy = TUMVI_WORLD_CAM
    cfg = FisheyeStereoConfig(
        fx=fx, fy=fy, cx=cx, cy=cy, width=m.width, height=m.height,
        kb8=np.array(TUMVI_KB8_1, np.float32), n_features=m.n_features,
        max_kf=m.max_kf, max_lm=m.max_lm, max_obs=m.max_obs, fps=10,
        local_window=e.local_window, ba_window=e.ba_window,
        ba_lm_window=e.ba_lm_window, local_kf_window=e.n_local_kf,
        local_lm_window=e.n_local_lm, recent_kf_window=e.recent_kf,
        kf_ref_min_obs=1, bf=0.2 * fx, th_depth=c.rig.th_depth,
        min_init_depth_points=60, min_init_landmarks=40,
        cam2=np.array(TUMVI_WORLD_CAM, np.float32),
        kb8_2=np.array(TUMVI_KB8_2, np.float32),
        R_rl=np.eye(3, dtype=np.float32),
        t_rl=np.array([-0.2, 0.0, 0.0], np.float32))
    return ViSlamSetup(dataclasses.replace(cfg, **changes), _identity_imu(),
                       dict(viba_window=c.viba_window, viba_free=c.viba_free,
                            viba_landmarks=c.viba_landmarks,
                            full_viba_kf=c.full_viba_kf))


# --- Place recognition and relocalisation -----------------------------------

VOCABULARY_DIR = Path(__file__).resolve().parents[1] / "vocabulary"
# The runners' default vocabulary (``scripts/run_euroc_mono.py``'s
# ``--vocabulary``: 9,999 words, k = 10, depth 4) and the deployment-width
# one (92,613 words, k = 10, depth 5).
RELOC_VOCABULARY = VOCABULARY_DIR / "synthetic_voc_10k.npz"
DEPLOY_VOCABULARY = VOCABULARY_DIR / "real_voc_100k.npz"

# The relocalisation cells (``tests/test_reloc_localization.py``'s runs at
# the EuRoC-mono capacity): golden frames 0-24 (the test's tracked span,
# t = 0.0-2.4 s), then ``noise`` frames of uniform 0-30 noise (numpy seed
# 5) within or past the RECENTLY_LOST budget ``grace``, then the revisit
# frames, then two more frames that tracking must keep. Cell "i"
# relocalises in the active map; cell "j" loses the map (a new one is
# spawned) and must switch back into it. (After frames 0-19 alone the JAX
# system takes revisit frame 10 back through the reference-keyframe
# fallback, 0.9 s from its last frame, and never relocalises.)
RELOC_TRACKED = 25
RELOC_CELLS = {
    "i": dict(noise=4, grace=30, revisit=tuple(range(10, 15)),
              after=(15, 16)),
    "j": dict(noise=6, grace=2, revisit=tuple(range(10, 16)),
              after=(16, 17)),
}
RELOC_NOISE_SEED = 5


class RelocFrame(NamedTuple):
    """One frame of a relocalisation cell: the (480, 752) image, its stamp
    (s) and the golden frame it shows (-1 for noise)."""

    image: np.ndarray
    stamp: float
    world: int


def reloc_sequence(cell: str, frames: GoldenFrames | None = None) -> list:
    """The frames of relocalisation cell ``cell`` ("i" or "j", see
    :data:`RELOC_CELLS`): the golden frames padded to EuRoC's 752 columns
    (:func:`pad_frames`), stamps 0.1 s apart throughout (the blackout and
    the revisit continue the clock). Returns a list of
    :class:`RelocFrame`."""
    c = RELOC_CELLS[cell]
    g = frames if frames is not None else golden_frames()
    padded = pad_frames(g.frames)
    h, w = padded.shape[1:]
    rng = np.random.default_rng(RELOC_NOISE_SEED)
    world = (list(range(RELOC_TRACKED)) + [-1] * c["noise"]
             + list(c["revisit"]) + list(c["after"]))
    out = []
    for i, k in enumerate(world):
        img = (rng.uniform(0, 30, (h, w)).astype(np.float32) if k < 0
               else padded[k])
        out.append(RelocFrame(img, round(0.1 * i, 6), k))
    return out


def reloc_golden_config(cell: str, vocabulary=None, **changes):
    """:func:`euroc_golden_config` with ``vocabulary``, loop closing off
    and the cell's RECENTLY_LOST budget (``tests/test_reloc_localization.py``:
    30 frames for "i", 2 for "j")."""
    return euroc_golden_config(vocabulary=vocabulary, use_loop_closing=False,
                               lost_grace_frames=RELOC_CELLS[cell]["grace"],
                               **changes)


# The JAX reference run's map slots (``scripts/reloc_reference_jax.py``):
# the JAX init's one-hot Schur assembly at 1024 x 65536 slots takes about
# 21 GiB, so the CPU run cuts the map to 48 keyframe and 8192 landmark
# slots (the windows, 12 observations and everything else as the cell).
RELOC_CPU_SLOTS = dict(max_kf=48, max_lm=8192)


def reloc_gates(traj, t0: float, seq: list, reloc_stamp: float,
                frames: GoldenFrames | None = None) -> dict:
    """A relocalisation cell's pose measures from a trajectory (``(stamp,
    R_cw, t_cw)`` records, absolute stamps): the frames before the blackout
    are aligned to the golden truth by Horn's method with scale; the frame
    at ``reloc_stamp`` is mapped through that alignment and held to its
    true camera centre. Returns ``reloc_err_m``, ``pre_ate_m``, ``scale``
    and ``n_pre``."""
    from .utils import evaluate
    g = frames if frames is not None else golden_frames()
    world = {round(f.stamp, 6): f.world for f in seq}
    lost_at = min(f.stamp for f in seq if f.world < 0)
    est, true, hit = [], [], None
    for s, R, t in traj:
        s = round(float(s) - t0, 6)
        k = world.get(s, -1)
        if k < 0:
            continue
        c = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
        if s < lost_at:
            est.append(c)
            true.append(g.centres[k])
        elif abs(s - reloc_stamp) < 1e-6:
            hit = (c, g.centres[k])
    scale, R_a, t_a, ate = evaluate.horn_align(np.stack(est), np.stack(true))
    err = (float("inf") if hit is None else
           float(np.linalg.norm(scale * R_a @ hit[0] + t_a - hit[1])))
    return dict(reloc_err_m=err, pre_ate_m=float(ate), scale=float(scale),
                n_pre=len(est))


class RelocResult(NamedTuple):
    """``relocalize``'s result. On failure ``track`` is None, ``cand`` -1
    and ``R``, ``t`` None."""

    success: bool
    track: object            # tracking.TrackResult of the passing candidate
    cand: int                # its keyframe slot
    R: object                # (3, 3) its pose, numpy
    t: object
    info: dict


def relocalize(state, db, feats, cam_params, *, draw,
               cfg: MonoConfig = EUROC_MONO,
               min_inliers: int = 30) -> RelocResult:
    """The device half of ``MonoSlam._relocalize_in_map`` for one map
    (Tracking::Relocalization): the keyframe database's top 3
    covisibility groups (``db.query_groups``); for each candidate in turn,
    K2's none-mode match of the landmarks it sees against the frame's
    keypoints (ratio 0.75, ``TH_LOW``), the RANSAC PnP over one row per
    matched keypoint (``pnp.pnp_ransac``; its refine is a K3 launch), the
    candidate keyframe's pose instead when the PnP keeps fewer than 10
    inliers, and ``tracking.track_local_map`` (K2's window mode over every
    landmark slot, K3) from there. The first candidate whose track keeps
    ``min_inliers`` wins.

    ``feats``: the frame's features; ``db``: the map's
    ``keyframe_db.KeyframeDatabase``. The PnP's (128, 6) sample rows are
    ``draw(corr, kp_lm)`` of the (N,) correspondence mask and keypoint ->
    landmark table (``MonoSlam._pnp_indices`` draws them from the
    system's generator by ``pnp.draw_indices``). The host reads the
    database's candidates once and each tried candidate once (its PnP's
    ``ok`` and inliers, the track's inliers and pose: the four reads the
    JAX system makes, packed); ``info`` names them (``host_reads``) and
    holds ``candidates``, ``scores``, ``tried`` (per candidate: its PnP's
    ``ok`` and inliers, the track's inliers) and ``idx`` (the passing
    candidate's samples)."""
    dev = feats.xy.device
    info = {"host_reads": ["candidates"], "tried": []}
    ids, scores, _ = db.query_groups(
        feats.desc, feats.valid, ms.covisibility_matrix(state), top_n=3,
        kf_valid=state.kfs.valid)
    info["candidates"], info["scores"] = ids, scores
    lms, kfs = state.lms, state.kfs
    n_feat, n_lm = feats.xy.shape[0], lms.pos.shape[0]
    inv_s2 = tracking._inv_sigma2_on(dev)[feats.level.long()]
    no_bind = torch.full((n_feat,), -1, dtype=torch.int32, device=dev)
    lm_ids = torch.arange(n_lm, dtype=torch.int32, device=dev)
    for cand in ids.tolist():
        if cand < 0:
            continue
        seen, _ = ms.landmarks_seen_by(state, cand)
        mj, _ = matching.match(lms.desc, feats.desc, seen, feats.valid,
                               max_dist=matching.TH_LOW, ratio=0.75)
        # Each keypoint's landmark (the match is mutual: one at most).
        kp_lm = ms.scatter_rows(no_bind, torch.where(mj >= 0, mj, n_feat),
                                torch.where(mj >= 0, lm_ids, -1))
        corr = kp_lm >= 0
        idx = draw(corr, kp_lm)
        pr = pnp.pnp_ransac(idx, lms.pos[kp_lm.clamp_min(0).long()],
                            feats.xy, inv_s2, corr, cam_params)
        use = pr.ok & (pr.n_inliers >= 10)
        R0 = torch.where(use, pr.R, kfs.R[cand])
        t0 = torch.where(use, pr.t, kfs.t[cand])
        res = tracking.track_local_map(
            R0, t0, no_bind, lms.pos, lms.desc, lms.normal, lms.min_dist,
            lms.max_dist, lms.valid, feats.xy, feats.level, feats.desc,
            feats.valid, cam_params, cfg.width, cfg.height)
        ok, n_pnp, n_in, R, t = device_mod.read(pr.ok, pr.n_inliers,
                                                res.n_inliers, res.R, res.t)
        info["host_reads"].append(f"candidate {cand}")
        info["tried"].append(dict(cand=cand, pnp_ok=bool(ok),
                                  pnp_inliers=int(n_pnp), inliers=int(n_in)))
        if int(n_in) >= min_inliers:
            info["idx"] = idx
            return RelocResult(True, res, cand, R, t, info)
    return RelocResult(False, None, -1, None, None, info)


# The JAX MonoSlam's runs of the two cells (``scripts/reloc_reference_jax.py
# i | j`` on the CPU, ``synthetic_voc_10k.npz``, the map cut to
# :data:`RELOC_CPU_SLOTS`): the frame of the sequence that relocalised
# (both: the second revisit frame, golden frame 11, from keyframe 10's
# group with 355 inliers), the map it landed in and its camera centre's
# error after the run's Horn alignment (:func:`reloc_gates`). The port's
# runs must relocalise within one frame of it, into that map, within
# :data:`RELOC_CENTRE_GATE_M` of the truth.
RELOC_JAX = {
    "i": dict(index=30, world=11, map=0, n_maps=1, cand=10, inliers=355,
              reloc_err_m=0.01842918070069971),
    "j": dict(index=32, world=11, map=0, n_maps=2, cand=10, inliers=355,
              reloc_err_m=0.007066997025886848),
}
RELOC_CENTRE_GATE_M = 0.05


def reloc_run_gates(cell: str, statuses, maps, n_maps: int, n_kf_before: int,
                    n_kf_after: int, traj, t0: float, seq: list,
                    frames: GoldenFrames | None = None) -> dict:
    """A relocalisation cell's gates on a run of :func:`reloc_sequence`:
    ``statuses`` and ``maps`` (the active map) after each frame, the
    atlas's map count at the end, the keyframe count before the blackout
    and at the end, and the trajectory. The system must be RECENTLY_LOST
    (cell "i") or have spawned a new map (cell "j") in the blackout,
    relocalise within one frame of the JAX run's frame into its map, keep
    tracking (status OK) on every later frame, with the old map's
    keyframes live (cell "j"), and the relocalised camera centre within
    :data:`RELOC_CENTRE_GATE_M` of the truth. Returns the measures and
    ``ok``."""
    ref = RELOC_JAX[cell]
    revisit = RELOC_TRACKED + RELOC_CELLS[cell]["noise"]
    blackout = statuses[RELOC_TRACKED:revisit]
    hit = next((i for i in range(revisit, len(seq))
                if statuses[i] == 1 and statuses[i - 1] != 1), None)
    out = dict(reloc_index=hit, jax_index=ref["index"], n_maps=n_maps,
               n_kf_before=n_kf_before, n_kf_after=n_kf_after)
    if hit is None:
        return dict(out, ok=False)
    out.update(reloc_world=seq[hit].world, reloc_map=int(maps[hit]),
               **reloc_gates(traj, t0, seq, seq[hit].stamp, frames))
    lost = (2 in blackout if cell == "i" else 0 in blackout)
    out["ok"] = bool(
        lost and abs(hit - ref["index"]) <= 1
        and out["reloc_map"] == ref["map"]
        and all(s == 1 for s in statuses[hit:]) and n_maps == ref["n_maps"]
        and (cell == "i" or n_kf_after >= n_kf_before)
        and out["reloc_err_m"] < RELOC_CENTRE_GATE_M)
    return out


# --- Loop closing -----------------------------------------------------------

def loop_closing_step(state, lc, kf_id: int, n_kf: int, cam_params, *,
                      kf_parent=None, cfg: MonoConfig = EUROC_MONO,
                      gba: str = "inline", bg=None, ba_kwargs=None,
                      mesh=None, stage=_no_stage):
    """The device half of ``MonoSlam._run_loop_closing`` for keyframe
    ``kf_id`` (LoopClosing): ``lc.detect`` (the database's candidates,
    each candidate's verification ladder: K2 twice in window mode over
    every landmark slot, the Sim3 RANSAC and OptimizeSim3, the temporal
    streak); when it fires, ``lc.close`` (the essential-graph pose graph
    over the live prefix, the landmark correction), ``fuse_duplicates``
    (K2's window mode) and the global BA: ``gba`` "inline"
    (``mapping.global_ba``), "background" (``bg.start``, a
    ``BackgroundGBA``, to be ticked by the caller) or "none".

    ``lc``: a ``LoopCloser`` holding the map's database; ``kf_parent``:
    the spanning tree (host numpy, -1 = root; the temporal chain without
    one); ``ba_kwargs``: the stereo rows' ``use_stereo`` and ``bf``;
    ``mesh``: the inline GBA's device mesh (``parallel.dist_ba``);
    ``stage(name)``: the caller's stage timer ("loop_detect",
    "loop_correct", "global_ba"). Returns (state, info): ``info`` holds the query, the candidates, each
    tried candidate's stage counts (``tried``), the streak's count,
    ``fired``, and when it fired the candidate (``cand``) and the Sim3
    (``sim3``: R, t, s, n; query world -> candidate world), and the host
    reads by name (``host_reads``)."""
    kw = dict(ba_kwargs or {})
    with stage("loop_detect"):
        det = lc.detect(state, kf_id, n_kf)
    info = dict(lc.info)
    info["host_reads"] = list(info["host_reads"])
    info.setdefault("fired", False)
    if det is None:
        return state, info
    cand, corr = det
    info.update(fired=True, cand=int(cand), sim3=corr)
    with stage("loop_correct"):
        state = lc.close(state, kf_id, cand, corr, n_kf,
                         span_parent=kf_parent)
        info["host_reads"].append("close: covisibility and liveness")
        # SearchAndFuse (LoopClosing.cc:2689): the drifted duplicates merge
        # into their loop-side originals.
        state = mapping.fuse_duplicates(state, kf_id, cam_params,
                                        float(cfg.width), float(cfg.height))
    if gba == "inline":
        with stage("global_ba"):
            state = mapping.global_ba(state, cam_params, mesh=mesh, **kw)
    elif gba == "background":
        bg.start(state, n_kf, cam_params,
                 use_stereo=bool(kw.get("use_stereo")),
                 bf=float(kw.get("bf", 0.0)))
        info["host_reads"].append("background GBA start: liveness")
    elif gba != "none":
        raise ValueError(f"gba: 'inline', 'background' or 'none', got {gba!r}")
    return state, info


class LoopMap(NamedTuple):
    """:func:`euroc_loop_map`'s map (numpy leaves, the JAX package's
    dtypes) and truth."""

    state: ms.MapState
    n_kf: int                 # live keyframes, slots [0, n_kf)
    revisit: tuple            # the revisit keyframes' slots
    revisit_of: tuple         # the keyframe each re-observes
    c_true: np.ndarray        # (n_kf, 3) true camera centres
    scales: np.ndarray        # (n_kf,) the scale creep at each keyframe
    cam_params: np.ndarray    # (4,) float32
    kf_parent: np.ndarray     # (max_kf,) the spanning tree (a chain)


def loop_expected_scale(m: LoopMap, i: int) -> float:
    """The Sim3 scale that undoes the creep between revisit ``i`` and the
    keyframe it re-observes."""
    return float(m.scales[m.revisit_of[i]] / m.scales[m.revisit[i]])


def euroc_loop_map(cfg: MonoConfig = EUROC_MONO, n_kf: int = 160,
                   n_pts: int = 300, n_revisit: int = 3,
                   creep: float = 1.25, radius: float = 4.0,
                   seed: int = 0) -> LoopMap:
    """A drifted circuit at ``cfg``'s capacity that closes a loop: the JAX
    test's ``build_circular_map`` (``tests/test_loop_closing.py``) at the
    EuRoC-mono slots (1024 keyframes, 65,536 landmarks, 12 observations,
    1200 keypoints) and camera (its pinhole; the keypoints are undistorted
    pixels).

    ``n_kf`` keyframes on a circle of ``radius`` m, each looking at the
    circle's middle, see a patch of ``n_pts`` points of their own (3-6 m
    deep); consecutive keyframes share landmarks: keyframe k + 1 observes
    patch k at keypoints ``n_pts .. 2 n_pts - 1`` (the last patch is
    observed back by keyframe ``n_kf - 2`` at ``2 n_pts ..``). Keypoints
    are the true projections with 0.3 px of noise, the rest of the 1200
    random. A scale creep compounds along the circuit to ``creep`` at the
    last keyframe: keyframe k's centre and its patch sit at ``scale_k``
    times the truth. The last ``n_revisit`` keyframes sit one step behind
    keyframes 0, 1, ... and re-observe their physical points, with the
    same descriptors, as fresh landmarks at the drifted scale: the loop.
    About 48,000 live landmarks at the defaults."""
    rng = np.random.default_rng(seed)
    K, nf, O, L = cfg.max_kf, cfg.n_features, cfg.max_obs, cfg.max_lm
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    W, H = cfg.width, cfg.height
    if (n_kf + 1 > K or n_kf * n_pts > L or 3 * n_pts > nf
            or n_kf < 2 * n_revisit + 12):
        raise ValueError("the circuit does not fit the configuration")
    drift = creep ** (1.0 / (n_kf - 1))
    scales = drift ** np.arange(n_kf)
    n_loop = n_kf - n_revisit
    R_true, c_true = [], []
    for k in range(n_kf):
        step = k - n_loop - 1 if k >= n_loop else k
        ang = 2 * np.pi * step / n_kf
        R_wc = _rodrigues([0.0, ang, 0.0])
        R_true.append(R_wc.T)
        c_true.append(np.array([np.sin(ang), 0.0, 1.0 - np.cos(ang)])
                      * radius)
    R_true, c_true = np.stack(R_true), np.stack(c_true)
    Rk = np.tile(np.eye(3), (K, 1, 1))
    tk = np.zeros((K, 3))
    for k in range(n_kf):
        Rk[k] = R_true[k]
        tk[k] = -R_true[k] @ (c_true[k] * scales[k])

    def project(k, X):
        pc = X @ Rk[k].T + tk[k]
        z = pc[:, 2]
        uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
        ok = (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < H)
        return uv + rng.normal(0, 0.3, uv.shape), ok, np.linalg.norm(
            X - (-Rk[k].T @ tk[k]), axis=-1)

    kp_xy = np.stack([rng.uniform(0, W, (K, nf)), rng.uniform(0, H, (K, nf))],
                     -1)
    kp_desc = rng.integers(0, 2 ** 32, (K, nf, 8), dtype=np.uint32)
    descs = rng.integers(0, 2 ** 32, (n_kf * n_pts, 8), dtype=np.uint32)
    pos = np.zeros((L, 3))
    desc = np.zeros((L, 8), np.uint32)
    normal = np.zeros((L, 3))
    min_d, max_d = np.zeros(L), np.full(L, 1e9)
    first_kf = np.zeros(L, np.int32)
    obs_kf = np.full((L, O), -1, np.int32)
    obs_kp = np.full((L, O), -1, np.int32)
    obs_valid = np.zeros((L, O), bool)
    early = {}
    for k in range(n_kf):
        rows = np.arange(k * n_pts, (k + 1) * n_pts)
        revisit_of = k - n_loop if k >= n_loop else -1
        if revisit_of >= 0:
            pts = early[revisit_of] * scales[k]
            desc_rows = np.arange(revisit_of * n_pts, (revisit_of + 1) * n_pts)
        else:
            pc = np.stack([rng.uniform(-1.5, 1.5, n_pts),
                           rng.uniform(-1.0, 1.0, n_pts),
                           rng.uniform(3.0, 6.0, n_pts)], -1)
            pts = (pc - tk[k]) @ Rk[k]
            desc_rows = rows
            if k < n_revisit:
                early[k] = pts / scales[k]
        uv, _, dist = project(k, pts)
        kp_xy[k, :n_pts] = uv
        kp_desc[k, :n_pts] = descs[desc_rows]
        pos[rows] = pts
        desc[rows] = descs[desc_rows]
        ray = pts + Rk[k].T @ tk[k]
        normal[rows] = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
        max_d[rows] = dist
        min_d[rows] = dist / cfg.scale ** (cfg.n_levels - 1)
        first_kf[rows] = k
        obs_kf[rows, 0] = k
        obs_kp[rows, 0] = np.arange(n_pts)
        obs_valid[rows, 0] = True
        # The second observation: the next keyframe (the previous one for
        # the last patch), where the point is in its view.
        other, base = (k + 1, n_pts) if k + 1 < n_kf else (k - 1, 2 * n_pts)
        uv2, ok2, _ = project(other, pts)
        kp_xy[other, base:base + n_pts][ok2] = uv2[ok2]
        obs_kf[rows[ok2], 1] = other
        obs_kp[rows[ok2], 1] = base + np.flatnonzero(ok2)
        obs_valid[rows[ok2], 1] = True
    n_lm = n_kf * n_pts
    n_obs = obs_valid.sum(1).astype(np.int32)
    valid = np.arange(L) < n_lm
    kf_valid = np.arange(K) < n_kf
    f32 = np.float32
    state = ms.MapState(
        kfs=ms.KeyFrames(
            R=Rk.astype(f32), t=tk.astype(f32),
            stamp=(np.arange(K) * kf_valid).astype(f32),
            kp_xy=(kp_xy * kf_valid[:, None, None]).astype(f32),
            kp_level=np.zeros((K, nf), np.int32),
            kp_angle=np.zeros((K, nf), f32),
            kp_desc=kp_desc * kf_valid[:, None, None].astype(np.uint32),
            kp_valid=np.repeat(kf_valid[:, None], nf, 1),
            kp_ur=np.full((K, nf), -1.0, f32), valid=kf_valid),
        lms=ms.Landmarks(
            pos=pos.astype(f32), desc=desc, normal=normal.astype(f32),
            min_dist=min_d.astype(f32), max_dist=max_d.astype(f32),
            n_obs=n_obs, n_found=valid.astype(np.int32),
            n_visible=valid.astype(np.int32), first_kf=first_kf,
            valid=valid),
        obs=ms.Observations(kf=obs_kf, kp=obs_kp, valid=obs_valid))
    parent = np.full(K, -1, np.int32)
    parent[1:n_kf] = np.arange(n_kf - 1)
    return LoopMap(
        state=state, n_kf=n_kf,
        revisit=tuple(range(n_loop, n_kf)),
        revisit_of=tuple(range(n_revisit)), c_true=c_true.astype(f32),
        scales=scales,
        cam_params=np.array([fx, fy, cx, cy], f32), kf_parent=parent)


def loop_golden_config(vocabulary=None, **changes):
    """Cell (k), the runners' default configuration
    (``scripts/run_euroc_mono.py`` with no flag): :func:`euroc_golden_config`
    (the golden frames padded to 752x480 at the EuRoC-mono capacity, 1536
    features) with ``vocabulary`` and ``SlamConfig``'s defaults
    ``use_loop_closing=True`` and ``background_gba=True``."""
    return euroc_golden_config(vocabulary=vocabulary, use_loop_closing=True,
                               background_gba=True, **changes)


# The JAX MonoSlam's run of cell (k) (``scripts/loop_reference_jax.py k`` on
# the CPU, ``synthetic_voc_10k.npz``, the map cut to
# :data:`RELOC_CPU_SLOTS`): every frame from the third hosts a keyframe
# (slots 2-43), each keyframe's loop detection runs when the next is made
# (and the last at the trajectory read), the database is mined from the
# twelfth keyframe on, and no candidate survives the exclusion of the
# covisible and the last 10 keyframes: no keyframe verifies a candidate and
# no loop fires. 44 frames, ATE 0.006724 m (Horn with scale). ``detect``:
# per call the keyframe, the keyframe count, the candidates (-1: none;
# empty below ``min_map_kfs``), whether a loop fired and its candidate.
LOOP_JAX = dict(
    frames=44, ate_m=0.006724322260210651, loops=0,
    detect=[dict(query=q, n_kf=q + 1,
                 candidates=[-1, -1, -1] if q + 1 >= 12 else [],
                 fired=False, cand=None) for q in range(2, 43)])


# --- The atlas merge ---------------------------------------------------------

# The merge cells (``tests/test_map_merge_live.py``'s run at the EuRoC-mono
# capacity): golden frames 0-29 (the test's t = 0.0-2.9 s), 6 noise frames
# (uniform 0-30, numpy seed :data:`RELOC_NOISE_SEED`) past the
# RECENTLY_LOST budget of 2, so that the mature map A is kept and a map B
# started, then the revisit of golden frames 5-24 (the test's 0.5-2.4 s),
# on which map B initialises and the merge branch welds A back. Stamps
# continue 0.1 s apart. Cell (m) saves map A after frame 29 through
# ``save_atlas_checkpoint``, loads it into a fresh system and plays the
# revisit frames alone.
MERGE_TRACKED = 30
MERGE_NOISE = 6
MERGE_REVISIT = tuple(range(5, 25))


def merge_sequence(frames: GoldenFrames | None = None) -> list:
    """Cell (l)'s frames as :class:`RelocFrame` s: the golden frames padded
    to EuRoC's 752 columns, the noise blackout and the revisit (see
    :data:`MERGE_TRACKED`). Cell (m) plays ``[:MERGE_TRACKED]`` into the
    system it saves and ``[MERGE_TRACKED + MERGE_NOISE:]`` into the one it
    loads."""
    g = frames if frames is not None else golden_frames()
    padded = pad_frames(g.frames)
    h, w = padded.shape[1:]
    rng = np.random.default_rng(RELOC_NOISE_SEED)
    world = (list(range(MERGE_TRACKED)) + [-1] * MERGE_NOISE
             + list(MERGE_REVISIT))
    out = []
    for i, k in enumerate(world):
        img = (rng.uniform(0, 30, (h, w)).astype(np.float32) if k < 0
               else padded[k])
        out.append(RelocFrame(img, round(0.1 * i, 6), k))
    return out


def merge_golden_config(vocabulary=None, **changes):
    """The merge cells' configuration: :func:`euroc_golden_config` with
    ``vocabulary``, loop closing and the background GBA on (the defaults),
    ``cross_map_reloc`` off and a RECENTLY_LOST budget of 2 frames, as
    ``tests/test_map_merge_live.py:29-36`` sets them (with cross-map
    relocalisation the revisit would re-enter map A directly instead of
    merging it)."""
    return euroc_golden_config(vocabulary=vocabulary, use_loop_closing=True,
                               background_gba=True, cross_map_reloc=False,
                               lost_grace_frames=2, **changes)


# The JAX reference run's map slots (``scripts/merge_reference_jax.py``):
# the test's 64 keyframe and 8192 landmark slots (the JAX init's one-hot
# Schur does not fit 1,024 x 65,536 on a host).
MERGE_CPU_SLOTS = dict(max_kf=64, max_lm=8192)


def merge_maps(atlas, lc, kf_id: int, other_idx: int, corr, cam_params, *,
               cfg: MonoConfig = EUROC_MONO, ba_kwargs=None,
               mesh=None) -> dict:
    """The device half of ``MonoSlam._merge_maps`` (MergeLocal): weld atlas
    map ``other_idx`` into the current one at its keyframe ``kf_id``.

    ``corr`` (R, t, s, n) maps the current world onto the other's
    (``LoopCloser.detect_merge``'s, read with its ladder): inverted on the
    host in float64; ``atlas.merge`` through the inverse; the welded map's
    spanning-tree root attached to ``kf_id``; ``lc.on_maps_merged`` (the
    databases, the loop edges, the transplanted keyframes' BoW in one
    ``add_range``); ``fuse_duplicates`` at ``kf_id`` (K2's window mode over
    every landmark slot); then the global BA (sharded over ``mesh``, a
    ``parallel.dist_ba`` mesh, when given) when the merged map holds 64
    keyframes or fewer, else the covisibility-windowed BA around ``kf_id``
    with ``max(cfg.local_window + 1, 12)`` free keyframes. No host read.
    Returns ``info``: the inverse Sim3 (``R_i``, ``t_i``, ``s_i``, numpy
    float64), the transplanted slots ``kf_lo``, ``kf_hi`` and ``ba``
    ("global" or "windowed")."""
    from .pipeline import mapping
    kw = dict(ba_kwargs or {})
    R_m, t_m, s_m = corr[:3]
    R_i = np.asarray(R_m, np.float64).T
    s_i = 1.0 / float(s_m)
    t_i = -s_i * (R_i @ np.asarray(t_m, np.float64))
    kf_lo = atlas.counts().n_kf
    atlas.merge(other_idx, R_i, t_i, s_i)
    meta = atlas.counts()
    kf_hi = meta.n_kf
    if meta.kf_parent is None:
        meta.kf_parent = np.full(atlas.dims[0], -1, np.int32)
    if kf_lo < kf_hi and meta.kf_parent[kf_lo] < 0:
        meta.kf_parent[kf_lo] = kf_id
    lc.on_maps_merged(atlas.current, other_idx, atlas.state, kf_lo, kf_hi)
    # SearchAndFuse in the welding window (LoopClosing.cc:2689).
    state = mapping.fuse_duplicates(atlas.state, kf_id, cam_params,
                                    float(cfg.width), float(cfg.height))
    # The merge refinement: the full map while small, else the welding
    # window's local BA (Optimizer.cc:5195); the weld already moved the
    # whole other map rigidly, so no pose graph follows.
    if kf_hi <= 64:
        state = mapping.global_ba(state, cam_params, mesh=mesh, **kw)
        ba = "global"
    else:
        state = mapping.windowed_local_ba(
            state, kf_id, cam_params,
            n_free=max(cfg.local_window + 1, 12), n_window=cfg.ba_window,
            n_lm_window=cfg.ba_lm_window, **kw)
        ba = "windowed"
    atlas.state = state
    return dict(R_i=R_i, t_i=t_i, s_i=s_i, kf_lo=kf_lo, kf_hi=kf_hi, ba=ba)


def map_merge_step(atlas, lc, kf_id: int, cam_params, *,
                   cfg: MonoConfig = EUROC_MONO, ba_kwargs=None) -> dict:
    """The merge branch of ``MonoSlam._run_loop_closing`` for keyframe
    ``kf_id`` of the atlas's current map, as one entry point:
    ``lc.detect_merge`` (each other map's database groups, each
    candidate's verification ladder: K2 twice in window mode over the
    other map's landmark slots, the Sim3 RANSAC and OptimizeSim3, the
    temporal streak) and, when it fires, :func:`merge_maps` (the system
    drops a background GBA in flight first). Returns ``info``: the detection's
    record (each map's candidates and host reads, ``tried``, the streak's
    count), ``fired``, and when it fired ``other``, ``cand``, ``sim3`` and
    :func:`merge_maps`'s ``weld``."""
    det = lc.detect_merge(atlas.state, kf_id, atlas)
    info = dict(lc.info)
    info["host_reads"] = list(info["host_reads"])
    info.setdefault("fired", False)
    if det is None:
        return info
    other, cand, corr = det
    info.update(fired=True, other=int(other), cand=int(cand), sim3=corr)
    info["weld"] = merge_maps(atlas, lc, kf_id, other, corr, cam_params,
                              cfg=cfg, ba_kwargs=ba_kwargs)
    return info


class MergeAtlas(NamedTuple):
    """:func:`euroc_merge_atlas`'s two maps (numpy leaves, the JAX
    package's dtypes) and truth."""

    maps: tuple               # (map A, map B) states
    n_kf: tuple               # live keyframes of each, slots [0, n)
    n_lm: tuple               # landmark rows of each, rows [0, n)
    kf_parent: tuple          # each map's spanning tree (a chain)
    revisit_of: tuple         # map A's keyframe each of B's re-observes
    plant: tuple              # (R, t, s): x_B = s R x_A + t, float64
    c_true_b: np.ndarray      # (n_b, 3) B's true centres in B's world
    cam_params: np.ndarray    # (4,) float32


# The planted weld: map A's world -> map B's (a rotation of 0.37 rad, a
# translation, scale 0.8); map B's middle keyframe sits this far (m) from
# its true centre before the merge (not the last, whose verification
# fixes the weld: OptimizeSim3's scale about a misplaced query camera is
# barely held by the reprojections).
MERGE_PLANT_ROTVEC = (0.1, -0.3, 0.2)
MERGE_PLANT_T = (0.5, -0.2, 1.0)
MERGE_PLANT_S = 0.8
MERGE_QUERY_OFFSET = (0.02, -0.01, 0.015)


def euroc_merge_atlas(cfg: MonoConfig = EUROC_MONO, n_kf: int = 160,
                      n_pts: int = 300, seed: int = 0) -> MergeAtlas:
    """Two maps at ``cfg``'s capacity that the merge branch welds: the
    circuit of :func:`euroc_loop_map` without scale creep (``n_kf``
    keyframes at the defaults, 3 of them revisits), split in two. Map A is
    the circuit without its revisits (``n_kf - 3`` keyframes, their
    patches: about 47,000 landmarks; the last patch's points that only a
    revisit saw again are dead). Map B is the 3 revisit keyframes with
    their own patches (900 landmarks re-observing A's keyframes 0-2's
    points with their descriptors), moved into a world of its own by the
    planted Sim3 (:data:`MERGE_PLANT_S`: x_B = s R x_A + t); its middle
    keyframe's centre is off by :data:`MERGE_QUERY_OFFSET`, which the
    merge BA corrects with A's landmarks. B's keyframes sit in slots 0-2
    and its landmarks in rows 0-899."""
    full = euroc_loop_map(cfg, n_kf=n_kf, n_pts=n_pts, n_revisit=3,
                          creep=1.0, seed=seed)
    st = full.state
    n_a = n_kf - 3
    l_a = n_a * n_pts
    K = cfg.max_kf
    f32 = np.float32

    # Map A: keyframes [0, n_a), landmarks [0, l_a), their observations.
    kf_a = np.arange(K) < n_a
    lm_a = np.arange(st.lms.pos.shape[0]) < l_a
    ov_a = st.obs.valid & (st.obs.kf < n_a) & lm_a[:, None]
    # The last patch's points that only a revisit saw again die with one
    # observation, as the bundle's culling would have them.
    lm_a &= ov_a.sum(1) >= 2
    ov_a &= lm_a[:, None]
    kfs_a = st.kfs._replace(valid=st.kfs.valid & kf_a,
                            kp_valid=st.kfs.kp_valid & kf_a[:, None])
    state_a = ms.MapState(
        kfs=kfs_a,
        lms=st.lms._replace(valid=st.lms.valid & lm_a,
                            n_obs=ov_a.sum(1).astype(np.int32)),
        obs=ms.Observations(kf=np.where(ov_a, st.obs.kf, -1).astype(np.int32),
                            kp=np.where(ov_a, st.obs.kp, -1).astype(np.int32),
                            valid=ov_a))

    # Map B: the revisits and their patches, moved by the plant.
    R_p = _rodrigues(MERGE_PLANT_ROTVEC)
    t_p = np.asarray(MERGE_PLANT_T, np.float64)
    s_p = MERGE_PLANT_S

    def rows(x, lo, n):
        out = np.zeros_like(x)
        out[:n] = x[lo:lo + n]
        return out

    kf_b = np.arange(K) < 3
    Rb = np.tile(np.eye(3), (K, 1, 1))
    tb = np.zeros((K, 3))
    R_src = st.kfs.R[n_a:n_kf].astype(np.float64)
    t_src = st.kfs.t[n_a:n_kf].astype(np.float64)
    Rb[:3] = R_src @ R_p.T
    tb[:3] = s_p * t_src - np.einsum("kij,j->ki", Rb[:3], t_p)
    c_true_b = s_p * full.c_true[n_a:n_kf].astype(np.float64) @ R_p.T + t_p
    # The middle keyframe's centre moved by the offset: t = -R c.
    c_off = -Rb[1].T @ tb[1] + np.asarray(MERGE_QUERY_OFFSET)
    tb[1] = -Rb[1] @ c_off
    kfs_b = ms.KeyFrames(
        R=Rb.astype(f32), t=tb.astype(f32),
        stamp=rows(st.kfs.stamp, n_a, 3),
        kp_xy=rows(st.kfs.kp_xy, n_a, 3),
        kp_level=rows(st.kfs.kp_level, n_a, 3),
        kp_angle=rows(st.kfs.kp_angle, n_a, 3),
        kp_desc=rows(st.kfs.kp_desc, n_a, 3),
        kp_valid=rows(st.kfs.kp_valid, n_a, 3),
        kp_ur=np.where(kf_b[:, None], rows(st.kfs.kp_ur, n_a, 3), -1.0
                       ).astype(f32),
        valid=kf_b)
    l_b = 3 * n_pts
    lm_b = np.arange(st.lms.pos.shape[0]) < l_b
    pos_b = s_p * rows(st.lms.pos, l_a, l_b).astype(np.float64) @ R_p.T + t_p
    okf = rows(st.obs.kf, l_a, l_b)
    ov_b = rows(st.obs.valid, l_a, l_b) & lm_b[:, None]
    state_b = ms.MapState(
        kfs=kfs_b,
        lms=ms.Landmarks(
            pos=np.where(lm_b[:, None], pos_b, 0.0).astype(f32),
            desc=rows(st.lms.desc, l_a, l_b),
            normal=(rows(st.lms.normal, l_a, l_b) @ R_p.T).astype(f32),
            min_dist=(rows(st.lms.min_dist, l_a, l_b) * s_p).astype(f32),
            max_dist=np.where(lm_b, rows(st.lms.max_dist, l_a, l_b) * s_p,
                              1e9).astype(f32),
            n_obs=ov_b.sum(1).astype(np.int32),
            n_found=lm_b.astype(np.int32), n_visible=lm_b.astype(np.int32),
            first_kf=np.where(lm_b, rows(st.lms.first_kf, l_a, l_b) - n_a,
                              0).astype(np.int32),
            valid=lm_b),
        obs=ms.Observations(
            kf=np.where(ov_b, okf - n_a, -1).astype(np.int32),
            kp=np.where(ov_b, rows(st.obs.kp, l_a, l_b), -1).astype(np.int32),
            valid=ov_b))
    par_a = np.full(K, -1, np.int32)
    par_a[1:n_a] = np.arange(n_a - 1)
    par_b = np.full(K, -1, np.int32)
    par_b[1:3] = np.arange(2)
    return MergeAtlas(
        maps=(state_a, state_b), n_kf=(n_a, 3), n_lm=(l_a, l_b),
        kf_parent=(par_a, par_b), revisit_of=(0, 1, 2),
        plant=(R_p, t_p, s_p), c_true_b=c_true_b,
        cam_params=full.cam_params)


def merge_ate(traj, t0: float, seq: list,
              frames: GoldenFrames | None = None) -> tuple:
    """The Horn-aligned (with scale) ATE of a trajectory (``(stamp, R_cw,
    t_cw)`` records, stamps relative to the system's first, ``t0``) over
    the frames of ``seq`` that show a golden frame: (ATE m, frames
    associated); (None, n) under 3."""
    from .utils import evaluate
    g = frames if frames is not None else golden_frames()
    world = {round(f.stamp, 6): f.world for f in seq}
    est, true = [], []
    for s, R, t in traj:
        k = world.get(round(float(s) + t0, 6), -1)
        if k >= 0:
            est.append(-np.asarray(R, np.float64).T
                       @ np.asarray(t, np.float64))
            true.append(g.centres[k])
    if len(est) < 3:
        return None, len(est)
    return float(evaluate.horn_align(np.stack(est), np.stack(true))[3]), \
        len(est)


# The CPU tests' live merge cell ("s", ``tests/test_torch_merge_system.py``):
# ``SynthWorld(seed=3)`` (the golden frames' world) rendered at 320x240
# with fx = fy = 200 at these times (s; None: a frame of uniform 0-30
# noise, numpy seed :data:`RELOC_NOISE_SEED`), stamps 0.1 s apart: map A
# over 0.0-2.9 s, the blackout, the revisit of 0.5-1.4 s.
MERGE_SMALL_TIMES = (tuple(round(0.1 * i, 3) for i in range(30))
                     + (None,) * MERGE_NOISE
                     + tuple(round(0.1 * i, 3) for i in range(5, 15)))


def merge_small_config(vocabulary=None, **changes):
    """Cell "s"'s configuration: the world's 320x240 pinhole, 1024
    features, 48 keyframe / 4096 landmark slots, 8 observations, the
    40-match init gate, TrackedMapPoints(1), loop closing on, cross-map
    relocalisation off, a RECENTLY_LOST budget of 2 frames."""
    from .pipeline.system import SlamConfig
    cfg = SlamConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320,
                     height=240, n_features=1024, max_kf=48, max_lm=4096,
                     max_obs=8, fps=10, min_init_matches=40,
                     kf_ref_min_obs=1, vocabulary=vocabulary,
                     use_loop_closing=True, cross_map_reloc=False,
                     lost_grace_frames=2)
    return dataclasses.replace(cfg, **changes)


# The JAX MonoSlam's runs of the merge cells (``scripts/merge_reference_jax.py
# l | m`` on the CPU, ``synthetic_voc_10k.npz``, the map cut to
# :data:`MERGE_CPU_SLOTS`): the sequence index of the frame that merged,
# the active map's keyframe whose lagging detection fired (``kf_id``), the
# other map and its candidate keyframe, the Sim3's scale, each map's
# keyframe count before the weld, the keyframe count and the merged
# trajectory's ATE at the end (cell (m): of the loaded system's frames),
# and for (m) the saved map's keyframes and the checkpoint's bytes at those
# slots. Both runs merge on the same keyframe. Cell "s" (the CPU tests',
# :data:`MERGE_SMALL_TIMES` at its own slots) is held by its decisions
# alone.
MERGE_JAX = {
    "l": dict(index=45, kf_id=7, other=0, cand=12,
              scale=1.4790799617767334, n_kf_maps=(29, 8), n_kf=38,
              ate_m=0.06963021162690618),
    "m": dict(index=45, kf_id=7, other=0, cand=12,
              scale=1.4790799617767334, n_kf_maps=(29, 8), n_kf=38,
              ate_m=0.05404188751963639, n_kf_saved=29, bytes=1906887),
    "s": dict(index=41, kf_id=4, other=0, cand=4, scale=1.039900779724121,
              n_kf_maps=(24, 5), n_kf=30),
}
MERGE_ATE_GATE = (1.5, 0.002)        # x the JAX run's ATE, + m


def merge_run_gates(cell: str, statuses, n_maps, merges, n_kf_a: int,
                    n_kf_end: int, traj, t0: float, seq: list,
                    frames: GoldenFrames | None = None) -> dict:
    """A merge cell's gates on one run: ``statuses`` and ``n_maps`` (the
    atlas's map count) after each frame of the run, dicts by sequence
    index (cell (m) runs ``seq[:MERGE_TRACKED]`` then the revisit);
    ``merges``, one dict per ``_merge_maps`` call (``index`` its frame,
    ``kf_id``); map A's keyframe count before the blackout (cell (m): at
    the save); the keyframe count at the end and the trajectory. Cell (l)
    must hold two maps in the blackout; both must merge once, with the
    active keyframe within one of the JAX run's, end with one map of more
    than 0.8 x map A's keyframes, track (status OK) on every frame from
    the merge on, and keep the merged trajectory's ATE within
    :data:`MERGE_ATE_GATE` of the JAX run's. Returns the measures and
    ``ok``."""
    ref = MERGE_JAX[cell]
    ate, n_assoc = merge_ate(traj, t0, seq, frames)
    out = dict(jax=ref, merges=merges, n_kf_a=n_kf_a, n_kf_end=n_kf_end,
               n_maps_end=n_maps[max(n_maps)], ate_m=ate, n_assoc=n_assoc)
    idx = sorted(statuses)
    blackout = [n_maps[i] for i in idx
                if MERGE_TRACKED <= i < MERGE_TRACKED + MERGE_NOISE]
    out["second_map_in_blackout"] = 2 in blackout
    if len(merges) != 1:
        return dict(out, ok=False)
    m = merges[0]
    out.update(merge_index=m["index"], merge_kf=m["kf_id"],
               ok_after=all(statuses[i] == 1 for i in idx if i >= m["index"]))
    gate = MERGE_ATE_GATE[0] * ref["ate_m"] + MERGE_ATE_GATE[1]
    out["ok"] = bool(
        (cell != "l" or out["second_map_in_blackout"])
        and abs(m["kf_id"] - ref["kf_id"]) <= 1
        and out["n_maps_end"] == 1 and n_kf_end > 0.8 * n_kf_a
        and out["ok_after"] and ate is not None and ate < gate)
    return out


# --- The chessboard world frame -------------------------------------------

def _mycamera():
    from .utils.chessboard import ChessboardConfig
    return ChessboardConfig(width=9, height=6, square_size=0.024,
                            start_x=0.0, start_y=0.0, z_height=0.0)


# The fork's own deployment, ``configs/Mycamera.yaml`` (a Basler camera):
# 1280x1024 pinhole with radtan, 1000 ORB features over 8 levels at 1.2,
# FAST 20 / 7, 30 fps, and the chessboard world frame (a 9 x 6 board of
# 24 mm squares, its origin at (0, 0, 0)); the map capacity is the
# monocular runner's (``scripts/run_euroc_mono.py``: 1024 keyframes, 65536
# landmarks) with the system's 12 observations. The port's own constants;
# ``tests/test_torch_settings.py`` holds them to ``io.settings``' reading
# of the file.
MYCAMERA_MONO = MonoConfig(
    width=1280, height=1024, fx=1236.996438, fy=1236.748984,
    cx=651.355418, cy=512.285855,
    dist=(-0.1419322617307899, 0.05865966713236987, 0.001520840995510708,
          0.001582820035262499),
    n_features=1000, n_levels=8, scale=1.2, max_kf=1024, max_lm=65536,
    max_obs=12)
MYCAMERA_FPS = 30.0
MYCAMERA_FAST = (20, 7)
MYCAMERA_BOARD = _mycamera()


class ChessboardPose(NamedTuple):
    """:func:`chessboard_pose`'s result: the corners (N, 2) float64
    distorted pixels in a grid order, and the camera's pose in the board's
    frame (R_cw, t_cw float32 numpy); None where not found."""

    corners: np.ndarray | None
    R: np.ndarray | None
    t: np.ndarray | None


def chessboard_pose(img, board, cam_params, dist=None) -> ChessboardPose:
    """The chessboard step of an uninitialised ``MonoSlam`` frame
    (``_snoop_chessboard``): ``utils.chessboard.detect_chessboard`` on the
    device image ``img`` (H, W) (the ChESS responses, the candidates, the
    corners' refinement: two reads), then ``pose_from_chessboard`` (the
    four orderings' homographies and LM: one read) with the corners
    undistorted through ``dist`` (radtan, a tensor or None).
    ``cam_params``: fx, fy, cx, cy (a tensor). Runs where ``img`` lies."""
    from .utils import chessboard as cb
    corners = cb.detect_chessboard(img, board)
    if corners is None:
        return ChessboardPose(None, None, None)
    c = torch.as_tensor(cam_params, dtype=torch.float64, device=img.device)
    z, o = torch.zeros_like(c[0]), torch.ones_like(c[0])
    K = torch.stack([torch.stack([c[0], z, c[2]]),
                     torch.stack([z, c[1], c[3]]), torch.stack([z, z, o])])
    pose = cb.pose_from_chessboard(corners, board, K, dist=dist,
                                   device=img.device)
    if pose is None:
        return ChessboardPose(corners, None, None)
    return ChessboardPose(corners, *pose)


CHESSBOARD_FRAMES = (Path(__file__).resolve().parents[1] / "tests" /
                     "golden" / "frames_chessboard.npz")


class ChessboardFrames(NamedTuple):
    """The chessboard cell's input (``scripts/make_torch_chessboard_frames.
    py``): a 9 x 6 board of 24 mm squares on a textured floor with raised
    plates, seen through Mycamera's radtan from 0.62 m above, 30 frames at
    10 Hz; the board in full view on frames 0-12. Poses are in the board's
    frame (z up, origin at the first inner corner)."""

    frames: np.ndarray           # (30, 1024, 1280) uint8
    frames_half: np.ndarray      # (30, 512, 640) uint8, intrinsics halved
    stamps: np.ndarray           # (30,) float64 s
    R: np.ndarray                # (30, 3, 3) float64 true board->camera
    t: np.ndarray                # (30, 3)
    centres: np.ndarray          # (30, 3) true camera centres
    corners: np.ndarray          # (30, 54, 2) true corners (NaN outside)
    corners_half: np.ndarray
    cv_corners: np.ndarray       # OpenCV's SB corners (NaN: none found)
    cv_corners_half: np.ndarray
    cv_err: np.ndarray           # (30,) their mean error, px (NaN: none)
    cv_err_half: np.ndarray
    camera: np.ndarray           # fx, fy, cx, cy, w, h, k1, k2, p1, p2
    board: np.ndarray            # width, height, square, x, y, z


def chessboard_frames(path=CHESSBOARD_FRAMES) -> ChessboardFrames:
    """Load the chessboard cell's fixture."""
    with np.load(path) as z:
        return ChessboardFrames(**{k: z[k] for k in ChessboardFrames._fields})


def chessboard_golden_config(half: bool = False, **changes):
    """Cell (n): ``MonoSlam`` at :data:`MYCAMERA_MONO` with the board, on
    the chessboard fixture. Cuts: 10 Hz (the fixture's rate, for 30 fps);
    ``min_init_matches`` 60 and ``kf_ref_min_obs`` 1, the synthetic world's
    (as every synthetic mono cell): at the 100-match gate the full-size
    frames 0 and 2 keep 84 matches, so the reference frame moves on and
    keyframe 0 is not the frame the board was seen on. ``half``: the
    640x512 frames with the intrinsics halved (the CPU tests' size).
    ``changes`` replace fields."""
    from .pipeline.system import SlamConfig
    e = MYCAMERA_MONO
    k = 0.5 if half else 1.0
    cfg = SlamConfig(
        fx=e.fx * k, fy=e.fy * k, cx=e.cx * k, cy=e.cy * k,
        width=int(e.width * k), height=int(e.height * k),
        dist=np.array(e.dist, np.float32), n_features=e.n_features,
        max_kf=e.max_kf, max_lm=e.max_lm, max_obs=e.max_obs, fps=10,
        local_window=e.local_window, ba_window=e.ba_window,
        ba_lm_window=e.ba_lm_window, local_kf_window=e.n_local_kf,
        local_lm_window=e.n_local_lm, recent_kf_window=e.recent_kf,
        min_init_matches=60, kf_ref_min_obs=1, chessboard=MYCAMERA_BOARD)
    return dataclasses.replace(cfg, **changes)


# The CPU runs' map (the JAX init's one-hot Schur does not fit 1,024).
CHESS_CPU_SLOTS = dict(max_kf=48, max_lm=8192)


def chessboard_flip(board) -> tuple:
    """The board's 180-degree symmetry about its centre as (R, t) on world
    points: p -> R p + t."""
    c = np.array([board.start_x + 0.5 * (board.width - 1) * board.square_size,
                  board.start_y + 0.5 * (board.height - 1)
                  * board.square_size, board.z_height])
    Rz = np.diag([-1.0, -1.0, 1.0])
    return Rz, c - Rz @ c


def chessboard_pose_error(R, t, R_true, t_true, board) -> tuple:
    """(rotation error deg, centre error m, flipped) of a pose in the
    board's frame against the truth, up to the board's symmetry: the
    smaller of the pose itself and the pose in the flipped frame."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    Rf, tf = chessboard_flip(board)
    out = []
    for flipped in (False, True):
        # In the flipped world, T_true' = T_true F^-1 (F its own inverse).
        Rt = R_true @ Rf if flipped else R_true
        tt = R_true @ tf + t_true if flipped else t_true
        ang = np.degrees(np.arccos(np.clip((np.trace(R.T @ Rt) - 1) / 2,
                                           -1.0, 1.0)))
        out.append((float(ang), float(np.linalg.norm(-R.T @ t + Rt.T @ tt)),
                    flipped))
    return min(out)


def chessboard_scale_ate(stamps, R, t, frames: ChessboardFrames, t0: float,
                         flipped: bool, board=None) -> dict:
    """The trajectory's camera centres in the board's frame against the
    truth (flipped when the run's frame is the flipped one), after the one
    scale the rebase leaves free: the scale about keyframe 0's centre
    (the rebase's anchor, the first entry), fitted by least squares.
    ``stamps`` relative to ``t0``. Returns the scale, the RMSE (m) and the
    associated count."""
    board = board or MYCAMERA_BOARD
    Rf, tf = chessboard_flip(board)
    idx = [int(np.argmin(np.abs(frames.stamps - (s + t0)))) for s in stamps]
    est = np.stack([-np.asarray(r, np.float64).T @ np.asarray(x, np.float64)
                    for r, x in zip(R, t)])
    gt = frames.centres[idx]
    if flipped:
        gt = gt @ Rf.T + tf
    a = est[0]
    d_e, d_g = est - a, gt - a
    s = float((d_e * d_g).sum() / max((d_e * d_e).sum(), 1e-30))
    fit = a + s * d_e
    return dict(scale=s, ate_m=float(np.sqrt(((fit - gt) ** 2).sum(1)
                                             .mean())), n=len(idx))


# The JAX MonoSlam's runs of cell (n) (``scripts/chessboard_reference_jax.py
# full | half`` on the CPU, the map cut to :data:`CHESS_CPU_SLOTS`): the
# frame whose snoop found the board, the first initialisation's frame and
# its keyframe 0's, the frame of the rebase, the board pose's error against
# the truth (distorted corners), and the ATE after the scale fit about
# keyframe 0 over the trajectory it kept. The JAX system loses track on the
# frame after its rebase (its fault, ROADMAP section 3) and never relocates
# the board's frame: its ATE and its rotations (134-137 degrees off) hold
# the port to little; the rotation gate does.
CHESS_JAX = {
    "full": dict(snoop=0, init=2, kf0=0, rebase=3, lost_from=4,
                 pose_deg=0.06706781757595814, pose_m=0.0015974504234029289,
                 ate_m=0.2034578018497373),
    "half": dict(snoop=0, init=1, kf0=0, rebase=2, lost_from=3,
                 pose_deg=0.07758544076080837, pose_m=0.0016790882567631696,
                 ate_m=0.4249886490092081),
}
CHESS_ATE_GATE = (1.5, 0.002)        # x the JAX run's ATE, + m
CHESS_POSE_GATE = (0.5, 0.005)       # deg, m: the snooped pose's error
CHESS_ROT_GATE_DEG = 1.0             # each tracked frame's rotation


def chessboard_run_gates(events: dict, slam, traj,
                         frames: ChessboardFrames, size: str = "full") -> dict:
    """Cell (n)'s gates on one run. ``events``: the frame of the snoop that
    found the board (``snoop``), every rebase's frame (``rebases``),
    keyframe 0's frame (``kf0``) and keyframe 0's largest distance from the
    board pose after the rebase (``kf0_gap``). The board must be found on
    the JAX run's frame, its pose within :data:`CHESS_POSE_GATE` of the
    truth (up to the board's symmetry); one rebase, within one frame of
    the JAX run's, after which keyframe 0 is the board pose within 1e-5;
    every frame of the trajectory within :data:`CHESS_ROT_GATE_DEG` of the
    true rotation in the board's frame; the ATE after the scale fit
    within :data:`CHESS_ATE_GATE` of the JAX run's. Returns the measures
    and ``ok``."""
    ref = CHESS_JAX[size]
    board = slam.cfg.chessboard
    out = dict(snoop=events.get("snoop"), kf0=events.get("kf0"),
               rebases=events.get("rebases", []),
               kf0_gap=events.get("kf0_gap"), frames=len(traj), jax=ref)
    if slam._chess_pose is None or not out["rebases"] or not traj:
        return dict(out, ok=False)
    out["rebase"] = out["rebases"][0]
    k = out["snoop"]
    ang, cen, flipped = chessboard_pose_error(*slam._chess_pose, frames.R[k],
                                              frames.t[k], board)
    st = [s for s, _, _ in traj]
    Rs = [np.asarray(r) for _, r, _ in traj]
    ts = [np.asarray(x) for _, _, x in traj]
    idx = [int(np.argmin(np.abs(frames.stamps - (s + slam.t0)))) for s in st]
    rot = [chessboard_pose_error(r, x, frames.R[i], frames.t[i], board)[0]
           for r, x, i in zip(Rs, ts, idx)]
    fit = chessboard_scale_ate(st, Rs, ts, frames, slam.t0, flipped, board)
    gate = CHESS_ATE_GATE[0] * ref["ate_m"] + CHESS_ATE_GATE[1]
    out.update(pose_deg=ang, pose_m=cen, flipped=flipped, rot_deg=rot,
               rot_deg_max=float(max(rot)), ate_gate_m=gate, **fit)
    out["ok"] = bool(
        out["snoop"] == ref["snoop"] and ang < CHESS_POSE_GATE[0]
        and cen < CHESS_POSE_GATE[1] and len(out["rebases"]) == 1
        and abs(out["rebase"] - ref["rebase"]) <= 1
        and out["kf0_gap"] is not None and out["kf0_gap"] <= 1e-5
        and out["rot_deg_max"] < CHESS_ROT_GATE_DEG
        and fit["ate_m"] < gate)
    return out


# --- Recorded datasets: the runners' input ------------------------------------
#
# The runners (``runners.py``) read EuRoC-, KITTI- and TUM-layout datasets
# from disk. These write such datasets from the committed fixtures, with
# numpy and the port's PNG writer (no OpenCV), and their calibration files
# as OpenCV YAML 1.0 text.

# EuRoC's nanosecond stamps lie near 1.4e18 ns; a dataset's frame stamp is
# this epoch plus the fixture's stamp (float64 seconds lose 0.1-0.2 us there:
# the loaders' stamp handling is exercised).
DATASET_EPOCH_NS = 1_400_000_000_000_000_000
# TUM RGB-D's stamps are seconds near 1.3e9; its depth images are stamped
# 5 ms after the colour images (associated within the loader's 0.02 s).
TUM_EPOCH_S = 1_305_031_102.0
TUM_DEPTH_LAG_S = 0.005


def dataset_stamps_ns(stamps) -> np.ndarray:
    """Fixture stamps (s) -> the dataset's int64 ns stamps."""
    return DATASET_EPOCH_NS + np.round(np.asarray(stamps, np.float64)
                                       * 1e9).astype(np.int64)


def _yaml_value(v) -> str:
    if isinstance(v, str):
        return f'"{v}"'
    a = np.asarray(v)
    if a.ndim == 2:
        data = ", ".join(repr(float(x)) for x in a.ravel())
        return (f"!!opencv-matrix\n  rows: {a.shape[0]}\n  cols: "
                f"{a.shape[1]}\n  dt: d\n  data: [{data}]")
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def write_settings(path, entries: dict) -> str:
    """Write a calibration file (OpenCV YAML 1.0, ``File.version`` 1.0) of
    ``entries`` (key -> number, string or 2-D matrix). Returns ``path``."""
    lines = ["%YAML:1.0", "---", 'File.version: "1.0"']
    lines += [f"{k}: {_yaml_value(v)}" for k, v in entries.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def camera_entries(i: int, cam, dist=None, kb8=None) -> dict:
    """Camera{i}'s keys: fx, fy, cx, cy and radtan k1, k2, p1, p2 (or KB8
    k1..k4)."""
    out = {f"Camera{i}.{k}": float(v)
           for k, v in zip(("fx", "fy", "cx", "cy"), cam)}
    if kb8 is not None:
        out.update({f"Camera{i}.k{j + 1}": float(v)
                    for j, v in enumerate(kb8)})
    elif dist is not None:
        out.update({f"Camera{i}.{k}": float(v)
                    for k, v in zip(("k1", "k2", "p1", "p2"), dist)})
    return out


def imu_entries(T_b_c1, imu=None) -> dict:
    """The IMU block: ``IMU.T_b_c1`` and the noise of ``imu``
    (``ops.imu.ImuConfig``; its defaults when None)."""
    from .ops.imu import ImuConfig
    imu = imu if imu is not None else ImuConfig(T_bc=np.eye(4))
    return {"IMU.T_b_c1": np.asarray(T_b_c1, np.float64),
            "IMU.NoiseGyro": imu.gyro_noise, "IMU.NoiseAcc": imu.acc_noise,
            "IMU.GyroWalk": imu.gyro_walk, "IMU.AccWalk": imu.acc_walk,
            "IMU.Frequency": imu.freq}


def orb_entries(n_features: int) -> dict:
    return {"ORBextractor.nFeatures": int(n_features),
            "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 8,
            "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7}


def _write_cam(cam_dir, images, ns):
    from .io import png
    data = os.path.join(cam_dir, "data")
    os.makedirs(data, exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    for img, t in zip(images, ns):
        png.write_png(os.path.join(data, f"{int(t)}.png"),
                      np.asarray(img, np.uint8))
        rows.append(f"{int(t)},{int(t)}.png")
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_euroc_dataset(root, left, stamps, right=None, imu=None) -> np.ndarray:
    """Write an EuRoC-layout sequence under ``root``:
    ``mav0/cam0/data/<ns>.png`` and ``mav0/cam0/data.csv`` (and ``cam1``
    for ``right``), and with ``imu`` = (t, gyr, acc) ``mav0/imu0/data.csv``
    (w_xyz, a_xyz rows); stamps in ns at :data:`DATASET_EPOCH_NS`. Returns
    the frames' ns stamps."""
    ns = dataset_stamps_ns(stamps)
    _write_cam(os.path.join(root, "mav0", "cam0"), left, ns)
    if right is not None:
        _write_cam(os.path.join(root, "mav0", "cam1"), right, ns)
    if imu is not None:
        t, gyr, acc = imu
        d = os.path.join(root, "mav0", "imu0")
        os.makedirs(d, exist_ok=True)
        rows = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]"]
        for ti, g, a in zip(dataset_stamps_ns(t), np.asarray(gyr),
                            np.asarray(acc)):
            rows.append(",".join([str(int(ti))] + [repr(float(x))
                                                   for x in (*g, *a)]))
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return ns


def write_kitti_dataset(root, left, right, stamps) -> None:
    """Write a KITTI-odometry-layout sequence under ``root``: ``times.txt``
    (s) and ``image_0`` / ``image_1`` of ``%06d.png``."""
    from .io import png
    for cam, imgs in (("image_0", left), ("image_1", right)):
        os.makedirs(os.path.join(root, cam), exist_ok=True)
        for i, img in enumerate(imgs):
            png.write_png(os.path.join(root, cam, f"{i:06d}.png"),
                          np.asarray(img, np.uint8))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{float(s):.6e}\n" for s in stamps))


def write_tum_rgbd_dataset(root, rgb, depth, stamps) -> np.ndarray:
    """Write a TUM RGB-D-layout sequence under ``root``: ``rgb.txt`` and
    ``depth.txt`` (stamp and file per line, three comment lines), ``rgb/``
    (grey, 8-bit) and ``depth/`` (uint16, the fixture's depth x 5000) PNGs,
    the depth stamped :data:`TUM_DEPTH_LAG_S` after its colour image.
    Returns the colour stamps (s)."""
    from .io import png
    ts = TUM_EPOCH_S + np.asarray(stamps, np.float64)
    for sub, imgs, lag in (("rgb", rgb, 0.0), ("depth", depth,
                                               TUM_DEPTH_LAG_S)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        rows = [f"# {sub} images", "# file: fabricated",
                "# timestamp filename"]
        for img, t in zip(imgs, ts + lag):
            name = f"{sub}/{t:.6f}.png"
            png.write_png(os.path.join(root, name), np.asarray(img))
            rows.append(f"{t:.6f} {name}")
        with open(os.path.join(root, f"{sub}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return ts


# EuRoC's radtan coefficients (k1, k2, p1, p2) of cam0 and cam1 and the
# rotation of its Stereo.T_c1_c2 (configs/EuRoC_stereo_inertial.yaml).
EUROC_CAM0_RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
EUROC_CAM1_RADTAN = (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05)
EUROC_R_C1_C2 = np.array(
    [[0.999997256477797, -0.002317135723275, -0.000343393120620],
     [0.002312067192432, 0.999898048507103, -0.014090668452683],
     [0.000376008102320, 0.014089835846691, 0.999900662638081]])


class RawStereoRig(NamedTuple):
    """A raw (distorted, unrectified) stereo rig that sees a rectified
    pinhole render: camera k's image is the render turned by ``R_raw{k}``
    (raw <- render) and distorted by its radtan coefficients, so that the
    rig's Bouguet rectification gives the render's orientation back."""

    width: int
    height: int
    K1: tuple                # fx, fy, cx, cy
    dist1: tuple             # k1, k2, p1, p2
    K2: tuple
    dist2: tuple
    T_c1_c2: np.ndarray      # (4, 4) cam1 <- cam2
    T_b_c1: np.ndarray       # (4, 4) body <- cam1 (body = raw cam1)
    R_raw1: np.ndarray       # (3, 3) raw cam1 <- render left
    R_raw2: np.ndarray       # (3, 3) raw cam2 <- render right
    render: tuple            # the render's fx, fy, cx, cy
    baseline: float


def euroc_raw_rig(scale: float = 1.0) -> RawStereoRig:
    """The flagship cell's raw stereo rig: 752x480 (times ``scale``) with
    EuRoC's Camera1 and Camera2 radtan coefficients, fx = fy = 560, cx =
    376, cy = 240 (times ``scale``) on both cameras, and ``Stereo.T_c1_c2``
    with EuRoC's 0.8-degree rotation and the world's 0.2 m baseline: each
    camera turned half the rotation from the render, so that Bouguet's
    rectification (the half rotations, the baseline on x) gives back the
    fixture's rectified pair, seen at its own alpha = 0 focal length (inside
    the 640x480 render at fx = 400: :func:`raw_rig_coverage`).
    ``T_b_c1 = I``: the body is the raw left camera."""
    from .io import rectify
    R = EUROC_R_C1_C2.T                        # cam1 -> cam2
    om = rectify.rodrigues_to_vector(R)
    Ra = rectify.rodrigues_to_matrix(-0.5 * om)
    Rb = rectify.rodrigues_to_matrix(0.5 * om)
    b = 0.2
    T21 = np.eye(4)
    T21[:3, :3] = R
    T21[:3, 3] = -Rb @ np.array([b, 0.0, 0.0])
    K = (560.0 * scale, 560.0 * scale, 376.0 * scale, 240.0 * scale)
    return RawStereoRig(
        width=int(round(752 * scale)), height=int(round(480 * scale)),
        K1=K, dist1=EUROC_CAM0_RADTAN, K2=K, dist2=EUROC_CAM1_RADTAN,
        T_c1_c2=np.linalg.inv(T21), T_b_c1=np.eye(4), R_raw1=Ra, R_raw2=Rb,
        render=(400.0, 400.0, 320.0, 240.0), baseline=b)


def _kmat(cam) -> np.ndarray:
    fx, fy, cx, cy = cam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


class RawWarp:
    """render -> raw: each raw pixel's ray (OpenCV's radtan undistortion,
    iterated to convergence), turned by ``R_raw^T`` into the render's frame
    and projected through the render's pinhole; the render sampled
    bilinearly there (numpy), ``background`` where the ray leaves it. The
    map is built once; ``__call__`` warps a uint8 render."""

    def __init__(self, raw_cam, dist, R_raw, render_cam, raw_hw,
                 render_hw, background: int = EUROC_PAD_VALUE):
        from .io import rectify
        h, w = raw_hw
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        xy = rectify.undistort_points(np.stack([u, v], -1).reshape(-1, 2),
                                      _kmat(raw_cam), np.asarray(dist),
                                      iters=60)
        ray = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ np.asarray(
            R_raw, np.float64)           # rows: R_raw^T ray
        fx, fy, cx, cy = render_cam
        x = (fx * ray[:, 0] / ray[:, 2] + cx).reshape(h, w)
        y = (fy * ray[:, 1] / ray[:, 2] + cy).reshape(h, w)
        rh, rw = render_hw
        x0, y0 = np.floor(x), np.floor(y)
        self.inside = ((x0 >= 0) & (y0 >= 0) & (x0 <= rw - 2)
                       & (y0 <= rh - 2) & (ray[:, 2].reshape(h, w) > 0))
        self.xi = np.clip(x0, 0, rw - 2).astype(np.int64)
        self.yi = np.clip(y0, 0, rh - 2).astype(np.int64)
        self.ax, self.ay = x - x0, y - y0
        self.background = float(background)

    def __call__(self, img) -> np.ndarray:
        src = np.asarray(img, np.float64)
        xi, yi, ax, ay = self.xi, self.yi, self.ax, self.ay
        val = ((1 - ay) * ((1 - ax) * src[yi, xi] + ax * src[yi, xi + 1])
               + ay * ((1 - ax) * src[yi + 1, xi] + ax * src[yi + 1, xi + 1]))
        out = np.where(self.inside, val, self.background)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def raw_rig_settings(rig: RawStereoRig) -> dict:
    """The rig's calibration entries (Camera1/2, size, Stereo.T_c1_c2)."""
    out = {"Camera.type": "PinHole"}
    out.update(camera_entries(1, rig.K1, rig.dist1))
    out.update(camera_entries(2, rig.K2, rig.dist2))
    out.update({"Camera.width": rig.width, "Camera.height": rig.height,
                "Stereo.T_c1_c2": rig.T_c1_c2})
    return out


def raw_rig_rectification(rig: RawStereoRig):
    """The port's rectification of ``rig`` (``io.rectify``), built from
    its calibration entries as the runner reads them."""
    from .io import rectify
    from .io.settings import CameraSettings

    def cam(K, d):
        return CameraSettings("PinHole", np.array(K, np.float32),
                              np.array(d, np.float32), rig.width, rig.height)

    return rectify.build_rectification(cam(rig.K1, rig.dist1),
                                       cam(rig.K2, rig.dist2), rig.T_c1_c2)


def raw_rig_coverage(rig: RawStereoRig, rect=None) -> float:
    """The least margin, in render pixels, between the rectified left view
    (alpha = 0) and the render's border: the rectified camera has the
    render's orientation, so its corners map into the render through the
    two pinholes. Positive: the view lies inside the render."""
    rect = rect if rect is not None else raw_rig_rectification(rig)
    fx, fy, cx, cy = rig.render
    xs = (np.array([0.0, rig.width - 1]) - rect.cx) / rect.fx * fx + cx
    ys = (np.array([0.0, rig.height - 1]) - rect.cy) / rect.fy * fy + cy
    return float(min(xs.min(), ys.min(), 639 - xs.max(), 479 - ys.max()))


def half_scale(frames) -> np.ndarray:
    """(F, H, W) uint8 frames at half size (2 x 2 means, rounded): the CPU
    tests' small datasets. A pinhole's fx, fy halve and its centre moves to
    ((c + 0.5) / 2 - 0.5)."""
    f = np.asarray(frames, np.float64)
    h, w = f.shape[1] // 2 * 2, f.shape[2] // 2 * 2
    f = f[:, :h, :w].reshape(f.shape[0], h // 2, 2, w // 2, 2).mean((2, 4))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def _half_cam(cam):
    fx, fy, cx, cy = (float(c) for c in cam[:4])
    return (fx / 2, fy / 2, (cx + 0.5) / 2 - 0.5, (cy + 0.5) / 2 - 0.5)


class RunnerDataset(NamedTuple):
    """A fabricated dataset and how its runner is called: ``main(argv)``
    of ``runners`` with ``argv`` (the settings file and the sequence
    first; the caller adds ``--device``); the truth of the tracked camera
    (``stamps`` in the dataset's seconds, as its loader reads them; ``R`` / ``t`` world -> camera,
    ``centres``, ``vel`` where there is an IMU) and the runner's
    preprocessing (``rig``: the port's rectification; ``clahe``)."""

    kind: str
    main: str
    argv: list
    settings: str
    sequence: str
    n_frames: int
    stamps: np.ndarray
    R: np.ndarray
    t: np.ndarray
    centres: np.ndarray
    vel: np.ndarray | None
    rig: object
    clahe: bool
    outputs: tuple


RUNNER_KINDS = ("euroc_stereo_inertial", "euroc_mono", "euroc_mono_inertial",
                "kitti", "tum_rgbd", "tumvi")
# The runners' entry points (``runners.main_*``) and the files each writes
# (the JAX runner's: ``{}`` is ``--output-name``).
RUNNER_MAIN = {"euroc_stereo_inertial": "main_euroc_stereo_inertial",
               "euroc_mono": "main_euroc_mono",
               "euroc_mono_inertial": "main_euroc_mono_inertial",
               "kitti": "main_kitti", "tum_rgbd": "main_tum_rgbd",
               "tumvi": "main_tumvi"}
RUNNER_OUTPUTS = {"kitti": ("{}_kitti.txt", "f_{}.txt"),
                  "tum_rgbd": ("f_{}.txt", "kf_{}.txt")}
RUNNER_DEFAULT_OUTPUTS = ("f_{}.txt", "kf_{}.txt", "ExecTimeMean.txt")
# The phase-19 (p) cells' frames (at most 10) and the flagship's 40.
RUNNER_FRAMES = {"euroc_stereo_inertial": 40, "euroc_mono": 10,
                 "euroc_mono_inertial": 10, "kitti": 10, "tum_rgbd": 10,
                 "tumvi": 10}


def _truth(g, n, stamps):
    vel = getattr(g, "vel", None)
    return dict(stamps=np.asarray(stamps, np.float64)[:n],
                R=np.asarray(g.R)[:n], t=np.asarray(g.t)[:n],
                centres=np.asarray(g.centres)[:n],
                vel=None if vel is None else np.asarray(vel)[:n])


def write_runner_dataset(kind: str, root, n_frames: int | None = None,
                         small: bool = False, name: str = "run") -> RunnerDataset:
    """Fabricate the dataset of one runner under ``root`` from the committed
    fixtures and write its calibration file; ``small``: at half size (the
    CPU tests). Kinds (:data:`RUNNER_KINDS`):

    * ``euroc_stereo_inertial``: cell (d)'s pairs through
      :func:`euroc_raw_rig` (render -> raw: a rotation homography and
      EuRoC's radtan), the 200 Hz IMU rotated into the raw left camera's
      frame (the body, ``T_b_c1 = I``); EuRoC's IMU noise, 1200 features,
      ThDepth 60, the world's 10 fps; the runner with ``--no-vocabulary``;
    * ``euroc_mono``: the golden frames through EuRoC cam0's radtan (the
      world's pinhole, 640x480; the background where a raw pixel's ray
      leaves the render, in the corners), 1536 features,
      ``--min-init-matches 60`` (the world's, verify SKILL);
    * ``euroc_mono_inertial``: cell (e)'s frames and IMU, 1536 features,
      ``--clahe --min-init-matches 60``;
    * ``kitti``: cell (a)'s pairs cut as cell (b)'s (1241x376, cy 188, bf
      80), 2000 features (small: 1000), ``--stereo``;
    * ``tum_rgbd``: cell (c)'s left frames and 16-bit depth at factor 5000,
      1000 features, bf 40, ThDepth 40;
    * ``tumvi``: cell (h)'s KB8 pairs (512x512, TUM-VI's KB8 coefficients at
      fx = fy = 400) with the IMU, 1000 features, CLAHE on, ``--stereo``.

    Every runner but KITTI's and TUM RGB-D's takes ``--no-vocabulary`` (as
    the cells run), and ``--max-frames`` the frames written."""
    os.makedirs(root, exist_ok=True)
    seq = os.path.join(root, "sequence")
    yaml = os.path.join(root, "settings.yaml")
    n_cap = RUNNER_FRAMES[kind] if n_frames is None else n_frames
    scale = 0.5 if small else 1.0
    rig, clahe, extra = None, False, ["--no-vocabulary"]
    if kind == "euroc_stereo_inertial":
        g = vi_stereo_frames()
        n = min(n_cap, len(g.stamps))
        r = euroc_raw_rig(scale)
        hw = (r.height, r.width)
        w1 = RawWarp(r.K1, r.dist1, r.R_raw1, r.render, hw, (480, 640))
        w2 = RawWarp(r.K2, r.dist2, r.R_raw2, r.render, hw, (480, 640))
        left = np.stack([w1(im) for im in g.left[:n]])
        right = np.stack([w2(im) for im in g.right[:n]])
        lo, hi = g.imu_start[0], g.imu_start[n]
        Rb = r.T_b_c1[:3, :3] @ r.R_raw1       # body <- render
        imu = (g.imu_t[lo:hi], (g.imu_gyr[lo:hi].astype(np.float64) @ Rb.T),
               (g.imu_acc[lo:hi].astype(np.float64) @ Rb.T))
        write_euroc_dataset(seq, left, g.stamps[:n], right, imu)
        entries = raw_rig_settings(r)
        entries.update({"Camera.fps": 10, "Camera.RGB": 1,
                        "Stereo.ThDepth": 60.0})
        entries.update(imu_entries(r.T_b_c1, EUROC_STEREO_INERTIAL.imu))
        entries.update(orb_entries(1200))
        rig = raw_rig_rectification(r)
        truth = _truth(g, n, dataset_stamps_ns(g.stamps) * 1e-9)
    elif kind in ("euroc_mono", "euroc_mono_inertial"):
        mono = kind == "euroc_mono"
        g = golden_frames() if mono else vi_mono_frames()
        frames = g.frames if mono else g.left
        n = min(n_cap, len(g.stamps))
        cam = tuple(float(c) for c in g.camera[:4])
        if mono:
            raw = cam
            warp = RawWarp(raw, EUROC_CAM0_RADTAN, np.eye(3), cam, (480, 640),
                           (480, 640))
            imgs = np.stack([warp(im) for im in frames[:n]])
            dist = EUROC_CAM0_RADTAN
        else:
            raw, imgs, dist = cam, np.asarray(frames[:n]), None
        if small:
            imgs, raw = half_scale(imgs), _half_cam(raw)
        imu = None
        if not mono:
            lo, hi = g.imu_start[0], g.imu_start[n]
            imu = (g.imu_t[lo:hi], g.imu_gyr[lo:hi], g.imu_acc[lo:hi])
        write_euroc_dataset(seq, imgs, g.stamps[:n], imu=imu)
        entries = {"Camera.type": "PinHole"}
        entries.update(camera_entries(1, raw, dist))
        entries.update({"Camera.width": imgs.shape[2],
                        "Camera.height": imgs.shape[1], "Camera.fps": 10,
                        "Camera.RGB": 1})
        if not mono:
            entries.update(imu_entries(np.eye(4)))
            clahe = True
        entries.update(orb_entries(1536))
        extra += ["--min-init-matches", "60"] + ([] if mono else ["--clahe"])
        truth = _truth(g, n, dataset_stamps_ns(g.stamps) * 1e-9)
    elif kind in ("kitti", "tum_rgbd"):
        g = stereo_frames()
        n = min(n_cap, len(g.stamps))
        cam = (400.0, 400.0, 320.0, 240.0)
        extra = []
        if kind == "kitti":
            left, right = kitti_frames(g.left[:n]), kitti_frames(g.right[:n])
            cam = (400.0, 400.0, 320.0, 240.0 - KITTI_CROP_TOP)
            bf, feats = 80.0, 2000
            if small:
                left, right = half_scale(left), half_scale(right)
                cam, bf, feats = _half_cam(cam), 40.0, 1000
            write_kitti_dataset(seq, left, right, g.stamps[:n])
            hw = left.shape[1:]
            extra = ["--stereo", "--no-vocabulary"]
            stamps = g.stamps
        else:
            left, depth = g.left[:n], g.depth[:n]
            bf, feats = 40.0, 1000
            if small:
                left, depth = half_scale(left), depth[:, ::2, ::2]
                cam = _half_cam(cam)
            stamps = write_tum_rgbd_dataset(seq, left, depth, g.stamps[:n])
            hw = left.shape[1:]
            extra = ["--no-vocabulary"]
        entries = {"Camera.type": "PinHole"}
        entries.update(camera_entries(1, cam))
        entries.update({"Camera.width": hw[1], "Camera.height": hw[0],
                        "Camera.fps": 10, "Camera.RGB": 1, "Camera.bf": bf,
                        "Stereo.ThDepth": 35.0 if kind == "kitti" else 40.0})
        if kind == "tum_rgbd":
            entries["RGBD.DepthMapFactor"] = 5000.0
        entries.update(orb_entries(feats))
        truth = _truth(g, n, stamps)
    elif kind == "tumvi":
        g = vi_stereo_frames()
        n = min(n_cap, len(g.stamps))
        c = tuple(float(x) for x in g.camera[:4])
        size = 256 if small else 512
        k = size / 512.0
        world = tuple(v * k if i < 2 else (v + 0.5) * k - 0.5
                      for i, v in enumerate(TUMVI_WORLD_CAM))
        left = np.stack([kb8_warp(im, c, world + TUMVI_KB8_1, (size, size))
                         for im in g.left[:n]])
        right = np.stack([kb8_warp(im, c, world + TUMVI_KB8_2, (size, size))
                          for im in g.right[:n]])
        lo, hi = g.imu_start[0], g.imu_start[n]
        write_euroc_dataset(seq, left, g.stamps[:n], right,
                            (g.imu_t[lo:hi], g.imu_gyr[lo:hi],
                             g.imu_acc[lo:hi]))
        entries = {"Camera.type": "KannalaBrandt8"}
        entries.update(camera_entries(1, world, kb8=TUMVI_KB8_1))
        entries.update(camera_entries(2, world, kb8=TUMVI_KB8_2))
        T_lr = np.eye(4)[:3]
        T_lr[0, 3] = 0.2                 # x_c1 = T_lr x_c2: the right 0.2 m on x
        entries.update({"Camera.width": size, "Camera.height": size,
                        "Camera.fps": 10, "Camera.RGB": 1,
                        "Stereo.ThDepth": 35.0, "Stereo.Tlr": T_lr})
        entries.update(imu_entries(np.eye(4)))
        entries.update(orb_entries(1000))
        extra += ["--stereo"]
        clahe = True
        truth = _truth(g, n, dataset_stamps_ns(g.stamps) * 1e-9)
    else:
        raise ValueError(f"unknown runner kind {kind!r}")
    write_settings(yaml, entries)
    outputs = tuple(o.format(name) for o in RUNNER_OUTPUTS.get(
        kind, RUNNER_DEFAULT_OUTPUTS))
    argv = [yaml, seq, "--output-name", name, "--max-frames", str(n)] + extra
    return RunnerDataset(kind=kind, main=RUNNER_MAIN[kind], argv=argv,
                         settings=yaml, sequence=seq, n_frames=n, rig=rig,
                         clahe=clahe, outputs=outputs, **truth)


def runner_gates(d: RunnerDataset, stamps, centres, v_est=None,
                 jax_ate_m: float | None = None) -> dict:
    """A runner's trajectory (``stamps`` in the dataset's seconds, the
    camera ``centres``, as its ``f_`` file holds them) against the
    dataset's truth: the frames, the ATE without scale alignment and after
    Horn's scale fit, and with ``v_est`` (the last body velocity) the
    speed error at the last frame. ``ok``: the stereo-inertial cells'
    gates (:data:`VI_STEREO_MIN_FRAMES` frames, the ATE under
    :data:`VI_STEREO_ATE_GATE_M` and, with ``jax_ate_m``, under 1.5 x it +
    2 mm, the speed within :data:`VI_SPEED_TOL_MPS`)."""
    from .utils import evaluate
    stamps = np.asarray(stamps, np.float64)
    centres = np.asarray(centres, np.float64)
    out = {"frames": int(len(stamps))}
    if len(stamps) < 3:
        return dict(out, ok=False)
    idx = np.array([int(np.argmin(np.abs(d.stamps - s))) for s in stamps])
    gt = d.centres[idx]
    _, _, _, ate = evaluate.horn_align(centres, gt, with_scale=False)
    s, _, _, ate_s = evaluate.horn_align(centres, gt, with_scale=True)
    out.update(ate_m=float(ate), ate_scaled_m=float(ate_s), scale=float(s),
               first_frame=int(idx[0]))
    ok = len(stamps) >= VI_STEREO_MIN_FRAMES and ate < VI_STEREO_ATE_GATE_M
    if jax_ate_m is not None:
        out["ate_gate_m"] = 1.5 * jax_ate_m + 0.002
        ok = ok and ate < out["ate_gate_m"]
    if v_est is not None and d.vel is not None:
        out["speed_err_mps"] = float(abs(
            np.linalg.norm(np.asarray(v_est, np.float64))
            - np.linalg.norm(d.vel[idx[-1]])))
        ok = ok and out["speed_err_mps"] < VI_SPEED_TOL_MPS
    out["ok"] = bool(ok)
    return out


# The JAX package's stereo-inertial runner (``scripts/run_euroc_stereo_
# inertial.py --no-vocabulary``, unedited) on the fabricated flagship
# dataset (``write_runner_dataset("euroc_stereo_inertial")``), on the CPU
# with the map cut to 48 keyframe / 4096 landmark slots
# (``scripts/runner_reference_jax.py``): 40 frames tracked, imu_ready, 12
# keyframes; the ATE without scale alignment of its ``f_`` file. The port's
# runner is held under 1.5 x it + 0.002 m (and the cells' 0.15 m).
RUNNER_JAX = dict(frames=40, ate_m=0.010873913817110692,
                  ate_scaled_m=0.009554504617726393, keyframes=12,
                  slots=(48, 4096))
RUNNER_JAX_ATE_GATE_M = 1.5 * RUNNER_JAX["ate_m"] + 0.002
# The frame on which each phase-19 (p) runner's system initialises on its
# full-size dataset, by the runner on the CPU (1024 / 65536 slots cut to 48
# / 8192: the init does not depend on them); None: no frame of the 10
# initialises. EuRoC mono's two-view init lands on frame 4 (the golden
# frames' own: frame 2; the radtan warp's background corners cost two);
# mono-inertial with CLAHE on none of 16 frames (cell (e) without CLAHE on
# frame 10); TUM-VI at its runner's default init gates (300 depth points)
# on none (cell (h)'s world gives 84-153 a frame). The stereo and RGB-D
# inits are one-frame and deterministic; the two-view init's RANSAC draws
# its samples from the device's generator, whose stream on the card is not
# the CPU's, so there the frame may differ (``RUNNER_TWO_VIEW``).
RUNNER_INIT_FRAMES = {"euroc_mono": 4, "euroc_mono_inertial": None,
                      "kitti": 0, "tum_rgbd": 0, "tumvi": None}
RUNNER_TWO_VIEW = ("euroc_mono", "euroc_mono_inertial")


# --- Multi-device ------------------------------------------------------------

def make_tiny_map_state(n_kf: int = 6, n_lm: int = 64, max_obs: int = 4,
                        stereo_bf: float = 80.0, device=None):
    """The JAX package's ``graft.make_tiny_map_state`` (the same numpy
    draws, so the same map): a small consistent map, ``n_kf`` keyframes
    along x each observing every landmark with its stereo row (keypoint
    ``l`` of each keyframe is landmark ``l``'s), for driving the production
    global BA through a device mesh. Returns (state, cam_params,
    stereo_bf) on ``device``."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(0)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    cam_params = np.array([fx, fy, cx, cy], np.float32)
    X = np.stack([rng.uniform(-2, 2, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 8, n_lm)], -1).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    ts = np.stack([np.array([-0.3 * k, 0.02 * k, 0], np.float32)
                   for k in range(n_kf)])
    kp_xy = np.zeros((n_kf, n_lm, 2), np.float32)
    kp_ur = np.full((n_kf, n_lm), -1.0, np.float32)
    for k in range(n_kf):
        pc = X @ Rs[k].T + ts[k]
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, 0.5, n_lm)
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, 0.5, n_lm)
        kp_xy[k] = np.stack([u, v], -1)
        kp_ur[k] = u - stereo_bf / pc[:, 2]
    n_seen = min(n_kf, max_obs)
    obs_kf = np.full((n_lm, max_obs), -1, np.int32)
    obs_kf[:, :n_seen] = np.arange(n_seen, dtype=np.int32)
    obs_kp = np.full((n_lm, max_obs), -1, np.int32)
    obs_kp[:, :n_seen] = np.arange(n_lm, dtype=np.int32)[:, None]
    pos = X + rng.normal(0, 0.01, X.shape).astype(np.float32)
    state = ms.empty_map(n_kf, n_lm, max_obs, n_lm, device=dev)
    up = lambda a: device_mod.upload(a, dev)  # noqa: E731
    kfs = state.kfs._replace(
        R=up(Rs), t=up(ts), kp_xy=up(kp_xy), kp_ur=up(kp_ur),
        kp_valid=torch.ones((n_kf, n_lm), dtype=torch.bool, device=dev),
        valid=torch.ones((n_kf,), dtype=torch.bool, device=dev))
    lms = state.lms._replace(
        pos=up(pos),
        n_obs=torch.full((n_lm,), n_seen, dtype=torch.int32, device=dev),
        valid=torch.ones((n_lm,), dtype=torch.bool, device=dev))
    obs = state.obs._replace(kf=up(obs_kf), kp=up(obs_kp),
                             valid=up(obs_kf >= 0))
    return (ms.MapState(kfs=kfs, lms=lms, obs=obs), up(cam_params),
            stereo_bf)


def dryrun_multichip(n_shards: int, devices=None):
    """The port's ``__graft_entry__.dryrun_multichip``: the map refinement
    through the production entry points over an ``n_shards`` mesh, once on
    a tiny map. ``mapping.global_ba(..., mesh=)`` (the call the systems
    make after a loop closure or a merge) runs the landmark-sharded BA with
    stereo rows, then the edge-sharded pose graph (``dist_posegraph``)
    runs 2 iterations over the refined keyframes' chain. ``devices``:
    the mesh's devices (default: the cards in turn, repeated up to
    ``n_shards``). Raises on a non-finite result; returns (the refined
    state, the pose graph's result)."""
    from .parallel import dist_ba, dist_posegraph
    from .solver import pose_graph

    if devices is None:
        n = torch.cuda.device_count()
        device_mod.resolve(None)
        devices = [f"cuda:{i % n}" for i in range(n_shards)]
    mesh = dist_ba.make_mesh(n_shards, devices)
    n_lm = max(64, n_shards * 16)
    state, cam_params, bf = make_tiny_map_state(n_kf=6, n_lm=n_lm,
                                                device=mesh.devices[0])
    state2 = mapping.global_ba(state, cam_params, use_stereo=True, bf=bf,
                               mesh=mesh)
    finite = torch.stack([torch.isfinite(state2.kfs.R).all(),
                          torch.isfinite(state2.lms.pos).all()])
    if not bool(finite.all()):
        raise RuntimeError("dryrun_multichip: the sharded global BA is not "
                           "finite")
    kfs = state2.kfs
    n_kf = kfs.R.shape[0]
    dev = kfs.R.device
    ei = torch.arange(1, n_kf, dtype=torch.int32, device=dev)
    ej = ei - 1
    mR = torch.einsum("kij,klj->kil", kfs.R[1:], kfs.R[:-1])
    mt = kfs.t[1:] - torch.einsum("kij,kj->ki", mR, kfs.t[:-1])
    ones = torch.ones(n_kf - 1, device=dev)
    padded = dist_posegraph.pad_edges(ei, ej, mR, mt, ones, ones, n_shards)
    fixed = torch.arange(n_kf, device=dev) == 0
    res = dist_posegraph.dist_optimize_pose_graph(
        kfs.R, kfs.t, torch.ones(n_kf, device=dev), *padded, fixed,
        pose_graph.DOF_SE3, mesh=mesh, n_iters=2)
    if not float(res.cost) >= 0.0:
        raise RuntimeError(f"dryrun_multichip: pose-graph cost {res.cost}")
    return state2, res


# --- Native KB8 pose optimization (K3 and K3s with model_id KB8) -------------

# TUM-VI 512's left camera (configs/TUM-VI_512_stereo_inertial.yaml; the
# KB8 study's, tests/test_kb8_ab.py, to 8 digits): fx, fy, cx, cy, k0..k3
# in float32.
TUMVI_KB8_PARAMS = np.array(TUMVI_CAM1 + TUMVI_KB8_1, np.float32)


def kb8_scene(rng, n_pts: int = 256, max_angle_deg: float = 85.0):
    """``tests/test_kb8_ab.make_scene`` (the same draws): points spread out
    to ``max_angle_deg`` of field angle at 2-8 m, and the true pose.
    Returns (pw, pc, R, t), float32."""
    ang = np.deg2rad(rng.uniform(0, max_angle_deg, n_pts))
    psi = rng.uniform(0, 2 * np.pi, n_pts)
    depth = rng.uniform(2.0, 8.0, n_pts)
    d = np.stack([np.sin(ang) * np.cos(psi), np.sin(ang) * np.sin(psi),
                  np.cos(ang)], -1)
    pc = d * depth[:, None]
    R = _rodrigues(rng.normal(0, 0.03, 3))
    t = rng.normal(0, 0.05, 3)
    pw = (pc - t) @ R
    return (pw.astype(np.float32), pc.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def kb8_ab_study(rng, noise_px: float = 0.5, n_trials: int = 24,
                 max_angle_deg: float = 85.0, device=None) -> dict:
    """``tests/test_kb8_ab.run_ab`` on the port: per trial a
    :func:`kb8_scene`, isotropic noise in the raw fisheye pixels, and the
    motion-only pose from a perturbed start (A) on the observations
    rectified onto the virtual pinhole (the camera's fx, fy, cx, cy) and
    (B) natively on the raw ones with the KB8 camera
    (:data:`TUMVI_KB8_PARAMS`; K3 with model_id KB8 on the card: one launch
    a trial). Returns each trial's translations and errors against the
    truth, and the medians the study gates."""
    from .solver import pose_opt

    dev = device_mod.resolve(device)
    up = lambda a: device_mod.upload(np.asarray(a), dev)  # noqa: E731
    kb8 = up(TUMVI_KB8_PARAMS)
    pin = up(TUMVI_KB8_PARAMS[:4])
    t_rect, t_nat, e_rect, e_nat = [], [], [], []
    for _ in range(n_trials):
        pw, pc, R, t = kb8_scene(rng, max_angle_deg=max_angle_deg)
        uv = convert.to_numpy(cam.kb8_project(kb8, up(pc)))
        uv = (uv + rng.normal(0, noise_px, uv.shape)).astype(np.float32)
        ray = cam.kb8_unproject(kb8, up(uv))
        uv_rect = cam.pinhole_project(pin, ray)
        R0 = (_rodrigues(rng.normal(0, 0.02, 3)) @ R).astype(np.float32)
        t0 = (t + rng.normal(0, 0.05, 3)).astype(np.float32)
        valid = torch.ones(pw.shape[0], dtype=torch.bool, device=dev)
        w = torch.ones(pw.shape[0], device=dev)
        res_a = pose_opt.pose_optimization(
            up(R0), up(t0), up(pw), uv_rect, w, valid, pin,
            model_id=cam.PINHOLE)
        res_b = pose_opt.pose_optimization(
            up(R0), up(t0), up(pw), up(uv), w, valid, kb8,
            model_id=cam.KB8)
        ta, tb = (convert.to_numpy(x) for x in (res_a.t, res_b.t))
        t_rect.append(ta)
        t_nat.append(tb)
        e_rect.append(float(np.linalg.norm(ta - t)))
        e_nat.append(float(np.linalg.norm(tb - t)))
    return dict(t_rect=t_rect, t_native=t_nat, err_rect=e_rect,
                err_native=e_nat, med_rect=float(np.median(e_rect)),
                med_native=float(np.median(e_nat)))


def kb8_ab_gates(wide: dict, moderate: dict) -> dict:
    """``tests/test_kb8_ab.py``'s gates (:87-101): at 85 degrees both
    solve the pose (native < 0.02 m, rectified < 0.03 m) and the native
    residuals are no worse than 2 x the rectified + 1 mm; at 50 degrees the
    two agree within half the native error (1 mm at least)."""
    a, b = wide["med_rect"], wide["med_native"]
    c, d = moderate["med_rect"], moderate["med_native"]
    out = dict(wide_native_ok=b < 0.02, wide_rect_ok=a < 0.03,
               wide_ratio_ok=a < 2.0 * b + 1e-3,
               moderate_ok=abs(c - d) < 0.5 * max(d, 1e-3))
    out["ok"] = all(out.values())
    return out


def kb8_pose_problem(n_pts: int = 1000, stereo: bool = False,
                     seed: int = 0) -> tuple:
    """A motion-only pose problem for K3 (or K3s with ``stereo``) with
    TUM-VI 512's KB8 camera: :func:`kb8_scene`'s points out to 85 degrees,
    pyramid levels 0-7 with their noise (0.7 px x 1.2^level), 10 %
    outliers (20-60 px off), 5 % invalid rows, a start 0.02 rad / 5 cm
    off; with ``stereo``, 40 % of the rows carry the right-image u =
    u - bf / z (TUM-VI's bf) with 0.7 px of noise. Returns the kernel's
    arguments as numpy arrays: (R0, t0, pts, uv, inv_s2, valid, cam) or
    (R0, t0, pts, uv, ur, bf, inv_s2, valid, cam)."""
    rng = np.random.default_rng(seed)
    pw, pc, R, t = kb8_scene(rng, n_pts, 85.0)
    params = torch.from_numpy(TUMVI_KB8_PARAMS)
    uv = cam.kb8_project(params, torch.from_numpy(pc)).numpy().astype(
        np.float64)
    level = rng.integers(0, 8, n_pts)
    sigma = 0.7 * 1.2 ** level
    uv += rng.normal(0, 1.0, uv.shape) * sigma[:, None]
    out = rng.random(n_pts) < 0.1
    uv[out] += rng.uniform(20, 60, (int(out.sum()), 2)) * rng.choice(
        [-1, 1], (int(out.sum()), 2))
    valid = rng.random(n_pts) >= 0.05
    inv_s2 = (1.0 / 1.2 ** (2 * level)).astype(np.float32)
    R0 = (_rodrigues(rng.normal(0, 0.02, 3)) @ R).astype(np.float32)
    t0 = (t + rng.normal(0, 0.05, 3)).astype(np.float32)
    uv = uv.astype(np.float32)
    if not stereo:
        return R0, t0, pw, uv, inv_s2, valid, TUMVI_KB8_PARAMS.copy()
    bf = TUMVI_512_STEREO_INERTIAL.rig.bf
    ur = np.where(rng.random(n_pts) < 0.4,
                  uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.7, n_pts),
                  -1.0).astype(np.float32)
    return (R0, t0, pw, uv, ur, float(bf), inv_s2, valid,
            TUMVI_KB8_PARAMS.copy())
