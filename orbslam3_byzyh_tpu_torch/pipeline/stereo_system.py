"""The rectified stereo and RGB-D systems.

Port of the JAX package's ``pipeline/stereo_system.py`` ``StereoSlam`` and
``RgbdSlam`` (ORB-SLAM3's ``System::TrackStereo`` / ``TrackRGBD``): the
monocular system's frame loop with metric depth. The map starts from one
frame (``Tracking::StereoInitialization``: the keypoints with a depth are
back-projected); each keyframe back-projects its close keypoints that no
landmark holds (``CreateNewKeyFrame``'s stereo branch); the final pose
optimization of every tracked frame adds a stereo row where a keypoint has
a right-image u (K3s), and the keyframe bundle's local BA does the same.
The keyframe rule adds the close-point deficit (c1c) and the stereo ratio
0.75. An RGB-D frame samples its depth image at the keypoints and makes a
virtual right-image u = u - bf / depth (``Frame::ComputeStereoFromRGBD``).

Each frame runs ``graft.stereo_extract`` (K1 twice, the plain stereo
match) or, for RGB-D, ``graft.mono_extract`` (K1) and the depth lookup,
then the monocular system's steps with the stereo rows. The host reads of
the JAX system, one ``device.read`` each: the stereo initialisation's
(the count of keypoints with a depth, the new landmarks' count and slot
high-water mark), a tracked frame's (``info``), and a keyframe's
depth-landmark read (count and high-water mark), which waits for the
keyframe's bundle as the JAX system's does.

One intended difference from the JAX package: when the map is full and the
monocular keyframe step makes no keyframe, the JAX ``StereoSlam`` still
back-projects the frame's depths with the previous keyframe's pose and
keypoints (``stereo_system.py:215-224``); here it makes no landmark.

``FisheyeStereoSlam`` (``FisheyeStereoConfig``) is the non-rectified rig
(TUM-VI's Kannala-Brandt pair, ``Frame::ComputeStereoFishEyeMatches``):
``graft.fisheye_stereo_extract`` (K1 twice, each camera's keypoints
rectified onto its virtual pinhole, K2's none mode over both frames'
descriptors, the DLT) gives each left keypoint a depth, and the frame loop
is the stereo one. As in the JAX class, the right-image u stays None: the
frames and the bundles use mono rows over the depth-made landmarks (K3,
not K3s).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from .. import graft
from ..models import map_state as ms
from . import mapping
from . import system as base
from . import tracking


@dataclasses.dataclass
class StereoConfig(base.SlamConfig):
    bf: float = 40.0            # baseline x fx (Camera.bf)
    th_depth: float = 35.0      # close/far threshold factor (ThDepth)
    min_z: float = 0.3
    # The one-frame metric init's gates (StereoInitialization wants 500
    # depth points; scaled down for low-texture rigs).
    min_init_depth_points: int = 300
    min_init_landmarks: int = 100

    @property
    def depth_threshold(self) -> float:
        """The close-point depth: bf / fx x ThDepth."""
        return self.bf / self.fx * self.th_depth


@dataclasses.dataclass
class FisheyeStereoConfig(StereoConfig):
    """A non-rectified stereo rig with a model per camera (TUM-VI's 512x512
    Kannala-Brandt pair). The left camera is the config's own (``kb8``,
    ``dist``); ``None`` for the right camera's ``kb8_2`` / ``dist2`` takes
    the left camera's, as the JAX ``MonoSlam._extract``'s overrides do
    (``graft.fisheye_rig_tensors``)."""
    cam2: np.ndarray = None       # (4,) right [fx fy cx cy]
    kb8_2: np.ndarray = None      # (4,) right KB8 coeffs (None: the left's)
    dist2: np.ndarray = None      # right radtan (None: the left's)
    R_rl: np.ndarray = None       # left-cam -> right-cam rotation
    t_rl: np.ndarray = None       # left-cam -> right-cam translation


@dataclasses.dataclass
class RgbdConfig(StereoConfig):
    depth_scale: float = 1.0    # DepthMapFactor


class StereoSlam(base.MonoSlam):
    """Rectified stereo SLAM (System::TrackStereo) on ``device`` (``None``:
    the card; raises without one)."""

    def __init__(self, config: StereoConfig, device=None):
        super().__init__(config, device)
        self.rig = graft.rig_config(config)
        if self.loop_closer is not None:
            # Metric depth fixes the scale: loop closures solve SE3.
            self.loop_closer.cfg.fix_scale = True

    def _upload(self, img) -> torch.Tensor:
        """A frame as float32 on the device (uploaded as it is)."""
        return device_mod.upload(img, self.device).to(
            torch.float32)

    def track(self, img_left: np.ndarray, img_right: np.ndarray,
              stamp: float):
        """Process one rectified pair; returns Tcw (R, t) as numpy, or None
        while initializing."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        feats, _, m = graft.stereo_extract(
            self._upload(img_left), self._upload(img_right), self.cam_params,
            self.dist, self.rig, **self._stage_kwargs())
        self._depth, self._ur = m.depth, m.u_right      # -1 where none
        return self._track_with_depth(feats, stamp)

    # ------------------------------------------------------------------
    def _ba_kwargs(self) -> dict:
        if self._ur is None:
            return {}
        return dict(use_stereo=True, bf=float(self.cfg.bf))

    def _track_local_map(self, res, feats):
        """The local-map track with the stereo rows in its final pose
        optimization (the reference-keyframe fallback's second half)."""
        if self._ur is None:
            return super()._track_local_map(res, feats)
        lms, obs = self.state.lms, self.state.obs
        return tracking.track_local_map_windowed(
            res.R, res.t, res.bindings, lms.pos, lms.desc, lms.normal,
            lms.min_dist, lms.max_dist, lms.valid, obs.kf, obs.valid,
            self.n_kf, feats.xy, feats.level, feats.desc, feats.valid,
            self._ur, float(self.cfg.bf), self.cam_params, self.cfg.width,
            self.cfg.height, use_stereo=True, **self._window_kwargs())

    def _need_new_keyframe(self, n_inliers: int,
                           ref_matches: int | None = None) -> bool:
        """NeedNewKeyFrame's stereo / RGB-D rules (Tracking.cc:4440-4514):
        the close-point deficit c1c (fewer than 100 tracked close points
        while more than 70 could be created forces a keyframe) and the
        reference ratio 0.75."""
        if not self._kf_slot_available():
            return False
        if ref_matches is None:
            ref_matches = self._ref_kf_matches()
        n_tracked_close, n_untracked_close = self._close_counts
        need_close = n_tracked_close < 100 and n_untracked_close > 70
        c1a = self.frames_since_kf >= self.max_frames
        c1b = self.frames_since_kf >= self.cfg.min_frames
        c1c = n_inliers < ref_matches * 0.25 or need_close
        c2 = (n_inliers < ref_matches * 0.75 or need_close) and n_inliers > 15
        return (c1a or (c1b and c2) or c1c) and c2

    # ------------------------------------------------------------------
    def _track_with_depth(self, feats, stamp):
        if self.status == base.NOT_INITIALIZED:
            pose = self._stereo_initialize(feats, stamp)
        else:
            pose = self._track_frame(feats, stamp)
        if pose is not None:
            self._log_frame(stamp, pose)
        return pose

    def _stereo_initialize(self, feats, stamp):
        """The one-frame metric initialisation (StereoInitialization):
        keyframe 0 at the identity and a landmark for every keypoint with a
        depth, when at least ``min_init_depth_points`` have one. One host
        read: that count, the new landmarks' count and their slots'
        high-water mark."""
        good = (self._depth > 0) & feats.valid
        eye = torch.eye(3, device=self.device)
        zero = torch.zeros(3, device=self.device)
        state = ms.add_keyframe(self.state, 0, eye, zero, stamp, feats,
                                ur=self._ur)
        state, n_new, hwm, lm_of_kp = self._depth_landmarks(state, 0, feats,
                                                            good)
        n_good, n_new, hwm = (int(x) for x in device_mod.read(
            good.sum(), n_new, hwm))
        if n_good < self.cfg.min_init_depth_points:
            return None
        self.state = state
        self.n_kf = 1
        self.n_lm = max(self.n_lm, hwm)
        if n_new < self.cfg.min_init_landmarks:
            self.atlas.reset_active_map()
            return None

        # Each landmark was made from keypoint kp of keyframe 0.
        eye_np, zero_np = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self._last = dict(feats=feats, bindings=lm_of_kp, R=eye_np,
                          t=zero_np, stamp=stamp)
        self._vel = None
        self.status = base.OK
        self.last_kf_id = 0
        self.frames_since_kf = 0
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.state, 0)
        self._set_ref_cache(0, eye_np, zero_np)
        return (eye_np, zero_np)

    def _depth_landmarks(self, state, kf_id: int, feats, mask):
        """Back-project the keypoints of keyframe ``kf_id`` in ``mask`` that
        have a depth into new landmarks (free slots recycled, as the
        bundle's triangulation allocates them). Returns (state', the mask's
        count, the slots' high-water mark, the new landmark of each keypoint
        or -1) as device tensors; nothing is read."""
        depth = self._depth
        mask = mask & (depth > 0) & feats.valid
        c = self.cfg
        x = (feats.xy[:, 0] - c.cx) / c.fx * depth
        y = (feats.xy[:, 1] - c.cy) / c.fy * depth
        pc = torch.stack([x, y, depth], -1)
        R, t = state.kfs.R[kf_id], state.kfs.t[kf_id]
        pw = (pc - t) @ R                                # R^T (pc - t)
        ray = pw + R.T @ t                               # pw - centre
        dist = ray.norm(dim=-1)
        normal = ray / dist.clamp_min(1e-9)[:, None]
        max_dist = dist * tracking.SCALE ** feats.level.to(torch.float32)
        min_dist = max_dist / tracking.SCALE ** 7
        slots, write = mapping._alloc_landmark_slots(state.lms.valid, mask)
        kp_idx = torch.arange(c.n_features, dtype=torch.int32,
                              device=self.device)
        state = ms.add_landmarks(state, slots, pw, feats.desc, kf_id, kp_idx,
                                 kf_id, kp_idx, write, normal, min_dist,
                                 max_dist)
        hwm = torch.where(write, slots + 1, 0).amax()
        return state, mask.sum(), hwm, torch.where(write, slots, -1).to(
            torch.int32)

    def _create_keyframe(self, feats, track_res, stamp, R_np, t_np):
        """The monocular keyframe step with the stereo rows, then the
        stereo branch of CreateNewKeyFrame: a landmark for each close
        keypoint (depth under ``depth_threshold``) that no landmark holds,
        bound into the last frame. Its one read (the new landmarks' slot
        high-water mark) waits for the keyframe's bundle. A full map makes
        no keyframe, and then no landmark either."""
        kf_id = super()._create_keyframe(feats, track_res, stamp, R_np, t_np)
        if kf_id is None:
            return None
        n_feat = self.cfg.n_features
        seen, kp_of = ms.landmarks_seen_by(self.state, kf_id)
        bound = torch.zeros(n_feat + 1, dtype=torch.bool, device=self.device)
        bound.index_fill_(0, torch.where(seen, kp_of, n_feat).long(), True)
        close = self._depth < self.cfg.depth_threshold
        state, _, hwm, lm_of_kp = self._depth_landmarks(
            self.state, kf_id, feats, ~bound[:n_feat] & close)
        self.state = state
        self._last["bindings"] = torch.where(lm_of_kp >= 0, lm_of_kp,
                                             self._last["bindings"])
        self.n_lm = max(self.n_lm, int(device_mod.read(hwm)[0]))
        return kf_id


class FisheyeStereoSlam(StereoSlam):
    """Stereo SLAM on a non-rectified (fisheye) rig on ``device``
    (``None``: the card; raises without one): descriptor matching and a
    two-view triangulation replace the rectified row search."""

    def __init__(self, config: FisheyeStereoConfig, device=None):
        super().__init__(config, device)
        self.frig = graft.fisheye_rig_config(config)
        self._fish = graft.fisheye_rig_tensors(self.frig, self.device)

    def _fisheye_extract(self, img_left, img_right):
        """Both cameras' features and the match; sets the frame's depth
        (-1 where none). The right-image u stays None."""
        feats, _, m = graft.fisheye_stereo_extract(
            self._upload(img_left), self._upload(img_right), self.frig,
            self._fish, **self._stage_kwargs())
        self._depth = m.depth
        return feats

    def track(self, img_left: np.ndarray, img_right: np.ndarray,
              stamp: float):
        """Process one raw pair; returns Tcw (R, t) as numpy, or None while
        initializing."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        return self._track_with_depth(
            self._fisheye_extract(img_left, img_right), stamp)


class RgbdSlam(StereoSlam):
    """RGB-D SLAM (System::TrackRGBD): the depth image sampled at the
    keypoints, and a virtual right-image u = u - bf / depth
    (ComputeStereoFromRGBD) for the stereo rows."""

    def track(self, img: np.ndarray, depth_img: np.ndarray, stamp: float):
        """Process one colour (grey) frame and its depth image (raw units,
        divided by ``depth_scale``); returns Tcw (R, t) as numpy, or None
        while initializing."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        feats = self._extract(img)
        d = self._upload(depth_img)
        d = d / torch.full_like(d, self.cfg.depth_scale)  # float32 division
        h, w = d.shape
        ix = torch.round(feats.xy[:, 0]).long().clamp(0, w - 1)
        iy = torch.round(feats.xy[:, 1]).long().clamp(0, h - 1)
        depth = d.reshape(-1)[iy * w + ix]
        ok = (depth > self.cfg.min_z) & feats.valid
        self._depth = torch.where(ok, depth, -1.0)
        bf = torch.full_like(depth, self.cfg.bf)       # float32 division
        self._ur = torch.where(ok, feats.xy[:, 0] - bf / depth, -1.0)
        return self._track_with_depth(feats, stamp)
