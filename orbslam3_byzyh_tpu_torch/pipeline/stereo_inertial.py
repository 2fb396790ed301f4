"""The stereo-inertial system, the reference's flagship configuration
(EuRoC stereo-inertial).

Port of the JAX package's ``pipeline/stereo_inertial.py``
``StereoInertialSlam`` (``System::TrackStereo`` with an IMU): the rectified
stereo front end of ``pipeline/stereo_system.StereoSlam`` (the one-frame
metric init, the depth landmarks, the stereo rows) under the inertial
machinery of ``pipeline/inertial_system.MonoInertialSlam``. The MRO puts
the inertial hooks around the stereo ones: a keyframe adds its depth
landmarks, then the IMU schedule runs. The stereo IMU init uses the (1e2,
1e5) bias prior after 1 s of chain and keeps the scale
(LocalMapping.cc:241-243, Optimizer.cc:3778).

``FisheyeStereoInertialSlam`` is the same over the non-rectified
(fisheye) front end of ``stereo_system.FisheyeStereoSlam`` (TUM-VI's
stereo-inertial rig): the frame's depth comes from
``graft.fisheye_stereo_extract``, the right-image u stays None, so the
frames, the local map and the VI-BAs use mono rows over the depth-made
landmarks, as in the JAX class.
"""

from __future__ import annotations

import numpy as np

from .. import graft
from . import system as base
from .inertial_system import ImuConfig, MonoInertialSlam
from .stereo_system import (FisheyeStereoConfig, FisheyeStereoSlam,
                            StereoConfig, StereoSlam)


class StereoInertialSlam(MonoInertialSlam, StereoSlam):
    """Stereo-inertial SLAM on ``device`` (``None``: the card; raises
    without one)."""

    def __init__(self, config: StereoConfig, imu_cfg: ImuConfig,
                 viba_window: int = 24, viba_free: int = 10,
                 viba_landmarks: int = 4096, full_viba_kf: int = 64,
                 device=None):
        super().__init__(config, imu_cfg, viba_window, viba_free,
                         viba_landmarks, full_viba_kf, device)
        self.imu_init_prior = (1e2, 1e5)
        self.imu_init_min_time = 1.0
        self.imu_fix_scale = True

    def track(self, img_left: np.ndarray, img_right: np.ndarray,
              stamp: float, imu_data=None):
        """Process one rectified pair and its IMU batch (ts, gyr, acc: the
        samples in (t_prev, t]); returns Tcw (R, t) as numpy, or None."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        self._append_imu(imu_data)
        self._cur_stamp = stamp
        prior_L = self._queue_prior()
        feats, _, m = graft.stereo_extract(
            self._upload(img_left), self._upload(img_right), self.cam_params,
            self.dist, self.rig, **self._stage_kwargs())
        self._depth, self._ur = m.depth, m.u_right      # -1 where none
        if self.status == base.NOT_INITIALIZED:
            pose = self._stereo_initialize(feats, stamp)
            if pose is not None:
                # The one-keyframe map: the chain starts at keyframe 0,
                # whose stamp is the device's float32 value (the JAX
                # system's lazy read of it).
                self.map_first_kf = 0
                self.kf_stamp[0] = float(np.float32(stamp))
        elif self.imu_ready:
            pose = self._track_inertial(feats, stamp, prior_L)
        else:
            pose = self._track_frame(feats, stamp)
        self._last_stamp = stamp
        if pose is not None:
            self._log_frame(stamp, pose)
        return pose


class FisheyeStereoInertialSlam(MonoInertialSlam, FisheyeStereoSlam):
    """Stereo-inertial SLAM on a non-rectified (fisheye) rig on ``device``
    (``None``: the card; raises without one): TUM-VI's 512x512
    Kannala-Brandt pair and its IMU."""

    def __init__(self, config: FisheyeStereoConfig, imu_cfg: ImuConfig,
                 viba_window: int = 24, viba_free: int = 10,
                 viba_landmarks: int = 4096, full_viba_kf: int = 64,
                 device=None):
        super().__init__(config, imu_cfg, viba_window, viba_free,
                         viba_landmarks, full_viba_kf, device)
        self._depth = None
        self.imu_init_prior = (1e2, 1e5)
        self.imu_init_min_time = 1.0
        self.imu_fix_scale = True
        # No right-image u, so no stereo rows in the VI-BAs (the JAX
        # class's _ba_kwargs is empty); the close-point depth stays.
        self.ctx = self.ctx._replace(bf=None)

    def track(self, img_left: np.ndarray, img_right: np.ndarray,
              stamp: float, imu_data=None):
        """Process one raw pair and its IMU batch (ts, gyr, acc: the
        samples in (t_prev, t]); returns Tcw (R, t) as numpy, or None."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        self._append_imu(imu_data)
        self._cur_stamp = stamp
        prior_L = self._queue_prior()
        feats = self._fisheye_extract(img_left, img_right)
        if self.status == base.NOT_INITIALIZED:
            pose = self._stereo_initialize(feats, stamp)
            if pose is not None:
                # The one-keyframe map: the chain starts at keyframe 0
                # (StereoInertialSlam.track's note).
                self.map_first_kf = 0
                self.kf_stamp[0] = float(np.float32(stamp))
        elif self.imu_ready:
            pose = self._track_inertial(feats, stamp, prior_L)
        else:
            pose = self._track_frame(feats, stamp)
        self._last_stamp = stamp
        if pose is not None:
            self._log_frame(stamp, pose)
        return pose
