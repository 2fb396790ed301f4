"""The monocular SLAM system: the host frame loop over the port's device
steps.

Port of the JAX package's ``pipeline/system.py`` ``MonoSlam`` (ORB-SLAM3's
``System::TrackMonocular`` with the state machine of ``Tracking``:
NOT_INITIALIZED -> OK -> RECENTLY_LOST -> a new map). With a chessboard
configuration (the fork's world frame, ``utils/chessboard``) each
uninitialised frame is searched for the board until one gives its pose
(``_snoop_chessboard``: the device detector and planar PnP, three reads),
and once the initial map exists the map and the tracking context are moved
into the board's frame (``_apply_chessboard_rebase``: on the device, read
with the reference keyframe's pose). ``enable_stage_timers`` turns on
ORB-SLAM3's per-stage timers (``utils/timers``), each stage ending in a
synchronisation of the device; off, no stage synchronises. Given a
vocabulary (a port ``ops.bow.Vocabulary``), it
keeps a BoW database of each map's keyframes (``loop_closing.LoopCloser``)
and relocalises: a RECENTLY_LOST frame into the active map, and a frame of
a lost or uninitialised map into an older atlas map, which it then
re-enters (``cross_map_reloc``). With ``use_loop_closing`` (the default)
it also closes loops: each keyframe, once its bundle is read, runs
``graft.loop_closing_step``'s pieces (``_run_loop_closing``: detection,
the essential-graph correction, the duplicate fusion) and a global BA,
time-sliced in the background (``background_gba``, one LM iteration a
tracked frame) or inline; an inline or merge GBA shards its landmarks over
the system's device mesh (``self.mesh``, ``parallel.dist_ba``) when it has
one. While the atlas holds another map, a keyframe
that closes no loop mines the other maps (``LoopCloser.detect_merge``) and
a confirmed common region welds the other map into the active one
(``_merge_maps``: ``graft.merge_maps``, the device half of
``graft.map_merge_step``). The atlas is saved and loaded through
``save_atlas_checkpoint`` / ``load_atlas_checkpoint`` (``io/checkpoint``).
Each frame runs the port's entry points:

  * ``graft.mono_extract`` (K1) on every frame;
  * ``graft.mono_initialize`` (K2) until the initial map is made;
  * ``tracking.frame_step`` (K2, K3) on every later frame, and the
    reference-keyframe fallback (K2, K3) when it keeps fewer than 15
    inliers;
  * ``graft.mono_keyframe_step`` (K2) for each new keyframe, read back
    lazily at the next keyframe;
  * ``graft.relocalize`` (K2, K3) on a RECENTLY_LOST frame, and before an
    initialisation attempt while the atlas holds another map;
  * ``LoopCloser.detect`` (K2) for each keyframe once 12 are live, and on a
    loop ``LoopCloser.close``, ``mapping.fuse_duplicates`` (K2) and the
    global BA;
  * ``LoopCloser.detect_merge`` (K2) for each keyframe that closes no loop
    while the atlas holds another map, and on a merge ``Atlas.merge``,
    ``mapping.fuse_duplicates`` (K2) and the global or windowed BA.

The map lives on the device. The host keeps the counters, the spanning
tree, the trajectory log, the last tracked pose and the velocity as numpy.
The reads of device values are the JAX system's: the number of valid
features of an uninitialised frame and the initialisation's three, one
packed read a tracked frame (``frame_step``'s ``info`` with the last pose),
and one packed read of the previous keyframe bundle's outputs at the next
keyframe; a relocalisation attempt reads the database's candidates once
and each candidate it tries once; a loop detection reads its candidates
once and each verified candidate up to three times
(``loop_closing.HOST_READS``; the Sim3 RANSAC's two SVDs synchronise too),
a closure its covisibility matrix, the background GBA's start the
keyframe liveness; a merge detection reads each other map's candidates
once and each verified candidate up to three times, and a merge reads
only the keyframe's refined pose (the reference cache). Each frame's
uploads (the image; the predicted and last poses) come from page-locked
memory and do not wait for the device.

The stereo and RGB-D systems (``pipeline/stereo_system.py``) extend it
through ``_ba_kwargs`` (the stereo rows of the frame step's final pose
optimization and of the bundle), ``_track_local_map``,
``_need_new_keyframe`` (reading ``_close_counts``, which every tracked
frame's ``info`` carries) and the slot ``_create_keyframe`` returns (None
when the map is full and no keyframe was made).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from .. import graft
from ..models import atlas as atlas_mod
from ..models import map_state as ms
from ..ops import bow, geometry, pnp
from ..utils import verbose
from . import mapping, tracking, trajectory_log
from .loop_closing import LoopCloser

NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3


@dataclasses.dataclass
class SlamConfig:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: Optional[np.ndarray] = None      # [k1,k2,p1,p2,(k3)] or None
    kb8: Optional[np.ndarray] = None       # [k0..k3] Kannala-Brandt fisheye
    n_features: int = 1024
    max_kf: int = 256
    max_lm: int = 16384
    max_obs: int = 12
    fps: float = 20.0
    min_frames: int = 0                    # KF policy (Tracking.cc:4388)
    max_frames: Optional[int] = None       # defaults to fps
    local_window: int = 8                  # covisible neighbours free in local BA
    ba_window: int = 32                    # total KFs (free + fixed) in local BA
    ba_lm_window: int = 4096               # landmark rows gathered for local BA
    # Bounded per-frame local map (UpdateLocalKeyFrames/Points,
    # Tracking.cc:4851-4895): the landmarks of the top `local_kf_window`
    # covisible KFs (+ the `recent_kf_window` newest), truncated at
    # `local_lm_window` rows.
    local_kf_window: int = 20
    local_lm_window: int = 4096
    recent_kf_window: int = 4
    # Min observations for a ref-KF landmark to count in the c2 keyframe
    # ratio (TrackedMapPoints(nMinObs), Tracking.cc:4407-4412; reference
    # default 3). Synthetic worlds with frame-to-frame descriptor churn may
    # need 1.
    kf_ref_min_obs: int = 3
    min_init_matches: int = 100            # two-view init gate (Tracking.cc:3620)
    triangulation_neighbors: int = 3
    # A vocabulary (``ops.bow.Vocabulary``) enables relocalization and,
    # with use_loop_closing, loop closing. Device mesh for the global BA
    # (parallel/dist_ba): None = every card when the system is on CUDA and
    # the host has more than one; False = none.
    background_gba: bool = True
    vocabulary: Optional[object] = None    # ops.bow.Vocabulary for reloc/loops
    use_loop_closing: bool = True
    device_mesh: Optional[object] = None
    min_reloc_inliers: int = 30            # Relocalization gate (~:5230)
    cross_map_reloc: bool = True
    lost_grace_frames: Optional[int] = None  # RECENTLY_LOST budget (~fps)
    # The fork's chessboard world frame (MonoSlam only; the stereo, RGB-D
    # and inertial systems ignore it, as the JAX classes do).
    chessboard: Optional[object] = None    # utils.chessboard.ChessboardConfig

    def cam_params(self):
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)


def _coeffs_tensor(coeffs, device):
    """A camera's first four distortion coefficients (radtan k1, k2, p1, p2
    or Kannala-Brandt k0..k3) as a float32 device tensor, or None."""
    return (None if coeffs is None else torch.tensor(
        np.asarray(coeffs, np.float32)[:4], device=device))


class MonoSlam:
    """Monocular SLAM engine (System::TrackMonocular) on ``device``
    (``None``: the card; raises without one)."""

    def __init__(self, config: SlamConfig, device=None):
        self.cfg = config
        self.device = device_mod.resolve(device)
        # The global BA's device mesh (parallel/dist_ba): None = every card
        # when the system runs on CUDA and the host has more than one;
        # False = none. The closure's inline GBA and the merge's GBA shard
        # their landmarks over it; the background GBA does not.
        self.mesh = config.device_mesh
        if (self.mesh is None and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            from ..parallel import dist_ba
            self.mesh = dist_ba.make_mesh()
        elif self.mesh is False:
            self.mesh = None
        self.mcfg = graft.mono_slam_config(config)
        dev = self.device
        self.cam_params = torch.tensor(config.cam_params(), device=dev)
        self.dist = _coeffs_tensor(config.dist, dev)
        self.kb8 = _coeffs_tensor(config.kb8, dev)
        self.atlas = atlas_mod.Atlas(config.max_kf, config.max_lm,
                                     config.max_obs, config.n_features,
                                     device=dev)
        self.status = NOT_INITIALIZED
        self.max_frames = config.max_frames or int(config.fps)
        self.lost_grace = config.lost_grace_frames or int(config.fps)
        self.lost_frames = 0
        # Localization-only mode (System::ActivateLocalizationMode): track
        # against the frozen map, no keyframe insertion.
        self.localization_only = False
        # The RANSACs' generator (the JAX system's rng_key).
        self.generator = torch.Generator(dev).manual_seed(0)
        # The keyframe databases (a vocabulary), and the count of
        # relocalizations into another atlas map.
        self.loop_closer = None
        if config.vocabulary is not None:
            self.loop_closer = LoopCloser(
                bow.to_device(config.vocabulary, dev), config.max_kf,
                config.n_features, cam_params=config.cam_params())
        self.n_cross_map_relocs = 0
        # The time-sliced background global BA, and the world-frame
        # rotation of the last map correction (for the inertial body).
        self._bg_gba = None
        self._corr_Rw = None

        # Reference frame for initialization.
        self._init_feats = None
        self._init_stamp = None
        # Last tracked frame: dict(feats, bindings, R, t, stamp). R and t are
        # numpy after a tracked frame, device tensors after a keyframe (the
        # keyframe's pose after its bundle, read with the next frame's info).
        self._last = None
        self._vel = None            # host (R_v, t_v): T_cur = vel * T_last
        self.frames_since_kf = 0
        self.last_kf_id = -1
        # Frame-trajectory log: poses relative to their reference keyframe,
        # replayed against the current keyframe poses on read. Stamps are
        # relative to the first frame (self.t0), as float32 keyframe stamps
        # could not hold absolute dataset stamps.
        self._traj = trajectory_log.TrajectoryLog()
        # (ref_kf_id, R_rw, t_rw) host cache of the reference keyframe's pose.
        self._ref_cache = None
        # Bumped by each refresh of the cache: the lazy keyframe read only
        # restores its bundle-time pose if nothing refreshed the cache since.
        self._ref_cache_gen = 0
        # The last keyframe bundle's outputs, read at the next keyframe.
        self._pending_kf = None
        self._kf_host_pending = False
        self._t0 = None
        n = config.n_features
        self._no_ur = torch.full((n,), -1.0, device=dev)
        self._zero = torch.zeros((), device=dev)
        # A stereo or RGB-D frame's right-image u and depth per keypoint
        # (-1 where none), and its close-point counts (tracked, untracked)
        # from the frame step: the stereo keyframe rule's inputs.
        self._ur = None
        self._depth = None
        self._close_counts = (0, 0)
        # The chessboard world frame: the board's camera pose (host float32,
        # from the first uninitialised frame that shows the board) and
        # whether the map was moved into the board's frame.
        self._chess_pose = None
        self._chess_applied = False
        # Per-stage timers (ORB-SLAM3's REGISTER_TIMES): None = off.
        self.timers = None

    # ------------------------------------------------------------------
    def enable_stage_timers(self):
        """Turn on the per-stage timers (``utils.timers.StageTimers``); each
        timed stage then ends with a synchronisation of the device."""
        from ..utils.timers import StageTimers
        self.timers = StageTimers()
        return self.timers

    def _stage(self, name: str):
        """A context timing stage ``name``, or a null context (no
        synchronisation) with the timers off."""
        if self.timers is None:
            return contextlib.nullcontext()
        return self._timed(name)

    def _stage_kwargs(self) -> dict:
        """The stage timer for an entry point that times stages of its own
        (``stage=``), passed only while the timers are on."""
        return {} if self.timers is None else {"stage": self._stage}

    @contextlib.contextmanager
    def _timed(self, name: str):
        with self.timers.time(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @property
    def t0(self) -> float:
        """Absolute timestamp of the first tracked frame (0.0 if none)."""
        return self._t0 or 0.0

    def _rel_stamp(self, stamp: float) -> float:
        if self._t0 is None:
            self._t0 = float(stamp)
        return float(stamp) - self._t0

    @property
    def state(self) -> ms.MapState:
        return self.atlas.state

    @state.setter
    def state(self, s: ms.MapState):
        self.atlas.state = s

    @property
    def n_kf(self) -> int:
        return self.atlas.counts().n_kf

    @n_kf.setter
    def n_kf(self, v: int):
        self.atlas.counts().n_kf = v

    @property
    def n_lm(self) -> int:
        return self.atlas.counts().n_lm

    @n_lm.setter
    def n_lm(self, v: int):
        self.atlas.counts().n_lm = v

    @property
    def kf_parent(self) -> np.ndarray:
        """Spanning-tree parent per keyframe slot (-1 = root), per map."""
        meta = self.atlas.counts()
        if meta.kf_parent is None:
            meta.kf_parent = np.full(self.cfg.max_kf, -1, np.int32)
        return meta.kf_parent

    def _host_poses(self):
        """The keyframe poses (R, t) as numpy, in one read."""
        return device_mod.read(self.state.kfs.R, self.state.kfs.t)

    # ------------------------------------------------------------------
    def _extract(self, img):
        """ORB features of a frame, rectified onto the (virtual) pinhole:
        through the Kannala-Brandt model when the camera has one, else
        undistorted when it has radtan coefficients. A numpy image goes up
        as it is (uint8 stays uint8); a tensor is the uploaded image. It
        becomes float32 on the device. (The fisheye rig's second camera is
        resolved once, in ``graft.fisheye_rig_tensors``.)"""
        x = (img if isinstance(img, torch.Tensor)
             else device_mod.upload(img, self.device))
        return graft.mono_extract(x.to(torch.float32), self.cam_params,
                                  self.dist, self.mcfg, kb8=self.kb8)

    def track(self, img: np.ndarray, stamp: float):
        """Process one frame; returns Tcw (R, t) as numpy, or None while
        initializing."""
        stamp = self._rel_stamp(stamp)
        self._kf_host_pending = False
        if self._check_timestamp_jump(stamp):
            return None
        x = device_mod.upload(img, self.device)
        if (self.cfg.chessboard is not None and self._chess_pose is None
                and self.status == NOT_INITIALIZED):
            self._snoop_chessboard(x)
        with self._stage("orb_extract"):
            feats = self._extract(x)
        if self.status == NOT_INITIALIZED:
            pose = self._try_initialize(feats, stamp)
        else:
            pose = self._track_frame(feats, stamp)
        if pose is not None:
            self._log_frame(stamp, pose)
        return pose

    # ------------------------------------------------------------------
    @property
    def trajectory(self):
        """Per-frame (stamp, R_cw, t_cw) list, replayed against the current
        keyframe poses so map corrections apply retroactively."""
        self._drain_pending()
        self._gba_flush()
        return self._traj.replay(*self._host_poses())

    def _log_frame(self, stamp: float, pose):
        """Record one tracked frame relative to its reference keyframe. A
        frame that hosts a new keyframe is logged as that keyframe with the
        identity relative pose, so it follows every later correction."""
        R_cw, t_cw = pose
        if self._kf_host_pending and self.last_kf_id >= 0:
            self._kf_host_pending = False
            self._traj.log(stamp, R_cw, t_cw, self.last_kf_id, R_cw, t_cw)
        elif self._ref_cache is None:
            self._traj.log(stamp, R_cw, t_cw, -1)
        else:
            ref, R_rw, t_rw = self._ref_cache
            self._traj.log(stamp, R_cw, t_cw, ref, R_rw, t_rw)
        # One bounded slice of a background global BA in flight.
        self._gba_tick()

    def _set_ref_cache(self, k: int, R=None, t=None):
        self._ref_cache_gen += 1
        self._ref_cache = None if k < 0 else (k, R, t)

    def _refresh_ref_cache(self):
        """Re-read the reference keyframe's pose after anything moved it."""
        k = self.last_kf_id
        if k < 0:
            self._set_ref_cache(k)
        else:
            self._set_ref_cache(k, *device_mod.read(self.state.kfs.R[k],
                                                    self.state.kfs.t[k]))

    # ------------------------------------------------------------------
    # Initialization (MonocularInitialization + CreateInitialMap)
    # ------------------------------------------------------------------
    def _ransac_indices(self, matched: torch.Tensor) -> torch.Tensor:
        """The two-view RANSAC's (200, 8) sample indices over the matched
        rows, drawn from the system's generator."""
        return geometry.sample_indices(
            self.generator, geometry.N_ITERS, geometry.SAMPLE_SIZE,
            matched.to(torch.float32) + 1e-9)

    def _try_initialize(self, feats, stamp):
        # Before a fresh map is built, try relocalizing into an older atlas
        # map: revisited territory re-enters the old map directly.
        if (len(self.atlas.maps) > 1 and self.loop_closer is not None
                and self.cfg.cross_map_reloc):
            reloc = self._relocalize(feats, stamp)
            if reloc is not None:
                return reloc
        n_valid = int(feats.valid.sum())
        if self._init_feats is None:
            if n_valid >= 100:
                self._init_feats, self._init_stamp = feats, stamp
            return None
        res = graft.mono_initialize(
            self.state, self._init_feats, feats, self._init_stamp, stamp,
            self.cam_params, cfg=self.mcfg, draw=self._ransac_indices)
        if not res.success:
            # Too few matches: the newer frame becomes the reference
            # (Tracking.cc:3620).
            if res.info["reason"] == "matches" and n_valid >= 100:
                self._init_feats, self._init_stamp = feats, stamp
            return None
        self.state = res.state
        self.n_kf = 2
        self.n_lm = res.info["n_good"]
        R_cur, t_cur = device_mod.read(res.R, res.t)
        self._last = dict(feats=feats, bindings=res.bindings, R=R_cur,
                          t=t_cur, stamp=stamp)
        self._vel = None
        self.status = OK
        self.last_kf_id = 1
        self.frames_since_kf = 0
        self.kf_parent[1] = 0
        # Keyframe 0's pose, logged retroactively against itself.
        eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self._traj.log(self._init_stamp, eye, zero, 0, eye, zero)
        self._set_ref_cache(1, R_cur, t_cur)
        return (R_cur, t_cur)

    # ------------------------------------------------------------------
    # Per-frame tracking (Track, the OK-state path)
    # ------------------------------------------------------------------
    def _ba_kwargs(self) -> dict:
        """The bundle's and the final pose optimization's stereo arguments:
        a stereo or RGB-D system returns use_stereo and bf (a Python
        float)."""
        return {}

    def _stereo_kwargs(self) -> dict:
        """``frame_step``'s stereo arguments for this frame: the right-image
        u, bf and the close-point depth, or the mono placeholders."""
        ba_kw = self._ba_kwargs()
        if not ba_kw.get("use_stereo") or self._ur is None:
            return dict(feats_ur=self._no_ur, bf=self._zero,
                        th_depth=self._zero, use_stereo=False)
        return dict(feats_ur=self._ur, bf=ba_kw["bf"],
                    th_depth=float(self.cfg.depth_threshold),
                    use_stereo=True)

    def _window_kwargs(self) -> dict:
        return dict(max_kf=self.cfg.max_kf,
                    n_local_kf=self.cfg.local_kf_window,
                    n_local_lm=self.cfg.local_lm_window,
                    recent_kf=self.cfg.recent_kf_window)

    def _track_local_map(self, res, feats):
        """Local-map tracking and the final pose optimization against the
        bounded local window."""
        lms, obs = self.state.lms, self.state.obs
        return tracking.track_local_map_windowed(
            res.R, res.t, res.bindings, lms.pos, lms.desc, lms.normal,
            lms.min_dist, lms.max_dist, lms.valid, obs.kf, obs.valid,
            self.n_kf, feats.xy, feats.level, feats.desc, feats.valid, None,
            None, self.cam_params, self.cfg.width, self.cfg.height,
            **self._window_kwargs())

    def _motion_prior(self):
        """(R_pred, t_pred, R_last, t_last) on the device: the velocity times
        the last pose. Host values go up in one copy."""
        last = self._last
        R_l, t_l = last["R"], last["t"]
        if isinstance(R_l, torch.Tensor):           # a keyframe's pose
            if self._vel is None:
                return R_l, t_l, R_l, t_l
            Rv, tv = (x.reshape(s) for x, s in zip(torch.split(
                device_mod.upload(np.concatenate([self._vel[0].ravel(),
                                                  self._vel[1]]),
                                  self.device), [9, 3]), [(3, 3), (3,)]))
            return Rv @ R_l, Rv @ t_l + tv, R_l, t_l
        if self._vel is not None:
            Rv, tv = self._vel
            R_p, t_p = Rv @ R_l, Rv @ t_l + tv
        else:
            R_p, t_p = R_l, t_l
        flat = device_mod.upload(np.concatenate(
            [R_p.ravel(), t_p, R_l.ravel(), t_l]).astype(np.float32),
            self.device)
        R_p, t_p, R_l, t_l = torch.split(flat, [9, 3, 9, 3])
        return R_p.reshape(3, 3), t_p, R_l.reshape(3, 3), t_l

    def _track_frame(self, feats, stamp):
        last = self._last
        R_pred, t_pred, R_last, t_last = self._motion_prior()
        # One fused device step (motion model with its widened retry, the
        # local-map track, the counters, the reference-KF count, the stereo
        # close-point counts) and one read: its info with the last pose.
        lms, obs = self.state.lms, self.state.obs
        st = self._stereo_kwargs()
        with self._stage("lm_track"):
            res, info, n_found, n_visible = tracking.frame_step(
                R_pred, t_pred, R_last, t_last, lms.pos, lms.desc,
                lms.normal, lms.min_dist, lms.max_dist, lms.valid,
                last["bindings"], last["feats"].desc, last["feats"].angle,
                feats.xy, feats.level, feats.desc, feats.valid, feats.angle,
                st["feats_ur"], st["bf"], st["th_depth"], obs.kf, obs.valid,
                self.last_kf_id, self.cfg.kf_ref_min_obs, self.n_kf,
                lms.n_found, lms.n_visible, self.cam_params, self.cfg.width,
                self.cfg.height, use_stereo=st["use_stereo"],
                **self._window_kwargs())
            info_np, R_lw, t_lw = device_mod.read(info, R_last, t_last)
        n_inliers = int(info_np[0])
        ref_matches = max(int(info_np[1]), 1)
        self._close_counts = (int(info_np[2]), int(info_np[3]))
        R_np = info_np[4:13].reshape(3, 3)
        t_np = info_np[13:16]

        if n_inliers < 15 and self.last_kf_id >= 0:
            # TrackReferenceKeyFrame fallback (Tracking.cc:3931): match
            # against the reference keyframe by descriptor, from the last
            # pose. Rare path.
            fb = self._track_reference_keyframe(R_last, t_last, feats)
            fb = self._track_local_map(fb, feats)
            n_fb, R_fb, t_fb = device_mod.read(fb.n_inliers, fb.R, fb.t)
            if int(n_fb) >= 15:
                res = fb
                n_inliers = int(n_fb)
                R_np, t_np = R_fb, t_fb
                # frame_step skipped the counter update (its n_inliers < 15).
                bound = res.bindings
                add = ms.scatter_rows(
                    torch.zeros(self.cfg.max_lm, dtype=torch.int32,
                                device=self.device),
                    torch.where(bound >= 0, bound, self.cfg.max_lm), 1,
                    accumulate=True)
                n_found = lms.n_found + add
                n_visible = lms.n_visible + add

        if n_inliers < 15:
            # RECENTLY_LOST (Tracking.cc:2925-2947): dead-reckon for a grace
            # period while attempting relocalization, then give the map up.
            self.status = RECENTLY_LOST
            self.lost_frames += 1
            reloc = self._relocalize(feats, stamp)
            if reloc is not None:
                return reloc
            if self.lost_frames > self.lost_grace:
                self._handle_lost(feats, stamp)
                return None
            return (R_np, t_np)
        self.status = OK
        self.lost_frames = 0
        self.state = self.state._replace(lms=self.state.lms._replace(
            n_found=n_found, n_visible=n_visible))

        # The chessboard world frame, once, after the initial map
        # (the fork's Tracking::Track after its initialisation): this
        # frame's pose and the last frame's move with the map.
        if (self._chess_pose is not None and not self._chess_applied
                and self.n_kf >= 2):
            R_np, t_np, R_lw, t_lw, res = self._apply_chessboard_rebase(
                R_np, t_np, R_lw, t_lw, res)

        # Motion model update (host floats).
        Rv_new = R_np @ R_lw.T
        tv_new = t_np - Rv_new @ t_lw
        self._vel = (Rv_new, tv_new)
        self._last = dict(feats=feats, bindings=res.bindings, R=R_np,
                          t=t_np, stamp=stamp)
        self.frames_since_kf += 1
        with self._stage("new_kf_decision"):
            need_kf = (not self.localization_only
                       and self._need_new_keyframe(n_inliers, ref_matches))
        if need_kf:
            with self._stage("total_mapping"):
                self._create_keyframe(feats, res, stamp, R_np, t_np)
        return (R_np, t_np)

    def _track_reference_keyframe(self, R_last, t_last, feats):
        """The reference keyframe's keypoint -> landmark table and the
        descriptor-only fallback matcher (TrackReferenceKeyFrame)."""
        kf = self.last_kf_id
        kfs, lms = self.state.kfs, self.state.lms
        seen, kp_of = ms.landmarks_seen_by(self.state, kf)
        n_feat = self.cfg.n_features
        ref_lm = ms.scatter_rows(
            torch.full((n_feat,), -1, dtype=torch.int32, device=self.device),
            torch.where(seen, kp_of, n_feat),
            torch.where(seen, torch.arange(self.cfg.max_lm,
                                           device=self.device), -1))
        return tracking.track_reference_keyframe(
            R_last, t_last, kfs.kp_desc[kf], kfs.kp_angle[kf],
            kfs.kp_valid[kf], ref_lm, lms.pos, lms.valid, feats.xy,
            feats.level, feats.desc, feats.valid, feats.angle,
            self.cam_params)

    # ------------------------------------------------------------------
    def change_dataset(self):
        """The boundary between two sequences (System::ChangeDataset):
        keep the atlas, close the current map and start the next sequence in
        a fresh one."""
        self._handle_lost(None, None)

    def activate_localization_mode(self):
        """Freeze the map; keep tracking against it."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, n_inliers: int,
                           ref_matches: int | None = None) -> bool:
        """NeedNewKeyFrame (:4388), the monocular rules. ``ref_matches``
        comes from the frame step when available."""
        if not self._kf_slot_available():
            return False
        if ref_matches is None:
            ref_matches = self._ref_kf_matches()
        c1a = self.frames_since_kf >= self.max_frames
        c1b = self.frames_since_kf >= self.cfg.min_frames
        c2 = (n_inliers < ref_matches * 0.9) and n_inliers > 15
        return (c1a or (c1b and c2)) and c2

    def _ref_kf_matches(self) -> int:
        """Reference-KF tracked-point count (TrackedMapPoints)."""
        n = int(tracking.ref_kf_matches(
            self.state.obs.kf, self.state.obs.valid, self.last_kf_id,
            self.cfg.kf_ref_min_obs))
        return max(n, 1)

    # ------------------------------------------------------------------
    # Capacity: culled keyframe slots are recycled by an order-preserving
    # compaction when the fixed-capacity arrays fill up.
    # ------------------------------------------------------------------
    def _kf_slot_available(self) -> bool:
        if self.n_kf < self.cfg.max_kf - 1:
            return True
        self._drain_pending()
        # Compaction renumbers the keyframes a background GBA's snapshot is
        # keyed on: finish it first.
        self._gba_flush()
        # If (almost) every slot is live, force-cull the most redundant
        # keyframes, so a long run degrades to sliding-window culling.
        n_live = int(self.state.kfs.valid.sum())
        if n_live >= self.cfg.max_kf - 1:
            n_freed = self._force_cull_keyframes(
                max(self.cfg.max_kf // 8, 2))
            verbose.print_mess(
                f"map at capacity max_kf={self.cfg.max_kf}: force-culled "
                f"{n_freed} most-redundant keyframes")
        state, old2new, n_valid = ms.compact_keyframes(self.state, self.n_kf)
        if n_valid >= self.cfg.max_kf - 1:
            verbose.print_mess(
                f"map full: {n_valid} live keyframes at capacity "
                f"max_kf={self.cfg.max_kf}; KF insertion suspended — raise "
                "SlamConfig.max_kf or loosen culling")
            return False
        verbose.print_mess(
            f"compacted keyframes: {self.n_kf} slots -> {n_valid} live",
            verbose.VERBOSE)
        # Frame records still on a dead slot move to the nearest earlier
        # live keyframe before the ids change.
        dead = old2new < 0
        if any(r >= 0 and dead[r] for r in self._traj.refs):
            self._traj.rebase(dead, self._nearest_live_parent(~dead),
                              *self._host_poses())
        self._traj.remap(old2new)
        # The spanning tree follows the renumbering.
        par = self.kf_parent
        resolved = self._resolve_dead_parents(par, ~dead)
        new_par = np.full_like(par, -1)
        for old in np.flatnonzero(~dead):
            p = resolved[old]
            new_par[old2new[old]] = old2new[p] if p >= 0 else -1
        par[:] = new_par
        self.state = state
        self.n_kf = n_valid
        self.last_kf_id = int(old2new[self.last_kf_id])
        if self.loop_closer is not None:
            self.loop_closer.remap_keyframes(old2new, n_valid)
        self._on_keyframes_compacted(old2new)
        self._refresh_ref_cache()
        return True

    def _on_keyframes_compacted(self, old2new: np.ndarray):
        """Subclass hook: remap any per-keyframe side arrays after the
        compaction (``old2new`` numpy, -1 for a dead slot)."""

    def _force_cull_keyframes(self, n: int) -> int:
        """Drop up to ``n`` keyframes in redundancy order, ignoring the 0.9
        redundancy gate. Keyframe 0 and the 8 newest are protected."""
        count = 0
        valid = self.state.kfs.valid.cpu().numpy()
        protect = np.zeros_like(valid)
        protect[np.flatnonzero(valid)[-8:]] = True
        protect[0] = True
        for _ in range(n):
            eligible = valid & ~protect
            if not eligible.any():
                break
            out = device_mod.read(mapping.cull_candidate(
                self.state, device_mod.upload(eligible, self.device),
                min_seen=0))[0]
            best = int(out[0])
            if out[1] < 0 or not eligible[best]:
                break
            self.state = mapping.drop_keyframe(self.state, best)
            after = valid.copy()
            after[best] = False
            self._rebase_culled(valid, after)
            valid = after
            count += 1
        return count

    @staticmethod
    def _resolve_dead_parents(parent: np.ndarray,
                              live: np.ndarray) -> np.ndarray:
        """``parent`` with dead intermediate parents walked through (the
        children of a culled keyframe reattach to its parent)."""
        out = parent.copy()
        for k in range(len(out)):
            p = out[k]
            hops = 0
            while p >= 0 and not live[p] and hops < len(out):
                p = parent[p]
                hops += 1
            out[k] = p if p >= 0 else -1
        return out

    @staticmethod
    def _nearest_live_parent(live: np.ndarray) -> np.ndarray:
        """parent_of[k] = the nearest earlier live slot (slot order is
        insertion order)."""
        parent = np.full(len(live), -1, np.int64)
        last = -1
        for k in range(len(live)):
            parent[k] = last
            if live[k]:
                last = k
        return parent

    def _rebase_culled(self, valid_before: np.ndarray,
                       valid_after: np.ndarray):
        """Move the frame records of freshly culled keyframes onto a
        surviving earlier keyframe, and reattach their children."""
        dead = valid_before & ~valid_after
        if not dead.any():
            return
        par = self.kf_parent
        par[:] = self._resolve_dead_parents(par, valid_after)
        if not any(r >= 0 and dead[r] for r in self._traj.refs):
            return
        self._traj.rebase(dead, self._nearest_live_parent(valid_after),
                          *self._host_poses())

    # ------------------------------------------------------------------
    # The per-keyframe mapping work: one device dispatch, read lazily.
    # Visual systems run the windowed local BA and the keyframe culling
    # inside the bundle; inertial systems (``_bundle_local_ba = False``)
    # run their LocalInertialBA and chain-aware culling right after it,
    # through ``_local_refine`` and ``_maybe_cull_keyframes`` (their
    # schedule needs the temporal chain).
    # ------------------------------------------------------------------
    _bundle_local_ba = True

    def _create_keyframe(self, feats, track_res, stamp, R_np, t_np):
        """CreateNewKeyFrame and the LocalMapping work for this keyframe:
        one dispatch of ``graft.mono_keyframe_step`` (with the frame's
        stereo rows on a stereo or RGB-D system), its outputs read at the
        next keyframe (the previous bundle's first). Returns the new
        keyframe's slot, or None when the map is full and none was made."""
        self._drain_pending()
        if self.n_kf >= self.cfg.max_kf - 1 and not self._kf_slot_available():
            return None
        kf_id = self.n_kf
        st = self._stereo_kwargs()
        state, bindings, info, culled = graft.mono_keyframe_step(
            self.state, kf_id, track_res.R, track_res.t, stamp, feats,
            track_res.bindings, self.cam_params, self.n_lm, cfg=self.mcfg,
            do_kf_cull=self._bundle_local_ba and self.n_kf >= 8,
            ur=self._ur, bf=st["bf"] if st["use_stereo"] else None,
            do_local_ba=self._bundle_local_ba)
        self.state = state
        self.n_kf = kf_id + 1
        self.frames_since_kf = 0
        self.last_kf_id = kf_id
        self._last["bindings"] = bindings
        self._last["R"] = state.kfs.R[kf_id]
        self._last["t"] = state.kfs.t[kf_id]
        # The reference pose cache holds the tracked pose until the
        # bundle's is read.
        self._ref_cache = (kf_id, R_np, t_np)
        if not self._bundle_local_ba:
            # The host-scheduled refinement and culling (no read).
            with self._stage("lba"):
                self._local_refine(kf_id, None, None)
            with self._stage("mp_culling"):
                self.state = mapping.cull_landmarks(self.state, kf_id)
            with self._stage("kf_culling"):
                self._maybe_cull_keyframes(kf_id)
            self._last["R"] = self.state.kfs.R[kf_id]
            self._last["t"] = self.state.kfs.t[kf_id]
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.state, kf_id)   # no read
        self._pending_kf = dict(
            kf_id=kf_id, ref_gen=self._ref_cache_gen,
            out=torch.cat([info, culled.to(torch.float32),
                           state.kfs.valid.to(torch.float32)]))
        # The hosting frame's trajectory record is this keyframe.
        self._kf_host_pending = True
        return kf_id

    def _drain_pending(self):
        """Read the last keyframe bundle's outputs: the spanning-tree
        parent, the landmark high-water mark, the keyframe's pose after the
        BA, the culled keyframes (their frame records rebased)."""
        pend = self._pending_kf
        if pend is None:
            return
        self._pending_kf = None
        kf_id = pend["kf_id"]
        out = device_mod.read(pend["out"])[0]
        n = self.cfg.max_kf
        info_np, culled, valid = out[:15], out[15:15 + n] > 0, out[15 + n:] > 0
        parent, parent_cnt = int(info_np[0]), int(info_np[1])
        self.kf_parent[kf_id] = (
            parent if parent_cnt > 0 else (kf_id - 1 if kf_id > 0 else -1))
        self.n_lm = max(self.n_lm, int(info_np[2]))
        if (self.last_kf_id == kf_id
                and pend["ref_gen"] == self._ref_cache_gen):
            self._ref_cache = (kf_id, info_np[3:12].reshape(3, 3).copy(),
                               info_np[12:15].copy())
        if culled.any():
            # No keyframe liveness changes between the bundle and this
            # read, so the bundle's is the current one.
            par = self.kf_parent
            par[:] = self._resolve_dead_parents(par, valid)
            if any(r >= 0 and culled[r] for r in self._traj.refs):
                self._traj.rebase(culled, self._nearest_live_parent(valid),
                                  *self._host_poses())
        # The bundle's liveness is the current one where the bundle culled
        # (nothing culls between it and this read); else it is read.
        self._run_loop_closing(
            kf_id, bool(valid[kf_id]) if self._bundle_local_ba else None)

    # ------------------------------------------------------------------
    # Loop closing and the background global BA (LoopClosing,
    # RunGlobalBundleAdjustment)
    # ------------------------------------------------------------------
    def _ensure_bg_gba(self):
        if self._bg_gba is None:
            from .background_gba import BackgroundGBA
            self._bg_gba = BackgroundGBA()
        return self._bg_gba

    def _gba_tick(self):
        """One bounded slice of the background solve (once a tracked
        frame); the merge when it completes."""
        g = self._bg_gba
        if g is None or not g.active:
            return
        with self._stage("global_ba"):
            if g.tick():
                self._merge_bg_gba()

    def _gba_flush(self):
        """Finish a background GBA in flight inline (the save and shutdown
        paths wait for the reference's GBA thread the same way)."""
        g = self._bg_gba
        if g is not None and g.flush():
            self._merge_bg_gba()

    def _gba_abort(self):
        """mbStopGBA: drop the solve in flight (a reset, a map switch or a
        rebase invalidated its snapshot)."""
        if self._bg_gba is not None:
            self._bg_gba.abort()

    def _merge_bg_gba(self):
        self.state = self._bg_gba.merge(self.state, self.kf_parent)
        self._on_map_corrected(self.last_kf_id)

    def _on_map_corrected(self, kf_id: int):
        """Re-coordinate the tracking context after a map correction (a
        loop closure or a GBA merge): the last frame follows its reference
        keyframe's correction, T' = T Twc_ref_old Tcw_ref_new. Sets
        ``_corr_Rw``, the world-frame rotation of the correction at that
        anchor, for the inertial systems' body state."""
        self._corr_Rw = None
        if self.last_kf_id != kf_id or self._last is None or kf_id < 0:
            return
        R_rn, t_rn = device_mod.read(self.state.kfs.R[kf_id],
                                     self.state.kfs.t[kf_id])
        cache = self._ref_cache
        if cache is not None and cache[0] == kf_id:
            _, R_ro, t_ro = cache
            R_l, t_l = (np.asarray(x, np.float32) if not isinstance(
                x, torch.Tensor) else device_mod.read(x)[0]
                for x in (self._last["R"], self._last["t"]))
            rel = R_l @ R_ro.T
            self._last["R"] = (rel @ R_rn).astype(np.float32)
            self._last["t"] = (rel @ (t_rn - t_ro) + t_l).astype(np.float32)
            self._corr_Rw = (R_rn.T @ R_ro).astype(np.float32)
        else:
            self._last["R"], self._last["t"] = R_rn, t_rn
        self._vel = None
        self._refresh_ref_cache()

    # ------------------------------------------------------------------
    # Atlas persistence (System::SaveAtlas / LoadAtlas)
    # ------------------------------------------------------------------
    def save_atlas_checkpoint(self, path: str):
        """Write the atlas to the directory ``path`` (``io/checkpoint``'s
        format, which the JAX package reads too), after the pending
        keyframe's outputs are read and a background GBA in flight is
        finished."""
        from ..io import checkpoint
        self._drain_pending()
        self._gba_flush()
        checkpoint.save_atlas(path, self.atlas)

    def load_atlas_checkpoint(self, path: str):
        """Resume from a saved atlas, loaded onto the system's device:
        every loaded map's database is rebuilt (one ``add_range`` a map)
        and tracking starts in a fresh active map; a loaded map is joined
        again by relocalization or by the merge branch when its place is
        revisited. The frame records of the outgoing map are frozen."""
        from ..io import checkpoint
        self._gba_abort()
        self._traj.freeze_all(*self._host_poses())
        self._ref_cache = None
        self._pending_kf = None
        atlas = checkpoint.load_atlas(path, self.device)
        cfg = self.cfg
        dims = (cfg.max_kf, cfg.max_lm, cfg.max_obs, cfg.n_features)
        if tuple(atlas.dims) != dims:
            raise ValueError(f"checkpoint capacities {atlas.dims} differ "
                             f"from the system's {dims}")
        self.atlas = atlas
        lc = self.loop_closer
        if lc is not None:
            lc.dbs = {}
            for idx, (state, meta) in enumerate(zip(atlas.maps, atlas.meta)):
                lc.switch_map(idx)
                if meta.n_kf:
                    lc.db.add_range(0, state.kfs.kp_desc[:meta.n_kf],
                                    state.kfs.kp_valid[:meta.n_kf])
        atlas.create_new_map()
        if lc is not None:
            lc.switch_map(atlas.current)
        self.status = NOT_INITIALIZED
        self.lost_frames = 0
        self._init_feats = None
        self._init_stamp = None
        self._last = None
        self._vel = None
        self.last_kf_id = -1
        self.frames_since_kf = 0

    def _loops_allowed(self) -> bool:
        """The loop gate: none for a visual system (the inertial systems
        wait for VIBA2)."""
        return True

    def _run_loop_closing(self, kf_id: int, live: bool | None = None):
        """The LoopClosing work of keyframe ``kf_id`` (run when its bundle
        is read): detection and, on a loop, the correction, the fusion of
        the drifted duplicates and the global BA, in the background or
        inline (``graft.loop_closing_step`` is the same device work as one
        entry point). ``live``: the keyframe's liveness when the caller
        has read it."""
        lc = self.loop_closer
        if lc is None or not self.cfg.use_loop_closing:
            return
        if not self._loops_allowed():
            return
        if live is None:
            live = bool(device_mod.read(self.state.kfs.valid[kf_id])[0])
        if not live:
            return
        bg = self._ensure_bg_gba() if self.cfg.background_gba else None
        self.state, info = graft.loop_closing_step(
            self.state, lc, kf_id, self.n_kf, self.cam_params,
            kf_parent=self.kf_parent, cfg=self.mcfg,
            gba="background" if bg is not None else "inline", bg=bg,
            ba_kwargs=self._ba_kwargs(), mesh=self.mesh,
            **self._stage_kwargs())
        if info["fired"]:
            # The tracking context follows the corrected map (the close
            # and, inline, the GBA: one re-coordination of both).
            self._on_map_corrected(kf_id)
        elif len(self.atlas.maps) > 1:
            # The merge branch: a common region in another map
            # (LoopClosing::MergeLocal).
            det = lc.detect_merge(self.state, kf_id, self.atlas)
            if det is not None:
                self._merge_maps(kf_id, *det)

    def _merge_maps(self, kf_id: int, other_idx: int, cand: int, corr):
        """Weld atlas map ``other_idx`` into the active one at keyframe
        ``kf_id`` (MergeLocal): the background GBA in flight dropped (its
        snapshot predates the weld), ``graft.merge_maps`` (the weld, the
        databases, the fusion, the merge BA), the merged-away map's frozen
        frame records moved into the active world, and the tracking context
        re-set on the keyframe's refined pose. ``cand``: the other map's
        keyframe that verified (the weld needs only the Sim3)."""
        self._gba_abort()
        w = graft.merge_maps(self.atlas, self.loop_closer, kf_id, other_idx,
                             corr, self.cam_params, cfg=self.mcfg,
                             ba_kwargs=self._ba_kwargs(), mesh=self.mesh)
        self._traj.transform_frozen(other_idx, w["R_i"], w["t_i"],
                                    w["s_i"], self.atlas.current)
        if self._last is not None:
            self._last["R"] = self.state.kfs.R[kf_id]
            self._last["t"] = self.state.kfs.t[kf_id]
        self._vel = None
        self._refresh_ref_cache()

    def _local_refine(self, kf_id: int, counts, order):
        """The local BA after a new keyframe when the bundle ran none
        (LocalBundleAdjustment): the covisibility-windowed BA. The inertial
        systems override it with their LocalInertialBA."""
        self.state = mapping.windowed_local_ba(
            self.state, kf_id, self.cam_params,
            n_free=self.cfg.local_window + 1, n_window=self.cfg.ba_window,
            n_lm_window=self.cfg.ba_lm_window, **self._ba_kwargs())

    def _maybe_cull_keyframes(self, kf_id: int):
        """KeyFrameCulling when the bundle ran none (the inertial systems
        override it with their chain-aware culling)."""
        if self.n_kf >= 8:
            before = device_mod.read(self.state.kfs.valid)[0] > 0
            self.state = mapping.cull_keyframes(self.state, kf_id)
            self._rebase_culled(before,
                                device_mod.read(self.state.kfs.valid)[0] > 0)

    # ------------------------------------------------------------------
    # Map lifecycle (Atlas flow)
    # ------------------------------------------------------------------
    def _check_timestamp_jump(self, stamp: float) -> bool:
        """Timestamp discontinuity guard (Tracking.cc:2704-2765): a gap over
        1 s or a backwards stamp while tracking resets the machinery (small
        map discarded, mature map kept in the atlas). Returns True if a
        reset happened; the frame is then dropped."""
        if self._last is None or self.status == NOT_INITIALIZED:
            return False
        dt = stamp - self._last["stamp"]
        if -1e-6 <= dt <= 1.0:
            return False
        verbose.print_mess(
            f"timestamp jump of {dt:.2f}s detected: "
            + ("starting new map" if self.n_kf >= 10 else "resetting map"))
        self._handle_lost(None, stamp)
        return True

    def _handle_lost(self, feats, stamp):
        """LOST: a small map is reset; a mature one is kept and a new map
        started (Tracking.cc:3349-3378 + CreateMapInAtlas)."""
        self._drain_pending()
        self._gba_abort()        # the snapshot's map is going away
        # The map's keyframe slots are about to be reused: its frame records
        # are replayed once and stored absolute, tagged with the map's atlas
        # index if it is kept.
        keep_map = self.n_kf >= 10
        self._traj.freeze_all(*self._host_poses(),
                              map_tag=(self.atlas.current if keep_map
                                       else -1))
        self._ref_cache = None
        if keep_map:
            self.atlas.create_new_map()
            if self.loop_closer is not None:
                self.loop_closer.switch_map(self.atlas.current)
        else:
            self.atlas.reset_active_map()
            if self.loop_closer is not None:
                self.loop_closer.reset_active()
        self.status = NOT_INITIALIZED
        self.lost_frames = 0
        self._init_feats = None
        self._init_stamp = None
        self._last = None
        self._vel = None
        self.last_kf_id = -1
        self.frames_since_kf = 0

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization) and the atlas re-entry
    # ------------------------------------------------------------------
    def _pnp_indices(self, corr: torch.Tensor,
                     kp_lm: torch.Tensor) -> torch.Tensor:
        """The relocalization PnP's (128, 6) sample rows over the
        keypoints with a correspondence (``corr``; ``kp_lm`` holds each
        keypoint's landmark), drawn from the system's generator."""
        return pnp.draw_indices(self.generator, corr)

    def _relocalize(self, feats, stamp):
        """The active map first (the reference's candidates come from the
        current map), then, with ``cross_map_reloc``, every other atlas map
        from the newest, switching into the one that relocalizes. Returns
        the pose (numpy) or None."""
        if self.loop_closer is None:
            return None
        hit = self._relocalize_in_map(feats, self.atlas.current)
        if hit is not None:
            self._adopt_reloc(hit, feats, stamp)
            return (hit.R, hit.t)
        if not self.cfg.cross_map_reloc:
            return None
        for m in range(len(self.atlas.maps) - 1, -1, -1):
            if m == self.atlas.current:
                continue
            hit = self._relocalize_in_map(feats, m)
            if hit is not None:
                self._switch_to_map_for_reloc(m, hit.cand)
                self._adopt_reloc(hit, feats, stamp)
                self.n_cross_map_relocs += 1
                verbose.print_mess(
                    f"relocalized into atlas map {m} (KF {hit.cand})")
                return (hit.R, hit.t)
        return None

    def _relocalize_in_map(self, feats, map_idx: int):
        """``graft.relocalize`` against atlas map ``map_idx``: its
        ``RelocResult`` when a candidate passes, else None. Nothing is
        changed."""
        db = self.loop_closer.dbs.get(map_idx)
        if db is None:
            return None
        res = graft.relocalize(
            self.atlas.maps[map_idx], db, feats, self.cam_params,
            cfg=self.mcfg, min_inliers=self.cfg.min_reloc_inliers,
            draw=self._pnp_indices)
        return res if res.success else None

    def _adopt_reloc(self, hit, feats, stamp):
        self.status = OK
        self.lost_frames = 0
        self._vel = None
        self._last = dict(feats=feats, bindings=hit.track.bindings,
                          R=hit.R, t=hit.t, stamp=stamp)

    def _switch_to_map_for_reloc(self, map_idx: int, cand: int):
        """Make atlas map ``map_idx`` the active one after a relocalization
        into it. The outgoing map stays in the atlas if mature, or is reset
        in place if too young to keep (``_handle_lost``'s split)."""
        self._drain_pending()
        self._gba_abort()
        keep = self.n_kf >= 10
        # The outgoing map's frame records stop replaying against the
        # incoming map's keyframe slots.
        self._traj.freeze_all(*self._host_poses(),
                              map_tag=(self.atlas.current if keep else -1))
        if not keep:
            self.atlas.reset_active_map()
            self.loop_closer.reset_active()
        self.atlas.current = map_idx
        self.loop_closer.switch_map(map_idx, fresh=False)
        self.last_kf_id = cand
        self.frames_since_kf = 0
        self._init_feats = None
        self._init_stamp = None
        self._refresh_ref_cache()
        self._on_cross_map_reloc(cand)

    def _on_cross_map_reloc(self, cand: int):
        """Subclass hook (the inertial systems restart their chain)."""

    # ------------------------------------------------------------------
    # The chessboard world frame (the fork's ComputePoseFromChessboard and
    # TransformAllMapElements; utils/chessboard)
    # ------------------------------------------------------------------
    def _snoop_chessboard(self, img: torch.Tensor):
        """Search the uploaded frame for the board; keep the camera's pose
        in the board's frame when it is found. The corners are undistorted
        through the camera's radtan coefficients before the PnP (the JAX
        system poses the distorted corners with K alone)."""
        from ..utils import chessboard as cb
        corners = cb.detect_chessboard(img, self.cfg.chessboard)
        if corners is None:
            return
        K = np.array([[self.cfg.fx, 0, self.cfg.cx],
                      [0, self.cfg.fy, self.cfg.cy], [0, 0, 1.0]])
        pose = cb.pose_from_chessboard(corners, self.cfg.chessboard, K,
                                       dist=self.dist, device=self.device)
        if pose is not None:
            self._chess_pose = pose

    def _apply_chessboard_rebase(self, R_cur, t_cur, R_last, t_last, res):
        """Move the map into the board's frame, M = Tc_board^-1 Tc_slam at
        keyframe 0 (the frame the board was seen on is, approximately, the
        initialisation's reference frame), computed and applied on the
        device; then everything else that holds world coordinates: this
        frame's pose (host) and track result (device), the last frame's
        pose, the reference-pose cache (M comes back with the reference
        keyframe's pose in one read). The velocity T_cur T_last^-1 is the
        same in both frames; it is recomputed from the moved poses. A
        background GBA's snapshot is dropped. Returns the moved (R_cur,
        t_cur, R_last, t_last, res)."""
        from ..utils import chessboard as cb
        R_c, t_c = (device_mod.upload(np.asarray(x, np.float32), self.device)
                    for x in self._chess_pose)
        kfs = self.state.kfs
        R_m, t_m = cb.rebase_transform(R_c, t_c, kfs.R[0], kfs.t[0])
        self.state = cb.rebase_map(self.state, R_m, t_m)
        self._gba_abort()
        k = self.last_kf_id
        R_m_np, t_m_np, R_k, t_k = device_mod.read(
            R_m, t_m, self.state.kfs.R[k], self.state.kfs.t[k])
        self._set_ref_cache(k, R_k, t_k)

        def move(R, t):
            R_n = (np.asarray(R, np.float32) @ R_m_np.T).astype(np.float32)
            return R_n, (np.asarray(t, np.float32)
                         - R_n @ t_m_np).astype(np.float32)

        R_cur, t_cur = move(R_cur, t_cur)
        R_last, t_last = move(R_last, t_last)
        R_d = res.R @ R_m.T
        res = res._replace(R=R_d, t=res.t - R_d @ t_m)
        self._vel = None
        self._chess_applied = True
        return R_cur, t_cur, R_last, t_last, res

    # ------------------------------------------------------------------
    def keyframe_trajectory(self):
        """(stamps, Rcw, tcw) arrays of the live keyframes (absolute
        stamps)."""
        self._drain_pending()
        self._gba_flush()
        kfs = self.state.kfs
        valid, stamp, R, t = device_mod.read(kfs.valid, kfs.stamp, kfs.R,
                                             kfs.t)
        valid = valid > 0
        return (stamp.astype(np.float64)[valid] + self.t0, R[valid],
                t[valid])
