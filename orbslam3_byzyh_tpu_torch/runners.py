"""The dataset runners: the port's counterparts of the JAX package's
``scripts/run_euroc_mono.py``, ``run_euroc_mono_inertial.py``,
``run_euroc_stereo_inertial.py``, ``run_kitti.py``, ``run_tum_rgbd.py`` and
``run_tumvi.py`` (ORB-SLAM3's example mains).

Each ``main_*(argv)`` takes its JAX runner's flags and defaults, plus
``--device`` (the card unless ``cpu``), reads the settings file and the
sequence(s) from disk, drives the port's system frame by frame and writes
its JAX runner's files (``f_<name>.txt``, ``kf_<name>.txt``,
``ExecTimeMean.txt``; KITTI ``<name>_kitti.txt`` and ``f_<name>.txt``;
TUM RGB-D ``f_`` and ``kf_``) and printed lines. The scripts
``scripts/run_*_torch.py`` call them.

What the port does in place of the JAX runners' host OpenCV: the images
are decoded by the prefetcher (``io.prefetch``: worker threads inflate,
P1 unfilters on the device), the stereo pair is rectified on the device
(``io.rectify``, Bouguet's rectification in numpy), CLAHE runs on the
device (``ops.clahe``); a frame never returns to the host and nothing in
the preprocessing synchronises.

One intended difference: with an IMU the stereo(-inertial) runner gives
the system the extrinsic of the camera it tracks, the rectified left
camera, ``T_b_rect = T_b_c1 [R1^T | 0]`` (``io.rectify.
rectified_body_extrinsic``); the JAX runner passes the yaml's ``T_b_c1``
unchanged (``run_euroc_stereo_inertial.py:95-102``), off by R1 (0.62
degrees on EuRoC).

``--snapshot-every N`` (the EuRoC runners) writes the map as
``map_<frame:05d>.png`` every N frames (``utils.viewer.snapshot``, numpy
and the port's PNG writer: no matplotlib).

Besides ``argv`` each ``main_*`` takes, for a program that calls it:
``out_dir`` (where the files go; the working directory by default) and
``on_system`` (called with the system once it is built, before the first
frame). It returns a :class:`RunResult`.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_VOCABULARY = (Path(__file__).resolve().parents[1] / "vocabulary"
                      / "synthetic_voc_10k.npz")


class RunResult(NamedTuple):
    """What a run did: the system, its stage timers, the frames run, the
    wall time (s), one record a frame (``stamp``, ``track_ms``: host clock
    around ``track``; ``wait_ms``: blocked on the prefetcher; ``prep_ms``:
    the host's time to launch the decode and the preprocessing), the
    preprocessing's device time a frame in ms (CUDA events around the
    decode, rectification and CLAHE; None on the CPU), the rectification
    (stereo) and the IMU extrinsic given to the system, and the files
    written."""

    slam: object
    timers: object
    n_total: int
    wall_s: float
    frames: list
    prep_device_ms: list | None
    rig: object
    T_bc: np.ndarray | None
    outputs: list


def default_vocabulary():
    """The shipped 10k-word vocabulary (``vocabulary/synthetic_voc_10k.npz``
    at the repository's root), the runners' default: relocalization and
    loop closing on."""
    return str(DEFAULT_VOCABULARY) if DEFAULT_VOCABULARY.exists() else None


def _after_frame(slam, args, fcount: int, out_dir, snapshots: list):
    """The JAX runners' per-frame session hooks: localization mode after
    ``--localization-after`` frames, a map snapshot every
    ``--snapshot-every`` frames (``map_<fcount:05d>.png`` in ``out_dir``)."""
    if args.localization_after and fcount == args.localization_after:
        slam.activate_localization_mode()
    if args.snapshot_every and fcount % args.snapshot_every == 0:
        from .utils import viewer
        snapshots.append(viewer.snapshot(
            slam, os.path.join(out_dir, f"map_{fcount:05d}.png")))


def _vocabulary(args, device):
    if args.no_vocabulary:
        args.vocabulary = None
    if not args.vocabulary:
        return None
    from .ops import bow
    return bow.load_vocabulary(args.vocabulary, device=device)


def _imu_config(imu, T_bc=None):
    from .ops.imu import ImuConfig
    return ImuConfig(
        T_bc=np.asarray(imu.Tbc if T_bc is None else T_bc, np.float32),
        gyro_noise=imu.noise_gyro, acc_noise=imu.noise_acc,
        gyro_walk=imu.walk_gyro, acc_walk=imu.walk_acc, freq=imu.frequency)


def _save_trajectories(slam, out_dir, name, stamp_scale=None,
                       keyframes=True) -> list:
    from .io import trajectory
    scale = {} if stamp_scale is None else {"stamp_scale": stamp_scale}
    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    out = [os.path.join(out_dir, f"f_{name}.txt")]
    trajectory.save_tum(out[0], stamps, Rs, ts, **scale)
    if keyframes:
        ks, kR, kt = slam.keyframe_trajectory()
        out.append(os.path.join(out_dir, f"kf_{name}.txt"))
        trajectory.save_tum(out[1], ks, kR, kt, **scale)
    return out


class _Frames:
    """The frame loop's bookkeeping: the per-frame records and, on the
    card, CUDA events around each frame's preprocessing (read once, after
    the loop)."""

    def __init__(self, device):
        self.records = []
        self.events = [] if device.type == "cuda" else None
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])

    def prepared(self, wait_s: float):
        self._prep = (time.perf_counter() - self._t0) * 1e3 - wait_s * 1e3
        self._wait = wait_s * 1e3
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev

    def tracked(self, stamp: float, track_s: float):
        self.records.append({"stamp": stamp, "track_ms": track_s * 1e3,
                             "wait_ms": self._wait, "prep_ms": self._prep})

    def device_ms(self):
        if self.events is None:
            return None
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _take(pf, n: int):
    """The next ``n`` images of the prefetcher as tensors, and the time the
    caller waited for them (s)."""
    w0 = pf.wait_s
    out = []
    for _ in range(n):
        _, img = next(pf)
        out.append(img if isinstance(img, torch.Tensor)
                   else torch.from_numpy(img))
    return out, pf.wait_s - w0


def _track_timed(timers, fn, *a):
    t0 = time.perf_counter()
    with timers.time("total_track"):
        fn(*a)
    return time.perf_counter() - t0


def _summary(slam, n_total, wall, imu=None) -> str:
    line = (f"tracked {len(slam.trajectory)}/{n_total} frames in {wall:.1f}s "
            f"({n_total / wall:.1f} fps); keyframes={slam.n_kf} "
            f"landmarks={slam.n_lm} maps={len(slam.atlas.maps)}")
    if imu is not None:
        line += f" imu_ready={slam.imu_ready}"
    return line


def _euroc_args(ap):
    ap.add_argument("settings")
    ap.add_argument("sequence", nargs="+")
    ap.add_argument("--timestamps", nargs="*", default=None)
    ap.add_argument("--output-name", default="output")
    ap.add_argument("--vocabulary", default=default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    # MH01-05 multi-session scale by default (euroc_eval_examples.sh:14-20
    # runs 5 sequences back to back; well over 256 live keyframes).
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)


def _session_args(ap):
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write map_NNNNN.png every N frames (offline "
                         "viewer)")
    ap.add_argument("--localization-after", type=int, default=0,
                    help="freeze the map after N frames (localization mode)")


def _device_arg(ap):
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions on the CPU)")


def _sequence_file(args, si):
    return (args.timestamps[si] if args.timestamps
            and si < len(args.timestamps) else None)


def _n_frames(n, max_frames):
    return n if max_frames is None else min(n, max_frames)


# -- EuRoC monocular and monocular-inertial -----------------------------------

def _run_euroc_mono(argv, inertial: bool, out_dir, on_system) -> RunResult:
    ap = argparse.ArgumentParser()
    _euroc_args(ap)
    _session_args(ap)
    ap.add_argument("--min-init-matches", type=int, default=100,
                    help="two-view init match gate (Tracking.cc:3620; lower "
                         "for low-texture scenes)")
    if inertial:
        ap.add_argument("--clahe", action="store_true")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from . import device as device_mod
    from .io import euroc, settings
    from .io.prefetch import ImagePrefetcher
    from .pipeline.system import MonoSlam, SlamConfig

    dev = device_mod.resolve(args.device)
    out_dir = out_dir or os.getcwd()
    cfg_yaml = settings.load_settings(args.settings)
    if inertial and cfg_yaml.imu is None:
        raise SystemExit("settings file has no IMU block")
    voc = _vocabulary(args, dev)
    cam = cfg_yaml.cam1
    kb8 = (cam.params[4:8] if inertial and cam.model == "KannalaBrandt8"
           else None)
    cfg = SlamConfig(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist, kb8=kb8,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 20.0,
        vocabulary=voc, use_loop_closing=not args.no_loop_closing,
        max_kf=args.max_kf, max_lm=args.max_lm,
        min_init_matches=args.min_init_matches)
    clahe = None
    if inertial:
        from .ops.clahe import Clahe
        from .pipeline.inertial_system import MonoInertialSlam
        slam = MonoInertialSlam(cfg, _imu_config(cfg_yaml.imu), device=dev)
        clahe = Clahe(3.0, (8, 8)) if args.clahe else None
    else:
        if cfg_yaml.chessboard is not None:
            # Fork feature: chessboard world-frame initialization
            # (UseChessboardInit keys); the trajectory is then written in the
            # board's frame.
            from .utils.chessboard import ChessboardConfig
            cb = cfg_yaml.chessboard
            cfg.chessboard = ChessboardConfig(
                width=cb.width, height=cb.height,
                square_size=cb.square_size, start_x=cb.start_x,
                start_y=cb.start_y, z_height=cb.z_height)
        slam = MonoSlam(cfg, device=dev)
        # Atlas persistence keys (System.SaveAtlasToFile/LoadAtlasFromFile).
        if cfg_yaml.load_atlas:
            slam.load_atlas_checkpoint(cfg_yaml.load_atlas)
            print(f"loaded atlas from {cfg_yaml.load_atlas} "
                  f"({len(slam.atlas.maps) - 1} stored maps)")
    timers = slam.enable_stage_timers()
    if on_system is not None:
        on_system(slam)

    frames = _Frames(dev)
    n_total = fcount = 0
    snapshots = []
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()   # multi-session (SLAM.ChangeDataset())
        seq = euroc.load_euroc(seq_dir, _sequence_file(args, si))
        if inertial and seq.imu_stamps is None:
            raise SystemExit(f"{seq_dir} has no mav0/imu0/data.csv")
        n_frames = _n_frames(len(seq), args.max_frames)
        n_total += n_frames
        pf = ImagePrefetcher(seq.image_paths[:n_frames], device=dev)
        t_prev = None
        try:
            for idx in range(n_frames):
                frames.begin()
                (img,), wait = _take(pf, 1)
                if clahe is not None:
                    img = clahe.apply(img)
                frames.prepared(wait)
                t = float(seq.stamps[idx])
                if inertial:
                    imu_data = (seq.imu_between(t_prev, t)
                                if t_prev is not None else None)
                    dt = _track_timed(timers, slam.track, img, t, imu_data)
                else:
                    dt = _track_timed(timers, slam.track, img, t)
                frames.tracked(t, dt)
                t_prev = t
                fcount += 1
                _after_frame(slam, args, fcount, out_dir, snapshots)
        finally:
            pf.close()
    wall = time.perf_counter() - t_start

    print(_summary(slam, n_total, wall, slam.imu_ready if inertial else None))
    print(timers.report())
    outputs = _save_trajectories(slam, out_dir, args.output_name,
                                 stamp_scale=1e9)
    outputs.append(os.path.join(out_dir, "ExecTimeMean.txt"))
    timers.save(outputs[-1])
    outputs += snapshots
    if not inertial and cfg_yaml.save_atlas:
        slam.save_atlas_checkpoint(cfg_yaml.save_atlas)
        print(f"saved atlas to {cfg_yaml.save_atlas}")
    return RunResult(slam, timers, n_total, wall, frames.records,
                     frames.device_ms(), None,
                     slam.imu_cfg.T_bc if inertial else None, outputs)


def main_euroc_mono(argv=None, *, out_dir=None, on_system=None) -> RunResult:
    """``scripts/run_euroc_mono.py`` (mono_euroc.cc): ``MonoSlam`` over
    EuRoC-layout sequences."""
    return _run_euroc_mono(argv, False, out_dir, on_system)


def main_euroc_mono_inertial(argv=None, *, out_dir=None,
                             on_system=None) -> RunResult:
    """``scripts/run_euroc_mono_inertial.py`` (mono_inertial_euroc.cc):
    ``MonoInertialSlam`` with per-frame IMU batches; ``--clahe`` applies
    CLAHE (clip 3, 8 x 8 tiles) on the device."""
    return _run_euroc_mono(argv, True, out_dir, on_system)


# -- EuRoC stereo and stereo-inertial ------------------------------------------

def main_euroc_stereo_inertial(argv=None, *, out_dir=None, on_system=None,
                               repair_tbc: bool = True) -> RunResult:
    """``scripts/run_euroc_stereo_inertial.py`` (stereo_inertial_euroc.cc,
    stereo_euroc.cc with ``--no-imu``): the raw pair rectified on the
    device from ``Stereo.T_c1_c2``, per-frame IMU batches. With the IMU the
    system gets the rectified camera's extrinsic (the module doc);
    ``repair_tbc=False`` passes the yaml's ``T_b_c1`` as the JAX runner
    does (for comparing the two)."""
    ap = argparse.ArgumentParser()
    _euroc_args(ap)
    ap.add_argument("--no-imu", action="store_true")
    _session_args(ap)
    _device_arg(ap)
    args = ap.parse_args(argv)

    from . import device as device_mod
    from .io import euroc, rectify, settings
    from .io.prefetch import ImagePrefetcher
    from .pipeline.stereo_inertial import StereoInertialSlam
    from .pipeline.stereo_system import StereoConfig, StereoSlam

    dev = device_mod.resolve(args.device)
    out_dir = out_dir or os.getcwd()
    cfg_yaml = settings.load_settings(args.settings)
    if cfg_yaml.cam2 is None or cfg_yaml.Tlr is None:
        raise SystemExit("settings file lacks camera2 / Stereo.T_c1_c2")
    first_seq = euroc.load_euroc(args.sequence[0], _sequence_file(args, 0))
    rig = rectify.build_rectification(cfg_yaml.cam1, cfg_yaml.cam2,
                                      cfg_yaml.Tlr)
    rig.prepare(dev, (cfg_yaml.cam1.height, cfg_yaml.cam1.width))
    voc = _vocabulary(args, dev)
    cfg = StereoConfig(
        fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy,
        width=cfg_yaml.cam1.width, height=cfg_yaml.cam1.height,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 20.0,
        vocabulary=voc, use_loop_closing=not args.no_loop_closing,
        max_kf=args.max_kf, max_lm=args.max_lm,
        bf=rig.bf, th_depth=cfg_yaml.th_depth or 35.0)
    use_imu = (not args.no_imu and cfg_yaml.imu is not None
               and first_seq.imu_stamps is not None)
    T_bc = None
    if use_imu:
        T_bc = (rectify.rectified_body_extrinsic(cfg_yaml.imu.Tbc, rig.R1)
                if repair_tbc else np.asarray(cfg_yaml.imu.Tbc))
        slam = StereoInertialSlam(cfg, _imu_config(cfg_yaml.imu, T_bc),
                                  device=dev)
    else:
        slam = StereoSlam(cfg, device=dev)
    timers = slam.enable_stage_timers()
    if on_system is not None:
        on_system(slam)

    frames = _Frames(dev)
    n_total = fcount = 0
    snapshots = []
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()   # multi-session (SLAM.ChangeDataset())
        ts_file = _sequence_file(args, si)
        seq_l = euroc.load_euroc(seq_dir, ts_file, cam="cam0")
        seq_r = euroc.load_euroc(seq_dir, ts_file, cam="cam1")
        n_frames = _n_frames(len(seq_l), args.max_frames)
        n_total += n_frames
        paths = [p for i in range(n_frames)
                 for p in (seq_l.image_paths[i], seq_r.image_paths[i])]
        pf = ImagePrefetcher(paths, device=dev)
        t_prev = None
        try:
            for idx in range(n_frames):
                frames.begin()
                (img_l, img_r), wait = _take(pf, 2)
                img_l, img_r = rig.rectify(img_l, img_r)
                frames.prepared(wait)
                t = float(seq_l.stamps[idx])
                if use_imu:
                    imu_data = (seq_l.imu_between(t_prev, t)
                                if t_prev is not None else None)
                    dt = _track_timed(timers, slam.track, img_l, img_r, t,
                                      imu_data)
                else:
                    dt = _track_timed(timers, slam.track, img_l, img_r, t)
                frames.tracked(t, dt)
                t_prev = t
                fcount += 1
                _after_frame(slam, args, fcount, out_dir, snapshots)
        finally:
            pf.close()
    wall = time.perf_counter() - t_start

    print(_summary(slam, n_total, wall, slam.imu_ready if use_imu else None))
    print(timers.report())
    outputs = _save_trajectories(slam, out_dir, args.output_name,
                                 stamp_scale=1e9)
    outputs.append(os.path.join(out_dir, "ExecTimeMean.txt"))
    timers.save(outputs[-1])
    outputs += snapshots
    return RunResult(slam, timers, n_total, wall, frames.records,
                     frames.device_ms(), rig, T_bc, outputs)


# -- KITTI ---------------------------------------------------------------------

def main_kitti(argv=None, *, out_dir=None, on_system=None) -> RunResult:
    """``scripts/run_kitti.py`` (mono_kitti.cc / stereo_kitti.cc): writes
    ``<name>_kitti.txt`` (the 3 x 4 camera-to-world rows) and the TUM
    ``f_<name>.txt``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--output-name", default="kitti")
    ap.add_argument("--vocabulary", default=default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    _device_arg(ap)
    args = ap.parse_args(argv)

    from . import device as device_mod
    from .io import kitti, settings, trajectory
    from .io.prefetch import ImagePrefetcher
    from .pipeline.stereo_system import StereoConfig, StereoSlam
    from .pipeline.system import MonoSlam, SlamConfig
    from .utils.timers import StageTimers

    dev = device_mod.resolve(args.device)
    out_dir = out_dir or os.getcwd()
    cfg_yaml = settings.load_settings(args.settings)
    seq = kitti.load_kitti(args.sequence)
    n = _n_frames(len(seq), args.max_frames)
    voc = _vocabulary(args, dev)
    cam = cfg_yaml.cam1
    common = dict(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 10.0,
        max_kf=args.max_kf, max_lm=args.max_lm, vocabulary=voc)
    if args.stereo:
        slam = StereoSlam(StereoConfig(**common, bf=cfg_yaml.bf or 386.1448,
                                       th_depth=cfg_yaml.th_depth or 35.0),
                          device=dev)
    else:
        slam = MonoSlam(SlamConfig(**common), device=dev)
    if on_system is not None:
        on_system(slam)

    timers = StageTimers()       # the loop's own records (nothing written)
    frames = _Frames(dev)
    per = 2 if args.stereo else 1
    paths = [p for i in range(n) for p in (
        (seq.left_paths[i], seq.right_paths[i]) if args.stereo
        else (seq.left_paths[i],))]
    pf = ImagePrefetcher(paths, device=dev)
    t_start = time.perf_counter()
    try:
        for i in range(n):
            frames.begin()
            imgs, wait = _take(pf, per)
            frames.prepared(wait)
            t = float(seq.stamps[i])
            frames.tracked(t, _track_timed(timers, slam.track, *imgs, t))
    finally:
        pf.close()
    wall = time.perf_counter() - t_start

    print(f"tracked {len(slam.trajectory)}/{n}; kf={slam.n_kf} "
          f"lm={slam.n_lm}")
    stamps = [s + slam.t0 for s, _, _ in slam.trajectory]
    Rs = [R for _, R, _ in slam.trajectory]
    ts = [t for _, _, t in slam.trajectory]
    outputs = [os.path.join(out_dir, f"{args.output_name}_kitti.txt"),
               os.path.join(out_dir, f"f_{args.output_name}.txt")]
    # KITTI format: row-major 3x4 of Twc per frame.
    with open(outputs[0], "w") as f:
        for R, t in zip(Rs, ts):
            Rwc = np.asarray(R).T
            twc = -Rwc @ np.asarray(t)
            P = np.concatenate([Rwc, twc[:, None]], 1).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in P) + "\n")
    trajectory.save_tum(outputs[1], stamps, Rs, ts)
    return RunResult(slam, timers, n, wall, frames.records,
                     frames.device_ms(), None, None, outputs)


# -- TUM RGB-D -----------------------------------------------------------------

def main_tum_rgbd(argv=None, *, out_dir=None, on_system=None) -> RunResult:
    """``scripts/run_tum_rgbd.py`` (rgbd_tum.cc): colour and depth
    associated by stamp (or an association file), the depth divided by the
    PNG factor on the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--associations", default=None)
    ap.add_argument("--output-name", default="rgbd")
    ap.add_argument("--vocabulary", default=default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    _device_arg(ap)
    args = ap.parse_args(argv)

    from . import device as device_mod
    from .io import settings, tum_rgbd
    from .io.prefetch import ImagePrefetcher
    from .pipeline.stereo_system import RgbdConfig, RgbdSlam
    from .utils.timers import StageTimers

    dev = device_mod.resolve(args.device)
    out_dir = out_dir or os.getcwd()
    cfg_yaml = settings.load_settings(args.settings)
    seq = tum_rgbd.load_tum_rgbd(args.sequence,
                                 association_file=args.associations)
    n = _n_frames(len(seq), args.max_frames)
    voc = _vocabulary(args, dev)
    cam = cfg_yaml.cam1
    slam = RgbdSlam(RgbdConfig(
        fx=float(cam.params[0]), fy=float(cam.params[1]),
        cx=float(cam.params[2]), cy=float(cam.params[3]),
        width=cam.width, height=cam.height, dist=cam.dist,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 30.0,
        max_kf=args.max_kf, max_lm=args.max_lm, vocabulary=voc,
        bf=cfg_yaml.bf or 40.0, th_depth=cfg_yaml.th_depth or 40.0,
        depth_scale=1.0), device=dev)  # the loop divides by the png factor
    if on_system is not None:
        on_system(slam)

    timers = StageTimers()       # the loop's own records (nothing written)
    frames = _Frames(dev)
    paths = [p for i in range(n) for p in (seq.rgb_paths[i],
                                           seq.depth_paths[i])]
    pf = ImagePrefetcher(paths, device=dev, modes=["grey", "unchanged"] * n)
    t_start = time.perf_counter()
    try:
        for i in range(n):
            frames.begin()
            (rgb, depth), wait = _take(pf, 2)
            depth = depth / seq.depth_factor
            frames.prepared(wait)
            t = float(seq.stamps[i])
            frames.tracked(t, _track_timed(timers, slam.track, rgb, depth,
                                           t))
    finally:
        pf.close()
    wall = time.perf_counter() - t_start

    print(f"tracked {len(slam.trajectory)}/{n}; kf={slam.n_kf} "
          f"lm={slam.n_lm}")
    outputs = _save_trajectories(slam, out_dir, args.output_name)
    return RunResult(slam, timers, n, wall, frames.records,
                     frames.device_ms(), None, None, outputs)


# -- TUM-VI --------------------------------------------------------------------

def main_tumvi(argv=None, *, out_dir=None, on_system=None) -> RunResult:
    """``scripts/run_tumvi.py`` (mono_inertial_tum_vi.cc,
    stereo_inertial_tum_vi.cc): the 512x512 Kannala-Brandt rig, CLAHE
    (clip 3, 8 x 8 tiles) on the device unless ``--no-clahe``, per-frame
    IMU batches, EuRoC-layout sequences."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence", nargs="+")
    ap.add_argument("--timestamps", nargs="*", default=None)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-lm", type=int, default=65536)
    ap.add_argument("--output-name", default="tumvi")
    ap.add_argument("--vocabulary", default=default_vocabulary())
    ap.add_argument("--no-vocabulary", action="store_true",
                    help="disable reloc/loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--no-clahe", action="store_true")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from . import device as device_mod
    from .io import euroc, settings
    from .io.prefetch import ImagePrefetcher
    from .ops.clahe import Clahe
    from .pipeline.inertial_system import MonoInertialSlam
    from .pipeline.stereo_inertial import FisheyeStereoInertialSlam
    from .pipeline.stereo_system import FisheyeStereoConfig, FisheyeStereoSlam
    from .pipeline.system import MonoSlam, SlamConfig

    dev = device_mod.resolve(args.device)
    out_dir = out_dir or os.getcwd()
    cfg_yaml = settings.load_settings(args.settings)
    cam1 = cfg_yaml.cam1
    kb8_1 = cam1.params[4:8] if cam1.model == "KannalaBrandt8" else None
    voc = _vocabulary(args, dev)
    common = dict(
        fx=float(cam1.params[0]), fy=float(cam1.params[1]),
        cx=float(cam1.params[2]), cy=float(cam1.params[3]),
        width=cam1.width, height=cam1.height, kb8=kb8_1,
        n_features=cfg_yaml.orb.n_features, fps=cfg_yaml.fps or 20.0,
        vocabulary=voc, max_kf=args.max_kf, max_lm=args.max_lm,
        use_loop_closing=not args.no_loop_closing)
    use_imu = not args.no_imu and cfg_yaml.imu is not None
    imu_cfg = _imu_config(cfg_yaml.imu) if use_imu else None
    if args.stereo:
        cam2 = cfg_yaml.cam2
        if cam2 is None or cfg_yaml.Tlr is None:
            raise SystemExit("stereo requested but settings lack "
                             "Camera2 / Stereo.T_c1_c2")
        Tlr = np.asarray(cfg_yaml.Tlr, np.float64)   # x_c1 = Tlr x_c2
        cfg = FisheyeStereoConfig(
            **common, cam2=cam2.params[:4].astype(np.float32),
            kb8_2=(cam2.params[4:8] if cam2.model == "KannalaBrandt8"
                   else None),
            dist2=cam2.dist,
            R_rl=Tlr[:3, :3].T.astype(np.float32),
            t_rl=(-Tlr[:3, :3].T @ Tlr[:3, 3]).astype(np.float32),
            bf=float(np.linalg.norm(Tlr[:3, 3]) * cam1.params[0]),
            th_depth=cfg_yaml.th_depth or 35.0)
        slam = (FisheyeStereoInertialSlam(cfg, imu_cfg, device=dev)
                if use_imu else FisheyeStereoSlam(cfg, device=dev))
    else:
        cfg = SlamConfig(**common)
        slam = (MonoInertialSlam(cfg, imu_cfg, device=dev) if use_imu
                else MonoSlam(cfg, device=dev))
    clahe = None if args.no_clahe else Clahe(3.0, (8, 8))
    timers = slam.enable_stage_timers()
    if on_system is not None:
        on_system(slam)

    frames = _Frames(dev)
    per = 2 if args.stereo else 1
    n_total = 0
    t_start = time.perf_counter()
    for si, seq_dir in enumerate(args.sequence):
        if si > 0:
            slam.change_dataset()
        ts_file = _sequence_file(args, si)
        seq_l = euroc.load_euroc(seq_dir, ts_file, cam="cam0")
        seq_r = (euroc.load_euroc(seq_dir, ts_file, cam="cam1")
                 if args.stereo else None)
        n_frames = _n_frames(len(seq_l), args.max_frames)
        n_total += n_frames
        paths = [p for i in range(n_frames) for p in (
            (seq_l.image_paths[i], seq_r.image_paths[i]) if args.stereo
            else (seq_l.image_paths[i],))]
        pf = ImagePrefetcher(paths, device=dev)
        t_prev = None
        try:
            for idx in range(n_frames):
                frames.begin()
                imgs, wait = _take(pf, per)
                if clahe is not None:
                    imgs = [clahe.apply(im) for im in imgs]
                frames.prepared(wait)
                t = float(seq_l.stamps[idx])
                imu = ((seq_l.imu_between(t_prev, t)
                        if t_prev is not None else None),) if use_imu else ()
                frames.tracked(t, _track_timed(timers, slam.track, *imgs, t,
                                               *imu))
                t_prev = t
        finally:
            pf.close()
    wall = time.perf_counter() - t_start

    print(_summary(slam, n_total, wall, slam.imu_ready if use_imu else None))
    print(timers.report())
    outputs = _save_trajectories(slam, out_dir, args.output_name,
                                 stamp_scale=1e9)
    outputs.append(os.path.join(out_dir, "ExecTimeMean.txt"))
    timers.save(outputs[-1])
    return RunResult(slam, timers, n_total, wall, frames.records,
                     frames.device_ms(), None,
                     imu_cfg.T_bc if use_imu else None, outputs)
