#!/usr/bin/env python3
"""The JAX package's ``MonoSlam`` with the chessboard world frame on the
committed chessboard frames: the reference run the PyTorch port's cell (n)
is held to.

    JAX_PLATFORMS=cpu python scripts/chessboard_reference_jax.py full
    JAX_PLATFORMS=cpu python scripts/chessboard_reference_jax.py half

Runs ``orbslam3_byzyh_tpu``'s ``MonoSlam`` at the port's
``graft.chessboard_golden_config`` (Mycamera's intrinsics and radtan, 1000
features, the board; ``half``: the 640x512 frames with the intrinsics
halved) with the map cut to ``graft.CHESS_CPU_SLOTS`` (the JAX init's
one-hot Schur does not fit 1,024 keyframe slots), on
``tests/golden/frames_chessboard.npz``. The JAX system poses the board from
the distorted corners (its ``_snoop_chessboard`` passes no distortion);
the port undistorts them first. Prints one JSON line: each frame's status
and keyframe count; the frame whose snoop found the board, its pose and
that pose's error against the truth up to the board's symmetry; the frame
of the first initialisation and of its keyframe 0 (the reference frame);
the frame of the rebase; the keyframes at the end; each tracked frame's rotation error
against the truth in the board's frame; the ATE after the scale fit about
keyframe 0's centre (``graft.chessboard_scale_ate``); and on each frame
OpenCV found the board on, the JAX function's board pose (distorted
corners, K alone) and the port's (the same corners undistorted) against
the truth.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("size", choices=("full", "half"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.pipeline import system as jsys
    from orbslam3_byzyh_tpu.utils import chessboard as jcb

    from orbslam3_byzyh_tpu_torch import graft

    half = args.size == "half"
    f = graft.chessboard_frames()
    frames = f.frames_half if half else f.frames
    cfg = graft.chessboard_golden_config(half=half, **graft.CHESS_CPU_SLOTS)
    fields = dataclasses.asdict(dataclasses.replace(cfg, chessboard=None))
    board = jcb.ChessboardConfig(**dataclasses.asdict(cfg.chessboard))
    fields.update(chessboard=board, device_mesh=False)
    slam = jsys.MonoSlam(jsys.SlamConfig(**fields))

    at = {"frame": 0}
    events = {}
    snoop, rebase = slam._snoop_chessboard, slam._apply_chessboard_rebase

    def spy_snoop(img):
        snoop(img)
        if slam._chess_pose is not None and "snoop" not in events:
            events["snoop"] = at["frame"]

    def spy_rebase():
        events.setdefault("rebase", at["frame"])
        return rebase()

    slam._snoop_chessboard = spy_snoop
    slam._apply_chessboard_rebase = spy_rebase
    records = []
    t_start = time.perf_counter()
    for i, (img, s) in enumerate(zip(frames, f.stamps)):
        at["frame"] = i
        was = slam.status
        slam.track(img, float(s))
        if (was == jsys.NOT_INITIALIZED and slam.status != was
                and "init" not in events):
            events["init"] = i
            events["kf0"] = int(np.argmin(np.abs(
                f.stamps - (slam._init_stamp + slam.t0))))
        records.append(dict(stamp=float(s), before=int(was),
                            status=int(slam.status), n_kf=int(slam.n_kf)))
    traj = slam.trajectory
    seconds = time.perf_counter() - t_start
    out = dict(size=args.size, slots=graft.CHESS_CPU_SLOTS, frames=records,
               n_frames=len(traj), seconds=seconds, **events,
               n_kf=int(slam.n_kf))
    if slam._chess_pose is not None:
        R, t = (np.asarray(x, np.float64) for x in slam._chess_pose)
        k = events["snoop"]
        ang, cen, flipped = graft.chessboard_pose_error(
            R, t, f.R[k], f.t[k], cfg.chessboard)
        out.update(pose_R=R.tolist(), pose_t=t.tolist(), pose_deg=ang,
                   pose_m=cen, flipped=flipped)
        if slam._chess_applied and traj:
            st = [s for s, _, _ in traj]
            Rs = [np.asarray(r) for _, r, _ in traj]
            ts = [np.asarray(x) for _, _, x in traj]
            idx = [int(np.argmin(np.abs(f.stamps - (s + slam.t0))))
                   for s in st]
            out["rot_deg"] = [graft.chessboard_pose_error(
                r, x, f.R[i], f.t[i], cfg.chessboard)[0]
                for r, x, i in zip(Rs, ts, idx)]
            out["traj_frames"] = idx
            out.update(graft.chessboard_scale_ate(st, Rs, ts, f, slam.t0,
                                                  flipped, cfg.chessboard))
    # The distortion repair: on each frame OpenCV found the board on, the
    # JAX function's pose of the distorted corners and the port's pose of
    # the same corners undistorted, each against the truth (deg, m).
    from orbslam3_byzyh_tpu_torch.utils import chessboard as tcb
    cam = f.camera
    k = 0.5 if half else 1.0
    K = np.array([[cam[0] * k, 0, cam[2] * k], [0, cam[1] * k, cam[3] * k],
                  [0, 0, 1.0]])
    cv = f.cv_corners_half if half else f.cv_corners
    out["distortion_repair"] = []
    for i in np.flatnonzero(np.isfinite(cv).all((1, 2))):
        pj = jcb.pose_from_chessboard(cv[i], board, K)
        pt = tcb.pose_from_chessboard(cv[i], cfg.chessboard, K,
                                      dist=cam[6:10], device="cpu")
        out["distortion_repair"].append(dict(
            frame=int(i),
            jax=graft.chessboard_pose_error(*pj, f.R[i], f.t[i],
                                            cfg.chessboard)[:2],
            port=graft.chessboard_pose_error(*pt, f.R[i], f.t[i],
                                             cfg.chessboard)[:2]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
