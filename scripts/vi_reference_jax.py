#!/usr/bin/env python3
"""The JAX package's inertial systems on the committed visual-inertial
frames: the reference results the PyTorch port's runs are held to.

    JAX_PLATFORMS=cpu python scripts/vi_reference_jax.py stereo
    JAX_PLATFORMS=cpu python scripts/vi_reference_jax.py mono

Runs ``orbslam3_byzyh_tpu``'s ``StereoInertialSlam`` on
``tests/golden/frames_vi_stereo.npz`` at ``tests/test_stereo_inertial.py``'s
settings, or ``MonoInertialSlam`` on ``tests/golden/frames_vi_mono.npz`` at
``tests/test_inertial_system.py``'s (loop closing and the background GBA
off, as without a vocabulary), each frame with its IMU samples, and prints
one JSON line with the port's ``graft.vi_gates`` measures (numpy only):
the frames tracked, the ATE (stereo: camera centres without scale
alignment; mono: after t = 3 s, Horn-scaled, with the scale and the
gravity axis's error), the largest single-frame error against its p90,
the speed error at the last frame, ``imu_ready`` and ``viba_stage``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("stereo", "mono"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
    from orbslam3_byzyh_tpu.pipeline import system as jsys
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
        StereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import StereoConfig

    from orbslam3_byzyh_tpu_torch import graft

    g = (graft.vi_stereo_frames() if args.kind == "stereo"
         else graft.vi_mono_frames())
    fx, fy, cx, cy, w, h = g.camera
    common = dict(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                  width=int(w), height=int(h), fps=10, kf_ref_min_obs=1,
                  max_lm=4096, max_obs=8, use_loop_closing=False,
                  background_gba=False, device_mesh=False)
    imu_cfg = jvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32))
    vw = dict(viba_window=12, viba_free=6, viba_landmarks=1024,
              full_viba_kf=32)
    if args.kind == "stereo":
        slam = StereoInertialSlam(StereoConfig(
            **common, n_features=1024, max_kf=48,
            bf=0.2 * float(fx), th_depth=35.0), imu_cfg,
            **vw)
        images = list(zip(g.left, g.right))
    else:
        slam = jvi.MonoInertialSlam(jsys.SlamConfig(
            **common, n_features=1536, max_kf=64, min_init_matches=60),
            imu_cfg, **vw)
        images = [(f,) for f in g.left]
    t_start = time.perf_counter()
    for i, (imgs, s) in enumerate(zip(images, g.stamps)):
        slam.track(*imgs, float(s), g.imu(i))
    traj = slam.trajectory
    out = graft.vi_gates(args.kind, traj, slam.t0, g,
                         np.asarray(slam._body[2]))
    out.update(kind=args.kind, imu_ready=bool(slam.imu_ready),
               viba_stage=int(slam.viba_stage),
               live_keyframes=int(np.asarray(slam.state.kfs.valid).sum()),
               seconds=time.perf_counter() - t_start)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
