#!/usr/bin/env python3
"""The JAX package's non-rectified (fisheye) stereo systems on the
committed frames: the reference results the PyTorch port's runs are held
to.

    JAX_PLATFORMS=cpu python scripts/fisheye_reference_jax.py stereo
    JAX_PLATFORMS=cpu python scripts/fisheye_reference_jax.py vi

``stereo``: ``orbslam3_byzyh_tpu``'s ``FisheyeStereoSlam`` on
``tests/golden/frames_fisheye.npz`` at
``tests/test_fisheye_stereo_system.py``'s settings
(``graft.fisheye_stereo_golden_config``); prints the frames
tracked, the ATE of the camera centres without scale alignment, the path
length's error against the truth's, live keyframes and landmarks.

``vi``: ``FisheyeStereoInertialSlam`` on the stereo-inertial fixture's
frames seen through TUM-VI's 512x512 Kannala-Brandt pair
(``graft.tumvi_vi_frames``), each frame with its IMU samples, at
``graft.tumvi_vi_golden_config``'s cameras, rig, 1000 features, ThDepth
and init gates, with the map cut to the inertial tests' 48 keyframe / 4096
landmark slots, 8 observations and VI-BA 12 / 6 / 1024 / 32 (so that the
run fits a workstation's memory; 40 frames fill neither); prints
``graft.vi_gates("stereo", ...)``'s measures with ``imu_ready`` and
``viba_stage``.

Loop closing and the background GBA are off, as without a vocabulary.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _jax_config(cfg, **changes):
    """The port's ``FisheyeStereoConfig`` as the JAX package's, loop
    closing and the background GBA off."""
    from orbslam3_byzyh_tpu.pipeline.stereo_system import FisheyeStereoConfig
    fields = dataclasses.asdict(cfg)
    fields.update(use_loop_closing=False, background_gba=False,
                  device_mesh=False, **changes)
    return FisheyeStereoConfig(**fields)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("stereo", "vi"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
        FisheyeStereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import FisheyeStereoSlam

    from orbslam3_byzyh_tpu_torch import graft

    t_start = time.perf_counter()
    if args.kind == "stereo":
        g = graft.fisheye_frames()
        slam = FisheyeStereoSlam(_jax_config(
            graft.fisheye_stereo_golden_config(g)))
        for l_, r_, s in zip(g.left, g.right, g.stamps):
            slam.track(l_, r_, float(s))
        out = graft.fisheye_gates(slam.trajectory, slam.t0, g)
        out.update(
            live_keyframes=int(np.asarray(slam.state.kfs.valid).sum()),
            live_landmarks=int(np.asarray(slam.state.lms.valid).sum()))
    else:
        g = graft.tumvi_vi_frames()
        setup = graft.tumvi_vi_golden_config()
        imu = jvi.ImuConfig(**dataclasses.asdict(setup.imu))
        slam = FisheyeStereoInertialSlam(
            _jax_config(setup.config, **graft.TUMVI_VI_CPU_SLOTS), imu,
            **graft.TUMVI_VI_CPU_VIBA)
        for i, (l_, r_, s) in enumerate(zip(g.left, g.right, g.stamps)):
            slam.track(l_, r_, float(s), g.imu(i))
        traj = slam.trajectory
        out = graft.vi_gates("stereo", traj, slam.t0, g,
                             np.asarray(slam._body[2]))
        out.update(imu_ready=bool(slam.imu_ready),
                   viba_stage=int(slam.viba_stage),
                   live_keyframes=int(np.asarray(slam.state.kfs.valid).sum()))
    out.update(kind=args.kind, seconds=time.perf_counter() - t_start)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
