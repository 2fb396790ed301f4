#!/usr/bin/env python3
"""The JAX package's stereo or RGB-D system on the committed stereo frames:
the reference result the PyTorch port's runs are held to.

    JAX_PLATFORMS=cpu python scripts/stereo_reference_jax.py rgbd
    JAX_PLATFORMS=cpu python scripts/stereo_reference_jax.py stereo

Runs ``orbslam3_byzyh_tpu``'s ``RgbdSlam`` (the left frames and depth
images of ``tests/golden/frames_stereo.npz`` at TUM1's RGB-D settings, as
``graft.tum_rgbd_golden_config``) or ``StereoSlam`` (the pairs at
``tests/test_stereo_system.py``'s settings) with loop closing off, and
prints one JSON line: the frames tracked, the ATE without scale alignment
(m), the path length against the truth's, live keyframes and landmarks.
``--max-kf`` / ``--max-lm`` set the map's slots (default 64 and 16384:
smaller than the port's cells, so that the run fits a workstation's
memory; a run of 30 frames fills neither, and the slot counts change no
decision of the system).
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
    ap.add_argument("mode", choices=("rgbd", "stereo"))
    ap.add_argument("--max-kf", type=int, default=64)
    ap.add_argument("--max-lm", type=int, default=16384)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.pipeline import stereo_system as jst
    from orbslam3_byzyh_tpu.utils import evaluate

    with np.load(os.path.join(ROOT, "tests", "golden",
                              "frames_stereo.npz")) as z:
        g = {k: z[k] for k in z.files}
    fx, fy, cx, cy, w, h = g["camera"]
    common = dict(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                  width=int(w), height=int(h), fps=10, kf_ref_min_obs=1,
                  max_kf=args.max_kf, max_lm=args.max_lm,
                  use_loop_closing=False, background_gba=False,
                  device_mesh=False)
    if args.mode == "rgbd":
        slam = jst.RgbdSlam(jst.RgbdConfig(
            **common, n_features=1000, max_obs=12, bf=40.0, th_depth=40.0,
            depth_scale=float(g["depth_factor"])))
        second = g["depth"]
    else:
        slam = jst.StereoSlam(jst.StereoConfig(
            **common, n_features=1024, max_obs=8,
            bf=float(g["baseline"]) * float(fx), th_depth=35.0))
        second = g["right"]
    t0 = time.perf_counter()
    for img, img2, s in zip(g["left"], second, g["stamps"]):
        slam.track(img.astype(np.float32), img2, float(s))
    traj = slam.trajectory
    stamps = np.array([s for s, _, _ in traj]) + slam.t0
    est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                  np.stack([t for _, _, t in traj]))
    ate, n_assoc = evaluate.ate_rmse(stamps, est, g["stamps"], g["centres"],
                                     with_scale=False)
    idx = np.searchsorted(g["stamps"], stamps - 1e-6)
    length = float(np.linalg.norm(np.diff(est, axis=0), axis=-1).sum())
    true_len = float(np.linalg.norm(np.diff(g["centres"][idx], axis=0),
                                    axis=-1).sum())
    print(json.dumps({
        "mode": args.mode, "frames": len(traj), "associated": int(n_assoc),
        "ate_m": float(ate), "path_m": length, "true_path_m": true_len,
        "live_keyframes": int(np.asarray(slam.state.kfs.valid).sum()),
        "live_landmarks": int(np.asarray(slam.state.lms.valid).sum()),
        "max_kf": args.max_kf, "max_lm": args.max_lm,
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
