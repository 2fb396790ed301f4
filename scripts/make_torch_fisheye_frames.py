#!/usr/bin/env python3
"""Write the non-rectified (fisheye) stereo run's frames as a fixture for
the PyTorch port.

    python scripts/make_torch_fisheye_frames.py

The JAX package's non-rectified stereo test
(``tests/test_fisheye_stereo_system.py``) tracks ``SynthWorld(seed=13)``
through a left pinhole camera and a right one whose centre sits 0.2 m
along the left camera's x axis and which is yawed 3 degrees about its y
axis, at t = ``np.arange(0, 3.0, 0.1)``. Rendering needs OpenCV, which a
machine that only runs the port may lack, so the frames are committed:
``tests/golden/frames_fisheye.npz`` holds

  * ``left``, ``right``: (30, 480, 640) uint8, the rendered pair;
  * ``stamps``: (30,) float64 seconds, the test's ``np.arange`` values;
  * ``R``, ``t``: (30, 3, 3) and (30, 3) float32, each frame's true
    world-to-camera pose (the left camera); ``centres``: (30, 3) float64,
    its true camera centre;
  * ``camera``: (6,) float64, fx, fy, cx, cy, width, height;
  * ``R_rl``, ``t_rl``: (3, 3) and (3,) float32, the left -> right camera
    transform (x_r = R_rl x_l + t_rl: R_d and R_d (-0.2, 0, 0) with R_d
    the 3-degree yaw);
  * ``vi_depth0``: (480, 640) uint16, the depth image (z x 5000, 0 where
    nothing is drawn, as ``make_torch_stereo_frames.render_depth`` draws
    it) of ``tests/golden/frames_vi_stereo.npz``'s first left frame
    (``SynthWorld(seed=11, motion="excited")`` at t = 0): the truth of the
    TUM-VI extraction step on that pair; ``depth_factor``: 5000.

The Kannala-Brandt frames are not committed: ``graft.kb8_warp`` makes them
from the committed pinhole frames. ``orbslam3_byzyh_tpu_torch.graft.
fisheye_frames()`` loads the fixture;
``tests/test_torch_fisheye_stereo_system.py`` re-renders it and checks it
bit for bit.
"""

import copy
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "golden", "frames_fisheye.npz")
SEED = 13
BASELINE = 0.2
YAW_DEG = 3.0
STAMPS = np.arange(0, 3.0, 0.1)
# The stereo-inertial fixture's world (scripts/make_torch_vi_frames.py).
VI_SEED = 11


def yaw_rotation(deg: float) -> np.ndarray:
    """The rotation by ``deg`` degrees about the camera's y axis (float32)."""
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                     [-np.sin(a), 0.0, np.cos(a)]]).astype(np.float32)


def fisheye_arrays() -> dict:
    """The fixture's arrays, rendered with ``tests/synth_world.py``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_torch_stereo_frames import DEPTH_FACTOR, _uint8, render_depth
    from synth_world import SynthWorld

    world = SynthWorld(seed=SEED)
    R_d = yaw_rotation(YAW_DEG)
    t_rl = (R_d @ np.array([-BASELINE, 0, 0], np.float32)).astype(np.float32)
    left, right, Rs, ts, centres = [], [], [], [], []
    for s in STAMPS:
        R, t = world.pose(float(s))
        left.append(_uint8(world.render(float(s)), f"left at {s:.1f} s"))
        wr = copy.copy(world)
        t_r = R_d @ (t - np.array([BASELINE, 0, 0], np.float32))
        wr.pose = lambda _t, Rr=(R_d @ R), tr=t_r: (Rr, tr)
        right.append(_uint8(wr.render(float(s)), f"right at {s:.1f} s"))
        Rs.append(R)
        ts.append(t)
        centres.append(-R.astype(np.float64).T @ t.astype(np.float64))
    vi_world = SynthWorld(seed=VI_SEED, motion="excited")
    return dict(left=np.stack(left), right=np.stack(right),
                stamps=STAMPS.astype(np.float64),
                R=np.stack(Rs).astype(np.float32),
                t=np.stack(ts).astype(np.float32), centres=np.stack(centres),
                camera=np.array([world.fx, world.fy, world.cx, world.cy,
                                 world.w, world.h], np.float64),
                R_rl=R_d, t_rl=t_rl, vi_depth0=render_depth(vi_world, 0.0),
                depth_factor=np.float64(DEPTH_FACTOR))


def main() -> int:
    arrays = fisheye_arrays()
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.relpath(OUT)}: {arrays['left'].shape} pairs, "
          f"{os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
