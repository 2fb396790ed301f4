#!/usr/bin/env python3
"""Write the golden run's frames as a fixture for the PyTorch port.

    python scripts/make_torch_golden_frames.py

The golden regression config (``tests/test_golden.py``) tracks
``SynthWorld(seed=3)`` at t = 0.0, 0.1, ..., 4.4 s. Rendering needs OpenCV,
which a machine that only runs the port may lack, so the frames are
committed: ``tests/golden/frames_golden_mono.npz`` holds

  * ``frames``: (45, 480, 640) uint8, the rendered images (``render``
    returns whole numbers as float32, so uint8 keeps them exactly);
  * ``stamps``: (45,) float64 seconds;
  * ``R``, ``t``: (45, 3, 3) and (45, 3) float32, each frame's true
    world-to-camera pose;
  * ``centres``: (45, 3) float64, each frame's true camera centre;
  * ``camera``: (6,) float64, fx, fy, cx, cy, width, height.

``orbslam3_byzyh_tpu_torch.graft.golden_frames()`` loads it;
``tests/test_torch_atlas_traj.py`` re-renders the frames and checks that
they are bit-equal to the file.
"""

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "golden", "frames_golden_mono.npz")


def golden_arrays() -> dict:
    """The fixture's arrays, rendered with ``tests/synth_world.py``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_world import SynthWorld

    world = SynthWorld(seed=3)
    stamps = np.arange(0, 4.5, 0.1)
    frames, Rs, ts, centres = [], [], [], []
    for s in stamps:
        img = world.render(float(s))
        frame = img.astype(np.uint8)
        if not np.array_equal(frame, img):
            raise ValueError(f"frame at {s:.1f} s is not whole numbers in "
                             "0..255")
        R, t = world.pose(float(s))
        frames.append(frame)
        Rs.append(R)
        ts.append(t)
        centres.append(-R.astype(np.float64).T @ t.astype(np.float64))
    return dict(frames=np.stack(frames), stamps=stamps,
                R=np.stack(Rs).astype(np.float32),
                t=np.stack(ts).astype(np.float32),
                centres=np.stack(centres),
                camera=np.array([world.fx, world.fy, world.cx, world.cy,
                                 world.w, world.h], np.float64))


def main() -> int:
    arrays = golden_arrays()
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.relpath(OUT)}: {arrays['frames'].shape} frames, "
          f"{os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
