#!/usr/bin/env python3
"""Write the stereo and RGB-D runs' frames as a fixture for the PyTorch port.

    python scripts/make_torch_stereo_frames.py

The stereo system test (``tests/test_stereo_system.py``) tracks a rectified
pair of ``SynthWorld(seed=11)`` with a 0.2 m baseline at t = 0.0, 0.1, ...,
2.9 s. Rendering needs OpenCV, which a machine that only runs the port may
lack, so the frames are committed: ``tests/golden/frames_stereo.npz`` holds

  * ``left``, ``right``: (30, 480, 640) uint8, the rendered pair (the right
    camera's centre 0.2 m along the left camera's x axis, the same
    rotation);
  * ``depth``: (30, 480, 640) uint16, the left camera's depth image at
    TUM's DepthMapFactor 5000 (z in m x 5000, rounded; 0 where no shape is
    drawn), drawn with the renderer's own shapes in its far-first order;
  * ``stamps``: (30,) float64 seconds;
  * ``R``, ``t``: (30, 3, 3) and (30, 3) float32, each frame's true
    world-to-camera pose (the left camera);
  * ``centres``: (30, 3) float64, each frame's true left camera centre;
  * ``camera``: (6,) float64, fx, fy, cx, cy, width, height;
  * ``baseline``: the rig's baseline in m; ``depth_factor``: 5000.

``orbslam3_byzyh_tpu_torch.graft.stereo_frames()`` loads it;
``tests/test_torch_stereo_system.py`` re-renders it and checks it bit for
bit.
"""

import copy
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "golden", "frames_stereo.npz")
SEED = 11
BASELINE = 0.2
DEPTH_FACTOR = 5000.0
STAMPS = np.round(np.arange(0, 3.0, 0.1), 3)


def render_depth(world, t: float) -> np.ndarray:
    """The left camera's depth image: ``SynthWorld.render``'s shapes (blob
    and satellites) in its far-first order, filled with round(z x 5000)
    instead of their intensity, with no blur; 0 where nothing is drawn."""
    import cv2

    R, tt = world.pose(t)
    pc = world.pts @ R.T + tt
    z = pc[:, 2]
    vis = z > 0.5
    u = world.fx * pc[:, 0] / np.maximum(z, 1e-6) + world.cx
    v = world.fy * pc[:, 1] / np.maximum(z, 1e-6) + world.cy
    img = np.zeros((world.h, world.w), np.uint16)
    for i in np.argsort(-z):
        if not vis[i]:
            continue
        ui, vi = int(round(u[i])), int(round(v[i]))
        if not (-10 <= ui < world.w + 10 and -10 <= vi < world.h + 10):
            continue
        r = max(3, int(round(world.sizes[i] * 8.0 / z[i])))
        val = int(round(z[i] * DEPTH_FACTOR))
        if val > np.iinfo(np.uint16).max:
            raise ValueError(f"depth {z[i]:.2f} m beyond uint16 at "
                             f"{DEPTH_FACTOR}")
        if world.shapes[i] == 0:
            cv2.circle(img, (ui, vi), r, val, -1)
        elif world.shapes[i] == 1:
            cv2.rectangle(img, (ui - r, vi - r), (ui + r, vi + r), val, -1)
        else:
            pts = np.array([[ui, vi - r], [ui - r, vi + r], [ui + r, vi + r]])
            cv2.fillConvexPoly(img, pts, val)
        for s in range(4):
            su = int(round(ui + world.sat_off[i, s, 0] * r))
            sv = int(round(vi + world.sat_off[i, s, 1] * r))
            cv2.circle(img, (su, sv), max(1, r // 3), val, -1)
    return img


def _uint8(img: np.ndarray, what: str) -> np.ndarray:
    out = img.astype(np.uint8)
    if not np.array_equal(out, img):
        raise ValueError(f"{what} is not whole numbers in 0..255")
    return out


def stereo_arrays() -> dict:
    """The fixture's arrays, rendered with ``tests/synth_world.py``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_world import SynthWorld

    world = SynthWorld(seed=SEED)
    left, right, depth, Rs, ts, centres = [], [], [], [], [], []
    for s in STAMPS:
        R, t = world.pose(float(s))
        left.append(_uint8(world.render(float(s)), f"left at {s:.1f} s"))
        wr = copy.copy(world)
        wr.pose = lambda _t, R=R, t=t: (R, t - np.array([BASELINE, 0, 0],
                                                        np.float32))
        right.append(_uint8(wr.render(float(s)), f"right at {s:.1f} s"))
        depth.append(render_depth(world, float(s)))
        Rs.append(R)
        ts.append(t)
        centres.append(-R.astype(np.float64).T @ t.astype(np.float64))
    return dict(left=np.stack(left), right=np.stack(right),
                depth=np.stack(depth), stamps=STAMPS.astype(np.float64),
                R=np.stack(Rs).astype(np.float32),
                t=np.stack(ts).astype(np.float32), centres=np.stack(centres),
                camera=np.array([world.fx, world.fy, world.cx, world.cy,
                                 world.w, world.h], np.float64),
                baseline=np.float64(BASELINE),
                depth_factor=np.float64(DEPTH_FACTOR))


def main() -> int:
    arrays = stereo_arrays()
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.relpath(OUT)}: {arrays['left'].shape} pairs and "
          f"depth images, {os.path.getsize(OUT) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
