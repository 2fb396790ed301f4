#!/usr/bin/env python3
"""Write the visual-inertial runs' frames and IMU samples as fixtures for
the PyTorch port.

    python scripts/make_torch_vi_frames.py

The JAX package's inertial system tests track ``SynthWorld(motion=
"excited")`` with a 200 Hz IMU: ``tests/test_stereo_inertial.py`` a
rectified pair of ``SynthWorld(seed=11)`` (baseline 0.2 m) at t =
``np.arange(0, 4.0, 0.1)`` with the IMU noise drawn from
``default_rng(5)``, ``tests/test_inertial_system.py`` the monocular frames
of ``SynthWorld(seed=3)`` at ``np.arange(0, 6.5, 0.1)`` with
``default_rng(7)``. Each frame after the first comes with the samples in
(t_prev, t], drawn with ``SynthWorld.imu`` at the per-sample noise
``density x sqrt(freq)`` of ``ImuConfig``'s defaults. Rendering needs
OpenCV, which a machine that only runs the port may lack, so the frames
are committed:

  * ``tests/golden/frames_vi_stereo.npz``: ``left``, ``right`` (40, 480,
    640) uint8;
  * ``tests/golden/frames_vi_mono.npz``: ``frames`` (65, 480, 640) uint8;

and in both:

  * ``stamps``: (F,) float64 seconds, the tests' ``np.arange`` values as
    they are (not rounded: the IMU windows follow from them);
  * ``R``, ``t``: (F, 3, 3) and (F, 3) float32, each frame's true
    world-to-camera pose (the left camera); ``centres``, ``vel``: (F, 3)
    float64, its true camera centre and world velocity;
  * ``imu_t`` (M,) float64, ``imu_gyr``, ``imu_acc`` (M, 3) float32: the
    samples of every frame, in order; ``imu_start`` (F + 1,) int64: frame
    i's samples are rows ``imu_start[i]:imu_start[i + 1]`` (none for
    frame 0);
  * ``camera``: (6,) float64, fx, fy, cx, cy, width, height; ``imu``: (5,)
    float64, the gyro and accelerometer noise densities, the walks and the
    rate of ``ImuConfig``'s defaults, which drew the noise;
  * stereo only: ``baseline`` in m.

``orbslam3_byzyh_tpu_torch.graft.vi_stereo_frames()`` and
``vi_mono_frames()`` load them; ``tests/test_torch_mono_inertial_system.py``
re-renders both and checks them bit for bit.
"""

import copy
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT_STEREO = os.path.join(ROOT, "tests", "golden", "frames_vi_stereo.npz")
OUT_MONO = os.path.join(ROOT, "tests", "golden", "frames_vi_mono.npz")
BASELINE = 0.2
# ImuConfig's defaults: gyro / accel noise density, gyro / accel walk, Hz.
IMU = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, 200.0)
# (world seed, stamps, noise seed) of each fixture.
STEREO = (11, np.arange(0, 4.0, 0.1), 5)
MONO = (3, np.arange(0, 6.5, 0.1), 7)


def _uint8(img: np.ndarray, what: str) -> np.ndarray:
    out = img.astype(np.uint8)
    if not np.array_equal(out, img):
        raise ValueError(f"{what} is not whole numbers in 0..255")
    return out


def vi_arrays(kind: str) -> dict:
    """One fixture's arrays (``kind`` "stereo" or "mono"), rendered with
    ``tests/synth_world.py``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_world import SynthWorld

    seed, stamps, noise_seed = STEREO if kind == "stereo" else MONO
    world = SynthWorld(seed=seed, motion="excited")
    gn, an, _, _, freq = IMU
    rng = np.random.default_rng(noise_seed)
    left, right, Rs, ts, centres, vels = [], [], [], [], [], []
    imu_t, imu_g, imu_a, start = [], [], [], [0]
    t_prev = None
    for s in stamps:
        s = float(s)
        R, t = world.pose(s)
        left.append(_uint8(world.render(s), f"frame at {s:.1f} s"))
        if kind == "stereo":
            wr = copy.copy(world)
            wr.pose = lambda _t, R=R, t=t: (R, t - np.array(
                [BASELINE, 0, 0], np.float32))
            right.append(_uint8(wr.render(s), f"right at {s:.1f} s"))
        if t_prev is not None:
            st, g, a = world.imu(t_prev, s, freq=freq,
                                 gyro_noise=gn * np.sqrt(freq),
                                 acc_noise=an * np.sqrt(freq), rng=rng)
            imu_t.append(st)
            imu_g.append(g)
            imu_a.append(a)
            start.append(start[-1] + len(st))
        else:
            start.append(0)
        pos, vel, _, _ = world.trajectory(s)
        Rs.append(R)
        ts.append(t)
        centres.append(np.asarray(pos, np.float64))
        vels.append(np.asarray(vel, np.float64))
        t_prev = s
    out = dict(stamps=np.asarray(stamps, np.float64),
               R=np.stack(Rs).astype(np.float32),
               t=np.stack(ts).astype(np.float32), centres=np.stack(centres),
               vel=np.stack(vels), imu_t=np.concatenate(imu_t),
               imu_gyr=np.concatenate(imu_g).astype(np.float32),
               imu_acc=np.concatenate(imu_a).astype(np.float32),
               imu_start=np.asarray(start, np.int64),
               camera=np.array([world.fx, world.fy, world.cx, world.cy,
                                world.w, world.h], np.float64),
               imu=np.array(IMU, np.float64))
    if kind == "stereo":
        out.update(left=np.stack(left), right=np.stack(right),
                   baseline=np.float64(BASELINE))
    else:
        out.update(frames=np.stack(left))
    return out


def main() -> int:
    for kind, path in (("stereo", OUT_STEREO), ("mono", OUT_MONO)):
        arrays = vi_arrays(kind)
        np.savez_compressed(path, **arrays)
        print(f"wrote {os.path.relpath(path)}: {len(arrays['stamps'])} "
              f"frames, {len(arrays['imu_t'])} IMU samples, "
              f"{os.path.getsize(path) / 1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
