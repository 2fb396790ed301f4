"""Trajectory files in the TUM format of ORB-SLAM3's
``System::SaveTrajectoryEuRoC``: one ``timestamp tx ty tz qx qy qz qw`` line
per pose, the camera's pose in the world (Twc), the stamps in the dataset's
unit (EuRoC: nanoseconds written as floats, ``stamp_scale=1e9``).

Port of the JAX package's ``io/trajectory.py``: the same lines for the same
poses (the quaternion in float32, as the JAX package computes it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie


def _pose_line(stamp: float, R_cw: np.ndarray, t_cw: np.ndarray,
               stamp_scale: float) -> str:
    """One TUM line for the world->camera pose (R_cw, t_cw)."""
    R_wc = R_cw.T
    t_wc = -R_wc @ t_cw
    R32 = torch.from_numpy(np.ascontiguousarray(R_wc, np.float32))
    q = lie.rot_to_quat(R32[None])[0].numpy()        # (qx, qy, qz, qw)
    return (f"{stamp * stamp_scale:.6f} "
            f"{t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")


def save_tum(path: str, stamps, Rs, ts, stamp_scale: float = 1.0):
    """Write world->camera poses to a TUM-format file (``stamp_scale=1e9``
    for EuRoC's nanoseconds)."""
    lines = [_pose_line(float(s), np.asarray(R), np.asarray(t), stamp_scale)
             for s, R, t in zip(stamps, Rs, ts)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_tum(path: str):
    """Read a TUM trajectory -> (stamps, centres (N, 3), quats (N, 4))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
