"""EuRoC-layout dataset reader (port of the JAX package's ``io/euroc.py``;
images decoded by the port's own ``io.png`` in place of ``cv2.imread``).

Replaces the per-example loader code of the reference mains
(ORB-SLAM3's ``Examples/Monocular/mono_euroc.cc:LoadImages`` and the IMU
variant in ``Examples/Monocular-Inertial/mono_inertial_euroc.cc``): reads the
``mav0/cam0/data`` directory + timestamp list, and ``mav0/imu0/data.csv``
(EuRoC convention: timestamps in nanoseconds; IMU rows w_xyz, a_xyz).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

from . import png


@dataclass
class EurocSequence:
    stamps: np.ndarray                # (F,) seconds (float64)
    image_paths: list
    imu_stamps: np.ndarray = field(default=None)   # (M,) seconds
    imu_gyro: np.ndarray = field(default=None)     # (M, 3) rad/s
    imu_acc: np.ndarray = field(default=None)      # (M, 3) m/s^2

    def __len__(self):
        return len(self.stamps)

    def read_image(self, i: int) -> np.ndarray:
        """``cv2.imread(path, IMREAD_GRAYSCALE)`` as float32, on the host."""
        if not os.path.exists(self.image_paths[i]):
            raise FileNotFoundError(self.image_paths[i])
        return png.read_grey(self.image_paths[i])

    def imu_between(self, t0: float, t1: float):
        """IMU samples with t0 < t <= t1 (the reference feeds per-frame
        batches the same way, mono_inertial_euroc.cc:160-180)."""
        if self.imu_stamps is None:
            return None
        sel = (self.imu_stamps > t0) & (self.imu_stamps <= t1)
        return self.imu_stamps[sel], self.imu_gyro[sel], self.imu_acc[sel]


def load_euroc(seq_dir: str, timestamps_file: str | None = None,
               cam: str = "cam0") -> EurocSequence:
    """seq_dir: path containing ``mav0/``. timestamps_file: optional
    EuRoC_TimeStamps list (ns per line); defaults to the cam csv."""
    cam_dir = os.path.join(seq_dir, "mav0", cam, "data")
    csv_path = os.path.join(seq_dir, "mav0", cam, "data.csv")

    stamps_ns = []
    names = []
    if timestamps_file and os.path.exists(timestamps_file):
        with open(timestamps_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                stamps_ns.append(int(line))
                names.append(line + ".png")
    else:
        with open(csv_path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                stamps_ns.append(int(row[0]))
                names.append(row[1].strip())
    stamps = np.asarray(stamps_ns, np.float64) * 1e-9
    paths = [os.path.join(cam_dir, n) for n in names]

    seq = EurocSequence(stamps=stamps, image_paths=paths)

    imu_csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    if os.path.exists(imu_csv):
        t, g, a = [], [], []
        with open(imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t.append(int(row[0]) * 1e-9)
                g.append([float(row[1]), float(row[2]), float(row[3])])
                a.append([float(row[4]), float(row[5]), float(row[6])])
        seq.imu_stamps = np.asarray(t, np.float64)
        seq.imu_gyro = np.asarray(g, np.float32)
        seq.imu_acc = np.asarray(a, np.float32)
    return seq
