"""TUM RGB-D dataset reader with rgb/depth timestamp association (port of
the JAX package's ``io/tum_rgbd.py``; images decoded by the port's own
``io.png`` in place of ``cv2.imread``).

Replaces the loader of ORB-SLAM3's ``Examples/RGB-D/rgbd_tum.cc``
(which consumes a pre-associated file from the TUM ``associate.py`` tool):
reads ``rgb.txt`` + ``depth.txt`` and associates nearest-in-time pairs
within ``max_dt`` — the same policy as
ORB-SLAM3's ``evaluation/associate.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import png


def _read_list(path):
    stamps, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(stamps, np.float64), names


@dataclass
class TumRgbdSequence:
    stamps: np.ndarray
    rgb_paths: list
    depth_paths: list
    depth_factor: float = 5000.0   # TUM depth png scale

    def __len__(self):
        return len(self.stamps)

    def read_pair(self, i: int):
        for p in (self.rgb_paths[i], self.depth_paths[i]):
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        rgb = png.read_grey(self.rgb_paths[i])
        depth = png.read_unchanged(self.depth_paths[i])
        return rgb, depth.astype(np.float32) / self.depth_factor


def load_tum_rgbd(seq_dir: str, max_dt: float = 0.02,
                  association_file: str | None = None) -> TumRgbdSequence:
    if association_file:
        stamps, rgb, depth = [], [], []
        with open(association_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                stamps.append(float(p[0]))
                rgb.append(os.path.join(seq_dir, p[1]))
                depth.append(os.path.join(seq_dir, p[3]))
        return TumRgbdSequence(np.asarray(stamps, np.float64), rgb, depth)

    rs, rn = _read_list(os.path.join(seq_dir, "rgb.txt"))
    ds, dn = _read_list(os.path.join(seq_dir, "depth.txt"))
    stamps, rgb, depth = [], [], []
    j = np.searchsorted(ds, rs)
    for i, t in enumerate(rs):
        k = int(np.clip(j[i], 0, len(ds) - 1))
        kp = int(np.clip(j[i] - 1, 0, len(ds) - 1))
        if abs(ds[kp] - t) < abs(ds[k] - t):
            k = kp
        if abs(ds[k] - t) <= max_dt:
            stamps.append(t)
            rgb.append(os.path.join(seq_dir, rn[i]))
            depth.append(os.path.join(seq_dir, dn[k]))
    return TumRgbdSequence(np.asarray(stamps, np.float64), rgb, depth)
