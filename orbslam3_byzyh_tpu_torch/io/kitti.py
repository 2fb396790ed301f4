"""KITTI odometry dataset reader (port of the JAX package's ``io/kitti.py``;
images decoded by the port's own ``io.png`` in place of ``cv2.imread``).

Replaces the loaders of the reference KITTI mains
(ORB-SLAM3's ``Examples/Monocular/mono_kitti.cc:LoadImages`` and
``Examples/Stereo/stereo_kitti.cc``): ``times.txt`` (seconds per line) +
``image_0/`` (left gray) and ``image_1/`` (right gray) with %06d.png names.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import png


@dataclass
class KittiSequence:
    stamps: np.ndarray
    left_paths: list
    right_paths: list

    def __len__(self):
        return len(self.stamps)

    def read_image(self, i: int, right: bool = False) -> np.ndarray:
        path = self.right_paths[i] if right else self.left_paths[i]
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return png.read_grey(path)


def load_kitti(seq_dir: str) -> KittiSequence:
    """seq_dir: e.g. dataset/sequences/00 containing times.txt, image_0/."""
    times_file = os.path.join(seq_dir, "times.txt")
    stamps = []
    with open(times_file) as f:
        for line in f:
            line = line.strip()
            if line:
                stamps.append(float(line))
    n = len(stamps)
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(n)]
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(n)]
    return KittiSequence(stamps=np.asarray(stamps, np.float64),
                         left_paths=left, right_paths=right)
