#!/usr/bin/env python3
"""Render an atlas checkpoint to PNG on the PyTorch port: the offline
stand-in for ORB-SLAM3's Pangolin map window, as ``scripts/view_atlas.py``
is for the JAX package, without matplotlib.

    python scripts/view_atlas_torch.py <checkpoint_dir> [--out map.png]
        [--map N] [--device cpu]

See ``orbslam3_byzyh_tpu_torch/utils/viewer.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from orbslam3_byzyh_tpu_torch.utils.viewer import main_view_atlas  # noqa: E402

if __name__ == "__main__":
    main_view_atlas()
