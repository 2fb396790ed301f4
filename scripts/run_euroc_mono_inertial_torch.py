#!/usr/bin/env python3
"""EuRoC monocular-inertial runner on the PyTorch port
(mono_inertial_euroc.cc; --clahe applies CLAHE).

    python scripts/run_euroc_mono_inertial_torch.py <settings.yaml> <sequence> [flags]

The flags, defaults, printed lines and files of ``scripts/run_euroc_mono_inertial.py``,
plus ``--device`` (the CUDA card by default; ``--device cpu`` runs the
plain versions on the CPU). See ``orbslam3_byzyh_tpu_torch/runners.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from orbslam3_byzyh_tpu_torch.runners import main_euroc_mono_inertial  # noqa: E402

if __name__ == "__main__":
    main_euroc_mono_inertial()
