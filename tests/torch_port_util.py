"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

The tier-1 run uses several pytest-xdist workers on one host, and torch
takes every core by default; each worker is capped at 2 threads.
Inputs are made with numpy and handed to both packages as numpy arrays.
"""

import numpy as np
import torch

from orbslam3_byzyh_tpu_torch import convert

torch.set_num_threads(2)


def t(x):
    """numpy / JAX array -> CPU tensor (uint32 words become int32 bits)."""
    return convert.to_torch(x, "cpu")


def n(x):
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def popcount_rows(a, b):
    """Per-row Hamming distance of two (K, 8) word arrays (any 32-bit type)."""
    x = np.asarray(a).view(np.uint32) ^ np.asarray(b).view(np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=1).sum(1)


def small_mono_config():
    """The EuRoC-mono configuration cut for the CPU parity tests: half the
    image and intrinsics, 256 features, 2048 landmark and 64 keyframe slots,
    a 512-landmark window (the widths that set the behaviour: radtan
    coefficients, 8 levels at 1.2, 12 observations, 20 + 4 local
    keyframes, are EuRoC's)."""
    from orbslam3_byzyh_tpu_torch import graft
    return graft.MonoConfig(width=376, height=240, fx=229.327, fy=228.648,
                            cx=183.6075, cy=124.1875, n_features=256,
                            max_kf=64, max_lm=2048, n_local_lm=512)


def mono_scene(feats, cfg, case):
    """graft.euroc_mono_scene on numpy features (xy, level, desc, angle,
    valid), with 48 live keyframes."""
    from orbslam3_byzyh_tpu_torch import graft
    return graft.euroc_mono_scene(*feats, cfg=cfg, case=case, n_live_kf=48)
