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
