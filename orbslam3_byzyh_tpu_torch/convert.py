"""State carried across from the JAX package's numpy arrays.

The system has no learned weights: the map arrays and the camera are its
state. Descriptors are 256-bit strings stored as (N, 8) ``uint32`` words in
the JAX package; torch has few ``uint32`` ops, so the port keeps the same
bits as ``int32`` (a ``view``, never a value conversion).
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .models import map_state as ms


def to_torch(x, device=None) -> torch.Tensor:
    """One array (numpy, JAX or Python) -> tensor on ``device`` (``None``:
    the card, see :func:`device.resolve`).

    uint32 -> bit-identical int32; other integers -> int32; floats -> f32;
    bool stays bool.
    """
    dev = device_mod.resolve(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(dev)   # a copy


def tree_to_torch(args, device=None) -> tuple:
    """A tuple of arrays (e.g. the tracking-step arguments) -> tensors on
    ``device`` (``None``: the card); a None stays None."""
    dev = device_mod.resolve(device)
    return tuple(None if a is None else to_torch(a, dev) for a in args)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host (no dtype change)."""
    return t.detach().cpu().numpy()


def desc_to_uint32(t: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 descriptor words -> the JAX package's uint32 words."""
    return to_numpy(t).astype(np.int32, copy=False).view(np.uint32)


def map_state_to_torch(state_np, device=None):
    """A map state of numpy (or JAX) arrays, shaped as the JAX package's
    ``MapState``, -> the port's ``MapState`` of tensors on ``device``
    (``None``: the card). Descriptors become bit-identical int32 words."""
    dev = device_mod.resolve(device)
    return ms.MapState(
        kfs=ms.KeyFrames(*(to_torch(a, dev) for a in state_np.kfs)),
        lms=ms.Landmarks(*(to_torch(a, dev) for a in state_np.lms)),
        obs=ms.Observations(*(to_torch(a, dev) for a in state_np.obs)))


def map_state_to_numpy(state):
    """The port's ``MapState`` -> the same NamedTuples of numpy arrays, with
    the JAX package's dtypes (descriptors as uint32 words)."""
    desc = {"kp_desc", "desc"}

    def conv(group):
        return type(group)(*(
            desc_to_uint32(x) if name in desc else to_numpy(x)
            for name, x in zip(group._fields, group)))

    return ms.MapState(kfs=conv(state.kfs), lms=conv(state.lms),
                       obs=conv(state.obs))
