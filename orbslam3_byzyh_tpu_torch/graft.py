"""Entry points: the per-frame tracking step and its example inputs.

``tracking_step`` is the flagship per-frame computation (ORB extraction +
local-map tracking + motion-only pose optimization), with the same
arguments and results as ``orbslam3_byzyh_tpu.graft.tracking_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import convert
from .ops import fast_orb, lie
from .pipeline import tracking

N_FEATURES = 1024
# The initial pose of the lifted scene: exp([rho, phi]) off the identity.
LIFTED_POSE_XI = (0.01, -0.01, 0.02, 0.003, -0.002, 0.002)


def tracking_step(img, R, t, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d,
                  lm_valid, cam_params):
    """One tracking frame: extract ORB features, project the local map,
    match, and run motion-only pose optimization. img: (H, W) float32.
    Returns (R, t, n_inliers)."""
    feats = fast_orb.extract(img, n_features=N_FEATURES)
    bindings = torch.full((N_FEATURES,), -1, dtype=torch.int32,
                          device=img.device)
    res = tracking.track_local_map(
        R, t, bindings,
        lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
        feats.xy, feats.level, feats.desc, feats.valid,
        cam_params, int(img.shape[1]), int(img.shape[0]))
    return res.R, res.t, res.n_inliers


def example_arrays(h: int = 480, w: int = 640, n_lm: int = 4096):
    """numpy version of ``example_tracking_args``: a noise image against
    random landmarks (the JAX package's example, value for value).
    Descriptors are uint32, as in the JAX package."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    lm_pos = np.stack([rng.uniform(-5, 5, n_lm), rng.uniform(-4, 4, n_lm),
                       rng.uniform(3, 12, n_lm)], -1).astype(np.float32)
    lm_desc = rng.integers(0, 2 ** 32, (n_lm, 8), dtype=np.uint32)
    normal = lm_pos / np.linalg.norm(lm_pos, axis=-1, keepdims=True)
    cam_params = np.array([400.0, 400.0, w / 2, h / 2], np.float32)
    return (img, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), lm_pos,
            lm_desc, normal, np.full((n_lm,), 0.5, np.float32),
            np.full((n_lm,), 40.0, np.float32), np.ones((n_lm,), bool),
            cam_params)


def example_tracking_args(h: int = 480, w: int = 640, n_lm: int = 4096,
                          device=None):
    """The tracking step's example inputs as tensors on ``device`` (``None``:
    the card; raises without one).

    The landmarks are random, so almost nothing matches (the step ends
    with a single inlier); :func:`lifted_scene` gives a scene that tracks.
    """
    return convert.tree_to_torch(example_arrays(h, w, n_lm), device)


def lifted_scene(feats_xy, feats_level, feats_desc, feats_valid,
                 h: int = 480, w: int = 640, n_lm: int = 4096, seed: int = 0):
    """A map that the example image tracks against (numpy in and out).

    Each of the frame's own features (numpy, from either package) is lifted
    to a depth drawn from U(3, 12) m along its ray, keeps its descriptor,
    gets the normal along the ray and the scale range of
    MapPoint::UpdateNormalAndDepth (max_d = dist * 1.2^level, min_d =
    max_d / 1.2^7). The remaining landmark slots hold the example's random
    distractors. The true pose is the identity; the returned start pose is
    exp(LIFTED_POSE_XI). Returns the tracking step's 10 arguments.
    """
    img, _, _, lm_pos, lm_desc, normal, min_d, max_d, valid, cam = \
        example_arrays(h, w, n_lm)
    xy = np.asarray(feats_xy, np.float64)
    n = xy.shape[0]
    fx, fy, cx, cy = (float(c) for c in cam)
    depth = np.random.default_rng(seed).uniform(3, 12, n)
    ray = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy,
                    np.ones(n)], -1)
    pos = ray * depth[:, None]
    dist = np.linalg.norm(pos, axis=-1)
    scale_max = dist * 1.2 ** np.asarray(feats_level, np.float64)

    lm_pos, normal = lm_pos.copy(), normal.copy()
    lm_desc, valid = lm_desc.copy(), valid.copy()
    min_d, max_d = min_d.copy(), max_d.copy()
    lm_pos[:n] = pos
    normal[:n] = pos / dist[:, None]
    lm_desc[:n] = np.asarray(feats_desc).view(np.uint32)
    max_d[:n] = scale_max
    min_d[:n] = scale_max / 1.2 ** 7
    valid[:n] = np.asarray(feats_valid, bool)

    R0, t0 = lie.se3_exp(torch.tensor(LIFTED_POSE_XI, dtype=torch.float64))
    return (img, R0.numpy().astype(np.float32), t0.numpy().astype(np.float32),
            lm_pos.astype(np.float32), lm_desc, normal.astype(np.float32),
            min_d.astype(np.float32), max_d.astype(np.float32), valid, cam)
