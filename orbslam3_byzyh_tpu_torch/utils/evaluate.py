"""Trajectory evaluation: Horn alignment and the absolute trajectory error.

The port's copy of the JAX package's ``utils/evaluate.py`` (numpy only): the
metric of ORB-SLAM3's oracle, ``evaluation/evaluate_ate_scale.py``
(``align()``, Horn's closed form with optional scale, the RMSE over the
aligned translations).
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """Align model -> data (both (N, 3)) by similarity transform.

    Returns (s, R, t, rmse_aligned) with data ~ s * R @ model + t.
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc ** 2).sum()
        s = (S * np.diag(D)).sum() / max(var_m, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    aligned = s * model @ R.T + t
    err = np.linalg.norm(aligned - data, axis=-1)
    rmse = float(np.sqrt((err ** 2).mean()))
    return s, R, t, rmse


def ate_rmse(est_stamps, est_centers, gt_stamps, gt_centers,
             max_dt: float = 0.02, with_scale: bool = True):
    """Associate by timestamp, align, return RMSE (meters) + match count."""
    est_stamps = np.asarray(est_stamps, np.float64)
    gt_stamps = np.asarray(gt_stamps, np.float64)
    gi = np.searchsorted(gt_stamps, est_stamps)
    gi = np.clip(gi, 0, len(gt_stamps) - 1)
    gi_prev = np.clip(gi - 1, 0, len(gt_stamps) - 1)
    use_prev = (np.abs(gt_stamps[gi_prev] - est_stamps)
                < np.abs(gt_stamps[gi] - est_stamps))
    gi = np.where(use_prev, gi_prev, gi)
    ok = np.abs(gt_stamps[gi] - est_stamps) <= max_dt
    if ok.sum() < 3:
        return float("inf"), int(ok.sum())
    _, _, _, rmse = horn_align(np.asarray(est_centers)[ok],
                               np.asarray(gt_centers)[gi[ok]], with_scale)
    return rmse, int(ok.sum())


def camera_centers(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """World camera centers from world->cam poses: C = -R^T t."""
    return -np.einsum("nji,nj->ni", np.asarray(Rs), np.asarray(ts))
