"""Batched Hamming-distance descriptor matching.

Port of ``orbslam3_byzyh_tpu/ops/matching.py``. Descriptors are (N, 8) int32 words holding the JAX package's
uint32 bits. Distances are int32 in [0, 256]; ``INVALID_DIST`` (1024) marks
masked-out pairs. The fused masked top-2 reduction is kernel K2
(:mod:`.cuda_match`): ``match`` without a pair mask takes its "none" mode,
``match_window`` and ``search_by_projection`` its window mode,
``search_epipolar`` its epipolar mode.

The plain distance matrix is built in blocks of rows (``hamming_matrix``'s
``chunk_rows``): each row's distances depend on that row alone, so a block
gives the same bits as the whole, and the int64 temporaries stay small at
the fusion search's 65536 x 1200.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INVALID_DIST = 1024

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (torch has no popcount op): SWAR on the
    words widened to int64, so no shift drags in a sign bit."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


# Pairs per block of rows in the plain distance matrix (about 32 MB of
# int64 temporaries).
CHUNK_PAIRS = 1 << 22


def chunk_rows_for(m: int) -> int:
    """Rows per block so that a block holds at most ``CHUNK_PAIRS`` pairs."""
    return max(1, CHUNK_PAIRS // max(m, 1))


def hamming_matrix(da: torch.Tensor, db: torch.Tensor,
                   chunk_rows: int | None = None) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances, built
    ``chunk_rows`` rows at a time (default: :func:`chunk_rows_for`)."""
    n, m = da.shape[0], db.shape[0]
    step = chunk_rows or chunk_rows_for(m)
    dist = torch.zeros((n, m), dtype=torch.int32, device=da.device)
    for r0 in range(0, n, step):
        blk = dist[r0:r0 + step]
        for k in range(da.shape[1]):
            blk += popcount32(da[r0:r0 + step, None, k] ^ db[None, :, k])
    return dist


def masked_hamming(da, db, valid_a, valid_b, pair_mask=None):
    """Distance matrix with invalid rows/cols/pairs set to INVALID_DIST."""
    dist = hamming_matrix(da, db)
    ok = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        ok = ok & pair_mask
    return torch.where(ok, dist, INVALID_DIST)


def best_two(dist: torch.Tensor):
    """Per-row best and second-best distances + best column. dist: (N, M).

    Ties go to the lowest column; the second excludes only the best column,
    so it equals the best when a duplicate distance sits elsewhere (the
    order of ``jax.lax.top_k``). A composite key (dist, column) makes the
    order explicit: ``torch.topk`` promises none on ties.
    """
    n, m = dist.shape
    if m < 2:
        dist = torch.cat([dist, torch.full((n, 2 - m), INVALID_DIST,
                                           dtype=dist.dtype,
                                           device=dist.device)], 1)
        m = 2
    col = torch.arange(m, device=dist.device)
    key = dist.to(torch.int64) * m + col
    k1 = key.amin(1)
    best_j = k1 % m
    key2 = torch.where(col == best_j[:, None], (INVALID_DIST + 1) * m, key)
    second = key2.amin(1) // m
    return ((k1 // m).to(torch.int32), second.to(torch.int32),
            best_j.to(torch.int32))


def ratio_test(best, second, ratio: float):
    """Nearest / second-nearest gate (mfNNratio)."""
    return best.to(torch.float32) < ratio * second.to(torch.float32)


def mutual_filter_from_best(best, best_j, accept, m: int):
    """Each target column keeps only its best row (lowest row on ties)."""
    n = best.shape[0]
    dev = best.device
    best_d = torch.where(accept, best, INVALID_DIST).to(torch.int32)
    bj = best_j.long()
    col_min = torch.full((m,), INVALID_DIST, dtype=torch.int32, device=dev)
    col_min = col_min.scatter_reduce(0, bj, best_d, reduce="amin")
    keep = accept & (best_d == col_min[bj]) & (best_d < INVALID_DIST)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    first_row = torch.full((m,), n, dtype=torch.int32, device=dev)
    first_row = first_row.scatter_reduce(0, bj, torch.where(keep, rows, n),
                                         reduce="amin")
    return keep & (first_row[bj] == rows)


def mutual_filter(dist, best_j, accept):
    """``mutual_filter_from_best`` on a full distance matrix."""
    n = dist.shape[0]
    best = dist[torch.arange(n, device=dist.device), best_j.long()]
    return mutual_filter_from_best(best, best_j, accept, dist.shape[1])


def top_k_lowest_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` of an integer tensor along its last axis: the k
    largest values in descending order, the lower index first among equal
    values. The index is folded into an int64 key, so the order does not
    rest on ``torch.topk``'s, which promises none on ties. Returns (values,
    indices int64)."""
    m = x.shape[-1]
    idx = torch.arange(m, device=x.device)
    key = x.to(torch.int64) * m + (m - 1 - idx)
    top = torch.topk(key, k).values
    return torch.div(top, m, rounding_mode="floor"), m - 1 - top % m


def rotation_consistency(angle_a, angle_b, best_j, accept,
                         n_bins: int = HISTO_LENGTH):
    """Keep only matches whose angle difference falls in the top-3 histogram
    bins (ComputeThreeMaxima, with its 0.1x count cutoffs).

    float32 throughout, as in the JAX package: ``torch.remainder`` and
    ``jnp.mod`` both take the divisor's sign; the bin scale is the float32
    of n_bins / 2 pi; rounding is half to even; ties between bins go to the
    lower bin."""
    two_pi = float(np.float32(2.0 * math.pi))
    rot = torch.remainder(angle_a - angle_b[best_j.long()], two_pi)
    scale = float(np.float32(n_bins / (2.0 * math.pi)))
    bin_idx = torch.round(rot * scale).to(torch.int32).clamp(0, n_bins)
    bin_idx = torch.where(bin_idx == n_bins, 0, bin_idx).long()
    hist = torch.zeros(n_bins, dtype=torch.int32, device=rot.device)
    hist = hist.index_add(0, bin_idx, accept.to(torch.int32))
    top_vals, top_bins = top_k_lowest_first(hist, 3)
    cut = 0.1 * top_vals[0].to(torch.float32)
    keep2 = top_vals[1].to(torch.float32) > cut
    keep3 = top_vals[2].to(torch.float32) > cut
    in_top = (bin_idx == top_bins[0]) \
        | ((bin_idx == top_bins[1]) & keep2) \
        | ((bin_idx == top_bins[2]) & keep3)
    return accept & in_top


def apply_rotation_filter(mj, angle_a, angle_b):
    """Post-filter a finished match vector by the rotation histogram."""
    accept = mj >= 0
    keep = rotation_consistency(angle_a, angle_b, mj.clamp_min(0), accept)
    return torch.where(keep, mj, -1)


def match(da, db, valid_a, valid_b, pair_mask=None, max_dist: int = TH_LOW,
          ratio: float = 0.9, angles=None, mutual: bool = True):
    """Generic one-shot matcher: (match_j (N,) int32 index into b or -1,
    dist (N,) int32). ``angles`` = (angle_a, angle_b) adds the rotation
    histogram gate (before the mutual filter, as in the JAX package).

    Without ``pair_mask`` the top-2 is K2's "none" mode, which returns
    exactly ``best_two(masked_hamming(...))``; a pair mask takes the plain
    path."""
    from . import cuda_match

    if pair_mask is None:
        best, second, best_j = cuda_match.hamming_best2(da, db, valid_a,
                                                        valid_b)
    else:
        best, second, best_j = best_two(
            masked_hamming(da, db, valid_a, valid_b, pair_mask))
    accept = best <= max_dist
    if ratio is not None:
        accept = accept & ratio_test(best, second, ratio)
    if angles is not None:
        accept = rotation_consistency(angles[0], angles[1], best_j, accept)
    if mutual:
        accept = mutual_filter_from_best(best, best_j, accept, db.shape[0])
    return (torch.where(accept, best_j, -1),
            torch.where(accept, best, INVALID_DIST))


def match_window(da, db, valid_a, valid_b, xy_a, xy_b, radius,
                 level_a, level_b, level_window=(-8, 8),
                 max_dist: int = TH_LOW, ratio: float = 0.9,
                 mutual: bool = True):
    """Window-gated match (SearchForInitialization style): K2's window
    mode. ``radius``: one value or (N,)."""
    from . import cuda_match

    if not isinstance(radius, torch.Tensor):
        radius = torch.full((), radius, dtype=torch.float32,
                            device=da.device)
    best, second, best_j = cuda_match.hamming_best2(
        da, db, valid_a, valid_b, xy_a=xy_a, xy_b=xy_b, radius=radius,
        level_a=level_a, level_b=level_b, level_window=level_window)
    return _finish_match(best, second, best_j, db.shape[0], max_dist, ratio,
                         mutual)


def window_mask(xy_a, xy_b, radius):
    """Candidate pairs within a pixel window. radius: scalar or (N,)."""
    d = xy_a[:, None, :] - xy_b[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    r = torch.as_tensor(radius, dtype=torch.float32, device=xy_a.device)
    r2 = r * r if r.dim() == 0 else (r * r)[:, None]
    return d2 <= r2


def level_mask(level_a, level_b, min_delta: int = 0, max_delta: int = 0):
    """Pyramid-level compatibility: level_b within [la+min, la+max]."""
    diff = level_b[None, :] - level_a[:, None]
    return (diff >= min_delta) & (diff <= max_delta)


def epipolar_mask(F12, xy1, xy2, level2, sigma_levels2):
    """Pairs (i, j) consistent with the fundamental F12 (x2^T F12 x1 = 0):
    squared point-line distance in image 2 below 3.84 * sigma2(level of
    kp2) (CheckDistEpipolarLine)."""
    ones1 = torch.ones_like(xy1[:, :1])
    l2 = torch.cat([xy1, ones1], -1) @ F12.T            # (N1, 3) lines
    num = (l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1]
           + l2[:, None, 2]) ** 2
    den = (l2[:, 0] ** 2 + l2[:, 1] ** 2).clamp_min(1e-12)[:, None]
    th = 3.84 * sigma_levels2[level2.long()][None, :]
    return num / den < th


def predict_scale_level(dist, max_dist, scale: float = 1.2, n_levels: int = 8):
    """Pyramid level a landmark would appear at (MapPoint::PredictScale)."""
    ratio = (max_dist / dist.clamp_min(1e-6)).clamp_min(1e-6)
    # float32 log of the float32 scale, as a Python number: no device copy.
    log_scale = float(torch.log(torch.tensor(scale, dtype=torch.float32)))
    lvl = torch.ceil(torch.log(ratio) / log_scale)
    return lvl.to(torch.int32).clamp(0, n_levels - 1)


def frustum_cull(R, t, pos, normal, min_dist, max_dist, cam_params,
                 img_w: float, img_h: float, view_cos_limit: float = 0.5):
    """Frame::isInFrustum batched: (visible, projected uv, distance, level)."""
    pc = pos @ R.T + t
    z = pc[:, 2]
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    cam_center = -(R.T @ t)
    po = pos - cam_center
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = (po * normal).sum(-1) / dist.clamp_min(1e-9)
    ok = ((z > 0.01) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
          & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
          & (view_cos > view_cos_limit))
    level = predict_scale_level(dist, max_dist)
    return ok, torch.stack([u, v], -1), dist, level


def _finish_match(best, second, best_j, m, max_dist, ratio, mutual):
    """Shared accept/gate chain after a top-2 reduction."""
    accept = best <= max_dist
    if ratio is not None:
        accept = accept & ratio_test(best, second, ratio)
    if mutual:
        accept = mutual_filter_from_best(best, best_j, accept, m)
    return (torch.where(accept, best_j, -1),
            torch.where(accept, best, INVALID_DIST))


def search_by_projection(proj_xy, pred_level, lm_desc, lm_valid,
                         kp_xy, kp_level, kp_desc, kp_valid,
                         radius, max_dist: int = TH_HIGH, ratio: float = 0.9,
                         level_window: tuple = (-1, 1)):
    """Project-and-match: landmarks (rows) against frame keypoints (cols),
    with a per-landmark radius and a pyramid-level window (ORBmatcher::
    SearchByProjection). Returns (match_j, dist) per landmark."""
    from . import cuda_match

    best, second, best_j = cuda_match.hamming_best2(
        lm_desc, kp_desc, lm_valid, kp_valid,
        xy_a=proj_xy, xy_b=kp_xy, radius=radius,
        level_a=pred_level, level_b=kp_level, level_window=level_window)
    return _finish_match(best, second, best_j, kp_xy.shape[0],
                         max_dist, ratio, mutual=True)


def search_epipolar(lines_a, desc_a, valid_a, kp_xy, kp_level, desc_b,
                    valid_b, sigma2_levels, max_dist: int = TH_LOW,
                    ratio: float = 0.8):
    """Epipolar-gated match for triangulation (SearchForTriangulation):
    rows carry their epipolar line (N, 3) in image b; a pair passes when the
    squared point-line distance is below 3.84 * sigma2(level_b). K2's
    epipolar mode, then the ratio and mutual gates. Returns (match_j,
    dist) per row."""
    from . import cuda_match

    th_b = 3.84 * sigma2_levels[kp_level.long()]
    best, second, best_j = cuda_match.hamming_best2(
        desc_a, desc_b, valid_a, valid_b, xy_b=kp_xy,
        lines=lines_a.contiguous(), line_th=th_b)
    return _finish_match(best, second, best_j, kp_xy.shape[0],
                         max_dist, ratio, mutual=True)
