"""Batched RANSAC PnP: a camera pose from 2D-3D correspondences.

Port of ``orbslam3_byzyh_tpu/ops/pnp.py`` (the relocalisation solver that
replaces ORB-SLAM3's MLPnP / EPnP RANSAC). Every hypothesis is solved and
scored in one batch: a 6-point DLT of the projection matrix in ideal image
coordinates (one 12 x 12 ``eigh`` each), orthogonalised onto SO(3) by a
3 x 3 SVD; the best-scoring hypothesis is refined by the motion-only pose
optimization (K3 on the card).

Two differences from the JAX function, each stated by its parity test:

  * The sample indices (``n_iters``, ``sample_size``) are the caller's,
    not drawn inside: ``jax.random.choice``'s stream cannot be reproduced
    in torch. :func:`draw_indices` draws them on the device from a
    ``torch.Generator`` (weighted Gumbel top-k, as
    ``geometry.sample_indices``).
  * The null vector of the DLT is defined up to sign. The JAX function
    takes ``eigh``'s sign as it comes, and a hypothesis whose 3 x 3 block
    has a negative determinant comes out rotated by pi about an axis (on
    the JAX package's own test problem, 68 and 67 of 128 hypotheses with
    its two keys). Here the
    vector is turned so that the block's determinant is positive first,
    so every hypothesis is the DLT's pose whatever sign ``eigh`` returns
    (torch's and JAX's disagree on about a quarter of them).

The correspondences are any N rows: the relocalisation passes one row per
keypoint (its matched landmark), not one per landmark slot, so the refine
fits in K3's shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver import pose_opt
from . import camera as cam
from . import geometry

N_ITERS = 128
SAMPLE_SIZE = 6


class PnPResult(NamedTuple):
    R: torch.Tensor          # (3, 3) world->cam
    t: torch.Tensor          # (3,)
    inlier: torch.Tensor     # (N,)
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool: a hypothesis with enough inliers
    idx: torch.Tensor        # (n_iters, sample_size) the samples used


def draw_indices(generator: torch.Generator, valid: torch.Tensor,
                 n_iters: int = N_ITERS,
                 sample_size: int = SAMPLE_SIZE) -> torch.Tensor:
    """(n_iters, sample_size) rows drawn without replacement in proportion
    to ``valid`` + 1e-9 (the JAX function's weights), on the device."""
    return geometry.sample_indices(generator, n_iters, sample_size,
                                   valid.to(torch.float32) + 1e-9)


def _dlt_pose(X: torch.Tensor, x: torch.Tensor):
    """Poses from >= 6 points each: X (B, S, 3) world, x (B, S, 2) ideal
    coordinates -> R (B, 3, 3), t (B, 3)."""
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], -1)                               # (B, S, 4)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -x[..., :1] * Xh], -1)               # (B, S, 12)
    r2 = torch.cat([z, Xh, -x[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                 # (B, 2S, 12)
    _, vecs = torch.linalg.eigh(A.mT @ A)
    P = vecs[..., :, 0].reshape(X.shape[:-2] + (3, 4))
    # M = beta R with R in SO(3): the sign that makes det(M) > 0.
    P = P * torch.where(geometry._det3(P[..., :3]) < 0, -1.0, 1.0)[
        ..., None, None]
    M = P[..., :3]
    U, S, Vt = torch.linalg.svd(M)
    d = geometry._det3(U) * geometry._det3(Vt)
    D = torch.ones(X.shape[:-2] + (3,), dtype=X.dtype, device=X.device)
    D = torch.cat([D[..., :2], d[..., None]], -1)
    R = (U * D[..., None, :]) @ Vt
    beta = S.mean(-1)
    beta = torch.where(beta.abs() < 1e-12, 1e-12, beta)
    return R, P[..., 3] / beta[..., None]


def pnp_ransac(idx: torch.Tensor, pts_w, uv, inv_sigma2, valid, cam_params,
               chi2_th: float = 5.991,
               model_id: int = cam.PINHOLE) -> PnPResult:
    """All-hypotheses RANSAC PnP and the inlier-refined pose optimization.

    idx: (I, S) sample rows (:func:`draw_indices`); pts_w: (N, 3); uv: (N,
    2) pixels; inv_sigma2: (N,); valid: (N,) usable correspondences. No
    host read, but ``torch.linalg.eigh`` and ``svd`` synchronise on the
    card (1 and 2 a call) to check their results."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], \
        cam_params[3]
    x_ideal = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    ids = idx.long()
    Rs, ts = _dlt_pose(pts_w[ids], x_ideal[ids])               # (I, 3, 3)
    pc = torch.einsum("nj,bij->bni", pts_w, Rs) + ts[:, None, :]
    proj = cam.project(model_id, cam_params, pc)
    chi2 = ((uv - proj) ** 2).sum(-1) * inv_sigma2
    inls = valid & (chi2 < chi2_th) & (pc[..., 2] > 0.05)      # (I, N)
    finite = (torch.isfinite(Rs).flatten(1).all(-1)
              & torch.isfinite(ts).all(-1))
    scores = torch.where(finite, inls.sum(-1), -1)
    # The first maximum, as jnp.argmax; picked without a host read (a 0-d
    # index tensor would be read).
    best = torch.argmax(scores)
    pick = geometry._pick
    ok = pick(scores, best) >= idx.shape[1]

    res = pose_opt.pose_optimization(
        pick(Rs, best), pick(ts, best), pts_w, uv, inv_sigma2,
        pick(inls, best) & valid, cam_params, model_id=model_id)
    return PnPResult(R=res.R, t=res.t, inlier=res.inlier,
                     n_inliers=res.n_inliers, ok=ok, idx=idx)
