"""Motion-only pose optimization (PnP-style) on SE(3), monocular.

Port of ``orbslam3_byzyh_tpu/solver/pose_opt.py`` (``Optimizer::
PoseOptimization``): 4 rounds x 10 LM iterations; the chi2 gate 5.991
re-classifies outliers between rounds; Huber kernel with delta^2 = 5.991,
dropped in the final round. The whole schedule is kernel K3
(:mod:`.cuda_pose_opt`), whose plain PyTorch version is the JAX package's
XLA path. ``pose_optimization_stereo`` mixes mono rows with stereo rows
(EdgeStereoSE3ProjectXYZOnlyPose: a third residual u_r - (u - bf / z), chi2
gate and Huber delta^2 7.815); it is kernel K3s, K3 with its stereo flag.
Both take the pinhole or the KB8 camera (``model_id``; the kernels carry
both projections).

State: camera pose Tcw as (R (3, 3), t (3,)). Left-multiplicative update
T <- exp([rho, phi]) * T, so d(pc)/d(delta) = [I | -skew(pc)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera as cam
from ..ops import lie


class PoseOptResult(NamedTuple):
    R: torch.Tensor         # (3, 3) optimized Rcw
    t: torch.Tensor         # (3,) optimized tcw
    inlier: torch.Tensor    # (N,) final inlier mask
    n_inliers: torch.Tensor
    chi2: torch.Tensor      # (N,) final per-observation chi2


def _residuals_mono(R, t, pts_w, obs_uv, cam_params, model_id):
    """r_i = obs - proj(R p + t); J_i (2, 6) wrt the left se3 perturbation."""
    pc = pts_w @ R.T + t
    r = obs_uv - cam.project(model_id, cam_params, pc)
    Jproj = cam.project_jac(model_id, cam_params, pc)          # (N, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -lie.skew(pc)], -1)                   # (N, 3, 6)
    J = -torch.einsum("nij,njk->nik", Jproj, dpc)               # (N, 2, 6)
    return r, J, pc[:, 2] > 0.05


def _residuals_stereo(R, t, pts_w, obs_uv, obs_ur, bf, cam_params,
                      model_id):
    """The 3-row stereo residual (u, v, u_r = u - bf / z) and its (N, 3, 6)
    Jacobian; rows with ``obs_ur < 0`` are monocular: their third row is
    zero. Returns (r, J, depth_ok, has_ur)."""
    r2, J2, depth_ok = _residuals_mono(R, t, pts_w, obs_uv, cam_params,
                                       model_id)
    pc = pts_w @ R.T + t
    iz = 1.0 / pc[:, 2].clamp_min(1e-6)
    ur_pred = (obs_uv[:, 0] - r2[:, 0]) - bf * iz
    has_ur = obs_ur >= 0.0
    r3 = torch.where(has_ur, obs_ur - ur_pred, 0.0)
    # d(u_r)/d(pc) = du/dpc + (0, 0, bf / z^2), through [I | -skew(pc)].
    e = bf * iz * iz
    zero = torch.zeros_like(e)
    extra = torch.stack([zero, zero, e, e * pc[:, 1], -e * pc[:, 0], zero],
                        -1)
    J3 = torch.where(has_ur[:, None], J2[:, 0, :] - extra, 0.0)
    r = torch.cat([r2, r3[:, None]], -1)                    # (N, 3)
    J = torch.cat([J2, J3[:, None, :]], -2)                 # (N, 3, 6)
    return r, J, depth_ok, has_ur


def pose_optimization(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
                      model_id: int = cam.PINHOLE, n_rounds: int = 4,
                      n_iters: int = 10) -> PoseOptResult:
    """Monocular motion-only BA.

    R0, t0: initial Tcw. pts_w: (N, 3) world points. obs_uv: (N, 2) pixels.
    inv_sigma2: (N,) observation information. valid: (N,) bool. A leading
    batch dimension B on every argument but ``cam_params`` solves B
    problems at once (one K3 launch on the card).
    """
    from . import cuda_pose_opt

    R, t, chi2 = cuda_pose_opt.pose_optimization(
        R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
        n_rounds=n_rounds, n_iters=n_iters, model_id=model_id)
    inlier = (chi2 <= cuda_pose_opt.CHI2_MONO) & valid
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum(-1).to(torch.int32), chi2=chi2)


def pose_optimization_stereo(R0, t0, pts_w, obs_uv, obs_ur, bf, inv_sigma2,
                             valid, cam_params, model_id: int = cam.PINHOLE,
                             n_rounds: int = 4,
                             n_iters: int = 10) -> PoseOptResult:
    """Motion-only BA with mixed mono/stereo observations.

    ``obs_ur`` (N,): the right-image u of each keypoint, < 0 for a mono
    row; ``bf``: baseline x fx, a Python float (the kernel takes it by
    value). Per-row chi2 gates 5.991 / 7.815. Batched as
    :func:`pose_optimization` (one K3s launch on the card)."""
    from . import cuda_pose_opt

    R, t, chi2 = cuda_pose_opt.pose_optimization_stereo(
        R0, t0, pts_w, obs_uv, obs_ur, bf, inv_sigma2, valid, cam_params,
        n_rounds=n_rounds, n_iters=n_iters, model_id=model_id)
    delta2 = torch.where(obs_ur >= 0.0, cuda_pose_opt.CHI2_STEREO,
                         cuda_pose_opt.CHI2_MONO)
    inlier = (chi2 <= delta2) & valid
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum(-1).to(torch.int32), chi2=chi2)
