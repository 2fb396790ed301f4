"""Motion-only pose optimization (PnP-style) on SE(3), monocular.

Port of ``orbslam3_byzyh_tpu/solver/pose_opt.py`` (``Optimizer::
PoseOptimization``): 4 rounds x 10 LM iterations; the chi2 gate 5.991
re-classifies outliers between rounds; Huber kernel with delta^2 = 5.991,
dropped in the final round. The whole schedule is kernel K3
(:mod:`.cuda_pose_opt`), whose plain PyTorch version is the JAX package's
XLA path. Stereo waits for a later port.

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

    if model_id != cam.PINHOLE:
        raise NotImplementedError("pose_optimization: only PINHOLE is ported")
    R, t, chi2 = cuda_pose_opt.pose_optimization(
        R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
        n_rounds=n_rounds, n_iters=n_iters)
    inlier = (chi2 <= cuda_pose_opt.CHI2_MONO) & valid
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum(-1).to(torch.int32), chi2=chi2)
