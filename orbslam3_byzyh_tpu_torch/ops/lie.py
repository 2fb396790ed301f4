"""Batched SO(3) / SE(3) operations (the subset the port's paths use).

Port of ``orbslam3_byzyh_tpu/ops/lie.py``: rotations are 3x3 matrices,
poses are (R, t) pairs, and every function takes arbitrary leading batch
dimensions. Small-angle branches select Taylor series with ``torch.where``.
"""

from __future__ import annotations

import torch

# Threshold under which Taylor expansions replace trig expressions.
_EPS = 1e-5


def skew(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    W = skew(w)
    W2 = W @ W
    small = theta < _EPS
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3). (..., 3) -> (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    W = skew(w)
    W2 = W @ W
    small = theta < _EPS
    one = torch.ones_like(theta)
    safe2 = torch.where(small, one, theta2)
    safe3 = torch.where(small, one, theta2 * theta)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / safe3)
    return _eye_like(W) - a[..., None, None] * W + b[..., None, None] * W2


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) by SVD, with det fixed to +1."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    flip = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    ones = torch.ones_like(flip)
    U = U * torch.stack([ones, ones, flip], -1)[..., None, :]
    return U @ Vh


def se3_exp(xi: torch.Tensor):
    """se(3) -> SE(3). xi: (..., 6) as [rho (translation), phi (rotation)]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_right_jacobian(-phi)    # left Jacobian of phi
    t = (V @ rho[..., None])[..., 0]
    return R, t


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (..., 4) in (qx, qy, qz, qw) order, the
    TUM trajectory convention. Branch-free Shepperd's method: all four
    candidates are computed and the largest pivot's is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) * 0.5

    qw0 = pivot(1.0 + tr)
    s0 = 0.25 / qw0
    c0 = torch.stack([(m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0,
                      qw0], -1)
    qx1 = pivot(1.0 + m00 - m11 - m22)
    s1 = 0.25 / qx1
    c1 = torch.stack([qx1, (m01 + m10) * s1, (m02 + m20) * s1,
                      (m21 - m12) * s1], -1)
    qy2 = pivot(1.0 - m00 + m11 - m22)
    s2 = 0.25 / qy2
    c2 = torch.stack([(m01 + m10) * s2, qy2, (m12 + m21) * s2,
                      (m02 - m20) * s2], -1)
    qz3 = pivot(1.0 - m00 - m11 + m22)
    s3 = 0.25 / qz3
    c3 = torch.stack([(m02 + m20) * s3, (m12 + m21) * s3, qz3,
                      (m10 - m01) * s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1,
                                           torch.where(cond2, c2, c3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
