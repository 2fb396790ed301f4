"""Batched SO(3), SE(3) and Sim(3) operations.

Port of ``orbslam3_byzyh_tpu/ops/lie.py``: rotations are 3x3 matrices,
poses are (R, t) pairs, similarities (R, t, s) triples, and every function
takes arbitrary leading batch dimensions. Small-angle branches select
Taylor series with ``torch.where``; every quotient that a branch discards
divides by a "safe" value, so forward-mode derivatives at a zero tangent
(the pose graph's Jacobians) stay finite.

Two projections onto SO(3): :func:`normalize_rotation` is the JAX package's
SVD (on CUDA ``torch.linalg.svd`` synchronises the stream);
:func:`project_rotation` is a sync-free Newton polar iteration with the JAX
package's custom JVP, for the inertial code, which projects once per IMU
sample and differentiates through the projection.
"""

from __future__ import annotations

import math

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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`skew`. (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _angle2(w: torch.Tensor) -> torch.Tensor:
    """|w|^2 as (..., 1): the scalar factors below keep a trailing axis,
    because forward-mode differentiation (``torch.func.jvp``) of a 0-d
    tensor combined with a Python number gives a float64 tangent in some
    torch versions."""
    return (w * w).sum(-1, keepdim=True)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = _angle2(w)
    theta = torch.sqrt(theta2)
    W = skew(w)
    W2 = W @ W
    small = theta < _EPS
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    return _eye_like(W) + a[..., None] * W + b[..., None] * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3). (..., 3) -> (..., 3, 3)."""
    theta2 = _angle2(w)
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
    return _eye_like(W) - a[..., None] * W + b[..., None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3): (..., 3, 3) -> (..., 3). The angle is
    atan2(sin, cos) (smooth at the identity under differentiation); within
    1e-3 of pi the axis comes from the diagonal of (R + R^T) / 2."""
    # Scalars as (..., 1), as in so3_exp.
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5         # sin(theta) * axis
    sin_theta = torch.sqrt(_angle2(w_vee) + 1e-14)
    theta = torch.atan2(sin_theta, cos_theta)
    near_pi = theta > (math.pi - 1e-3)
    w_generic = theta / torch.where(near_pi, torch.ones_like(sin_theta),
                                    sin_theta) * w_vee

    Rp = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], -1)
    axis = torch.sqrt(((diag - cos_theta)
                       / (1.0 - cos_theta).clamp_min(1e-8)).clamp_min(0.0))
    axis = axis * torch.where(w_vee >= 0.0, 1.0, -1.0)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1,
                                           keepdim=True).clamp_min(1e-8)
    return torch.where(near_pi, theta * axis, w_generic)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3). (..., 3) -> (..., 3, 3)."""
    theta2 = _angle2(w)
    theta = torch.sqrt(theta2)
    W = skew(w)
    W2 = W @ W
    small = theta < _EPS
    one = torch.ones_like(theta)
    safe = torch.where(small, one, theta)
    safe2 = torch.where(small, one, theta2)
    sin_t, cos_t = torch.sin(safe), torch.cos(safe)
    sin_safe = torch.where(sin_t.abs() < 1e-8, one, sin_t)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / safe2 - (1.0 + cos_t) / (2.0 * safe * sin_safe))
    return _eye_like(W) + 0.5 * W + c[..., None] * W2


# Newton polar iterations of project_rotation. Each squares the distance
# from SO(3): a product of float32 rotations (1e-7 off) is at float32
# rounding after one, an input 1e-3 off after two.
POLAR_ITERS = 2


def _inv_transpose(X: torch.Tensor) -> torch.Tensor:
    """X^-T of a batch of 3x3 matrices: the cofactor matrix over the
    determinant, with columns x1 x x2, x2 x x0, x0 x x1."""
    a, b, c = X[..., :, 0], X[..., :, 1], X[..., :, 2]
    bc = torch.linalg.cross(b, c, dim=-1)
    det = (a * bc).sum(-1)
    cof = torch.stack([bc, torch.linalg.cross(c, a, dim=-1),
                       torch.linalg.cross(a, b, dim=-1)], -1)
    return cof / det[..., None, None]


def _polar(R: torch.Tensor) -> torch.Tensor:
    X = R
    for _ in range(POLAR_ITERS):
        X = 0.5 * (X + _inv_transpose(X))
    return X


def _tangent_projection(Rn: torch.Tensor, dR: torch.Tensor) -> torch.Tensor:
    """The JAX package's custom JVP of ``normalize_rotation``: the tangent
    projected onto SO(3)'s tangent space at Rn, (dR - Rn dR^T Rn) / 2. The
    map is its own adjoint, so it is the backward rule too."""
    return 0.5 * (dR - Rn @ dR.transpose(-1, -2) @ Rn)


class _ProjectRotation(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(R):
        return _polar(R)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)
        ctx.save_for_backward(output)

    @staticmethod
    def jvp(ctx, dR):
        (Rn,) = ctx.saved_tensors
        return _tangent_projection(Rn, dR)

    @staticmethod
    def backward(ctx, g):
        (Rn,) = ctx.saved_tensors
        return _tangent_projection(Rn, g)


def project_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation (det > 0) onto SO(3) without synchronising:
    ``POLAR_ITERS`` Newton polar iterations X <- (X + X^-T) / 2, which
    converge to the polar factor, the SVD's U V^T. It stands in for the JAX
    package's ``normalize_rotation`` (within 1e-6 on rotations 1e-3 off,
    ``tests/test_torch_imu.py``) and carries its custom JVP: forward-mode
    (``torch.func.jacfwd``) and reverse-mode differentiation see the tangent
    projection at the output, not the iteration."""
    return _ProjectRotation.apply(R)


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


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3): Jl^-1(phi) = Jr^-1(-phi)."""
    return so3_right_jacobian_inv(-phi)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3) tangent (..., 6) as [rho, phi]."""
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_mul(Ra, ta, Rb, tb):
    """Compose (Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, p):
    """Transform points p (..., 3) by the pose (R, t)."""
    return (R @ p[..., None])[..., 0] + t


# Sim(3): (R, t, s), x -> s R x + t (Sophus / g2o::Sim3).

def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    R, t = se3_identity(batch_shape, dtype, device)
    return R, t, torch.ones(batch_shape, dtype=dtype, device=device)


# The Sim(3) maps below take and return the scale as (..., 1) (see
# :func:`_angle2`): the pose graph differentiates them in forward mode.
# The public ones take and return it as (...), as the JAX package does.

def sim3_mul1(Ra, ta, sa, Rb, tb, sb):
    """:func:`sim3_mul` with (..., 1) scales."""
    return Ra @ Rb, sa * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_inv1(R, t, s):
    """:func:`sim3_inv` with a (..., 1) scale."""
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv * (Rt @ t[..., None])[..., 0], s_inv


def sim3_exp1(xi: torch.Tensor):
    """:func:`sim3_exp` returning a (..., 1) scale."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    s = torch.exp(sigma)
    W = _sim3_calc_w(phi, sigma, s)
    return so3_exp(phi), (W @ rho[..., None])[..., 0], s


def sim3_log1(R, t, s):
    """:func:`sim3_log` of a (..., 1) scale."""
    sigma = torch.log(s)
    phi = so3_log(R)
    W = _sim3_calc_w(phi, sigma, s)
    # W^-1 by cofactors: no host synchronisation, forward-mode friendly.
    rho = (_inv_transpose(W).transpose(-1, -2) @ t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma], -1)


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """Compose: x -> sa Ra (sb Rb x + tb) + ta."""
    R, t, s = sim3_mul1(Ra, ta, sa[..., None], Rb, tb, sb[..., None])
    return R, t, s[..., 0]


def sim3_inv(R, t, s):
    Ri, ti, si = sim3_inv1(R, t, s[..., None])
    return Ri, ti, si[..., 0]


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_exp(xi: torch.Tensor):
    """sim(3) -> Sim(3). xi (..., 7) = [rho, phi, sigma] (Sophus order)."""
    R, t, s = sim3_exp1(xi)
    return R, t, s[..., 0]


def sim3_log(R, t, s):
    """Sim(3) -> sim(3) tangent (..., 7)."""
    return sim3_log1(R, t, s[..., None])


def _sim3_calc_w(phi, sigma, scale):
    """Sophus's ``calcW`` (the scaled left Jacobian): the general,
    small-theta, small-sigma and both-small cases selected by
    ``torch.where``. ``sigma`` and ``scale`` are (..., 1), as every scalar
    factor here (see :func:`_angle2`)."""
    theta2 = _angle2(phi)
    theta = torch.sqrt(theta2)
    W = skew(phi)
    W2 = W @ W
    small_theta = theta < _EPS
    small_sigma = sigma.abs() < _EPS
    sigma2 = sigma * sigma
    one = torch.ones_like(theta)
    safe_theta = torch.where(small_theta, one, theta)
    safe_theta2 = torch.where(small_theta, one, theta2)
    one_s = torch.ones_like(sigma)
    safe_sigma = torch.where(small_sigma, one_s, sigma)
    safe_sigma2 = torch.where(small_sigma, one_s, sigma2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    # C = (e^sigma - 1) / sigma, 1 + sigma / 2 as sigma -> 0.
    C = torch.where(small_sigma, 1.0 + sigma * 0.5,
                    (scale - 1.0) / safe_sigma)
    # sigma ~ 0:
    A_s0 = torch.where(small_theta, 0.5 * one, (1.0 - cos_t) / safe_theta2)
    B_s0 = torch.where(small_theta, one / 6.0,
                       (theta - sin_t) / (safe_theta2 * safe_theta))
    # theta ~ 0, any sigma:
    A_t0 = ((sigma - 1.0) * scale + 1.0) / safe_sigma2
    B_t0 = ((scale * 0.5 * sigma2 + scale - 1.0 - sigma * scale)
            / (safe_sigma2 * safe_sigma))
    # general:
    a = scale * sin_t
    b = scale * cos_t
    c = safe_theta2 + sigma2
    A_g = (a * sigma + (1.0 - b) * safe_theta) / (safe_theta * c)
    B_g = (C - ((b - 1.0) * sigma + a * safe_theta) / c) / safe_theta2

    A = torch.where(small_sigma, A_s0, torch.where(small_theta, A_t0, A_g))
    B = torch.where(small_sigma, B_s0, torch.where(small_theta, B_t0, B_g))
    return (A[..., None] * W + B[..., None] * W2
            + C[..., None] * _eye_like(W))


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (qx, qy, qz, qw) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)
