"""Camera models. Port of ``orbslam3_byzyh_tpu/ops/camera.py``.

Pinhole, ``params = [fx, fy, cx, cy]``, with its unprojection and the
radial-tangential distortion ``dist = [k1, k2, p1, p2, (k3)]`` that the
front-end removes from raw detections; Kannala-Brandt 8 (``KB8``, the
equidistant fisheye of TUM-VI), ``params = [fx, fy, cx, cy, k0, k1, k2,
k3]`` with r(theta) = theta + k0 theta^3 + k1 theta^5 + k2 theta^7 + k3
theta^9. ``project``, ``unproject`` and ``project_jac`` dispatch on the
model id. Every function keeps the JAX package's float32 operation order
and its guards (1e-9 on the radius and the Newton step's slope, 1e-12 on
the Jacobian's squared radius).
"""

from __future__ import annotations

import numpy as np
import torch

PINHOLE = 0
KB8 = 1


def _safe_inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def pinhole_project(params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _safe_inv_z(pc[..., 2])
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    return torch.stack([u, v], -1)


def pinhole_unproject(params: torch.Tensor,
                      uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-z rays (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], -1)


def pinhole_project_jac(params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(point): (..., 2, 3)."""
    fx, fy = params[0], params[1]
    x, y = pc[..., 0], pc[..., 1]
    inv_z = _safe_inv_z(pc[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1)
    return torch.stack([row0, row1], -2)


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` with its entries below ``eps`` replaced by ``eps``."""
    return torch.where(x < eps, torch.full_like(x, eps), x)


def _kb8_coeffs(params: torch.Tensor):
    return params[4], params[5], params[6], params[7]


def kb8_project(params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2); a point on the axis
    goes to the principal point."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = _kb8_coeffs(params)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    R = torch.sqrt(x * x + y * y)
    theta = torch.atan2(R, z)
    th2 = theta * theta
    r = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    on_axis = R < 1e-9
    inv_R = 1.0 / _guard(R, 1e-9)
    psi_cos = torch.where(on_axis, 1.0, x * inv_R)
    psi_sin = torch.where(on_axis, 0.0, y * inv_R)
    return torch.stack([fx * r * psi_cos + cx, fy * r * psi_sin + cy], -1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  iters: int = 10) -> torch.Tensor:
    """Pixels (..., 2) -> unit-z rays (..., 3): r(theta) inverted by
    ``iters`` Newton steps from theta = r_d, with r_d clamped to pi / 2
    (KannalaBrandt8.cpp's clamp of theta_d)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = _kb8_coeffs(params)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = torch.sqrt(mx * mx + my * my)
    r_d_c = torch.clamp_max(r_d, float(np.float32(np.pi / 2.0)))
    theta = r_d_c
    for _ in range(iters):
        th2 = theta * theta
        th4 = th2 * th2
        th6 = th4 * th2
        th8 = th4 * th4
        f = theta * (1.0 + k0 * th2 + k1 * th4 + k2 * th6 + k3 * th8) - r_d_c
        fp = 1.0 + 3 * k0 * th2 + 5 * k1 * th4 + 7 * k2 * th6 + 9 * k3 * th8
        fp = torch.where(fp.abs() < 1e-9, torch.full_like(fp, 1e-9), fp)
        theta = theta - f / fp
    scale = torch.tan(theta) / _guard(r_d, 1e-9)
    scale = torch.where(r_d < 1e-9, 1.0, scale)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], -1)


def kb8_project_jac(params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(point): (..., 2, 3), analytic, the squared radius guarded
    at 1e-12."""
    fx, fy = params[0], params[1]
    k0, k1, k2, k3 = _kb8_coeffs(params)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(_guard(r2, 1e-12))
    r3 = r2 * r
    theta = torch.atan2(r, z)
    th2 = theta * theta
    th4 = th2 * th2
    th6 = th4 * th2
    th8 = th4 * th4
    f = theta * (1.0 + k0 * th2 + k1 * th4 + k2 * th6 + k3 * th8)
    fp = 1.0 + 3 * k0 * th2 + 5 * k1 * th4 + 7 * k2 * th6 + 9 * k3 * th8
    norm2 = r2 + z * z
    dtheta_dx = x * z / (norm2 * r)
    dtheta_dy = y * z / (norm2 * r)
    dtheta_dz = -r / norm2
    du_dx = fx * (fp * dtheta_dx * x / r + f * y * y / r3)
    du_dy = fx * (fp * dtheta_dy * x / r - f * x * y / r3)
    du_dz = fx * fp * dtheta_dz * x / r
    dv_dx = fy * (fp * dtheta_dx * y / r - f * x * y / r3)
    dv_dy = fy * (fp * dtheta_dy * y / r + f * x * x / r3)
    dv_dz = fy * fp * dtheta_dz * y / r
    row0 = torch.stack([du_dx, du_dy, du_dz], -1)
    row1 = torch.stack([dv_dx, dv_dy, dv_dz], -1)
    return torch.stack([row0, row1], -2)


def project(model_id: int, params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_project(params, pc)
    return kb8_project(params, pc)


def unproject(model_id: int, params: torch.Tensor,
              uv: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model_id: int, params: torch.Tensor,
                pc: torch.Tensor) -> torch.Tensor:
    if model_id == PINHOLE:
        return pinhole_project_jac(params, pc)
    return kb8_project_jac(params, pc)


def _radtan_coeffs(dist: torch.Tensor):
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else torch.zeros_like(k1)
    return k1, k2, p1, p2, k3


def radtan_distort(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def radtan_undistort(dist: torch.Tensor, xy_d: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert the distortion by ``iters`` fixed-point iterations
    (cv::undistortPoints style), guarding the radial factor at 1e-9."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(dist)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_r = 1.0 / torch.where(radial.abs() < 1e-9,
                                  torch.full_like(radial, 1e-9), radial)
        x = (xd - dx) * inv_r
        y = (yd - dy) * inv_r
    return torch.stack([x, y], -1)


def undistort_pixels(params: torch.Tensor, dist: torch.Tensor,
                     uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixel -> undistorted pixel under the same intrinsics."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xy = radtan_undistort(dist, torch.stack([x, y], -1), iters)
    u = fx * xy[..., 0] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], -1)
