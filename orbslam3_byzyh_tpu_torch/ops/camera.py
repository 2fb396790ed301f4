"""Camera models. Port of ``orbslam3_byzyh_tpu/ops/camera.py``.

Pinhole, ``params = [fx, fy, cx, cy]``, with its unprojection and the
radial-tangential distortion ``dist = [k1, k2, p1, p2, (k3)]`` that the
front-end removes from raw detections. Every function keeps the JAX
package's float32 operation order. Kannala-Brandt 8 (``KB8``) raises
``NotImplementedError`` until it is ported.
"""

from __future__ import annotations

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


def _require_pinhole(model_id: int) -> None:
    if model_id != PINHOLE:
        raise NotImplementedError(
            f"camera model {model_id}: only PINHOLE is ported")


def project(model_id: int, params: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    _require_pinhole(model_id)
    return pinhole_project(params, pc)


def project_jac(model_id: int, params: torch.Tensor,
                pc: torch.Tensor) -> torch.Tensor:
    _require_pinhole(model_id)
    return pinhole_project_jac(params, pc)


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
