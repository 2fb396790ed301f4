"""Camera models. Port of ``orbslam3_byzyh_tpu/ops/camera.py``.

Pinhole only for now: ``params = [fx, fy, cx, cy]``. Kannala-Brandt 8
(``KB8``) raises ``NotImplementedError`` until it is ported.
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
