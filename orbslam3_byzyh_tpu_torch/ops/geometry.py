"""Multi-view geometry: the projection matrix and DLT triangulation.

Port of the two functions of ``orbslam3_byzyh_tpu/ops/geometry.py`` that
the keyframe bundle's triangulation uses (GeometricTools::Triangulate). The
two-view initialization and its RANSAC come with the monocular system.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor,
                    x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. P1, P2: (3, 4) projection matrices; x1, x2:
    (..., 2) coordinates consistent with them. Returns (..., 3): the right
    singular vector of the smallest singular value, dehomogenised.

    ``torch.linalg.svd`` synchronises with the host on CUDA (it has no
    ``_ex`` form); the keyframe bundle calls it once per neighbour."""
    rows = torch.stack([
        x1[..., 0, None] * P1[2] - P1[0],
        x1[..., 1, None] * P1[2] - P1[1],
        x2[..., 0, None] * P2[2] - P2[0],
        x2[..., 1, None] * P2[2] - P2[1],
    ], dim=-2)                                     # (..., 4, 4)
    _, _, vh = torch.linalg.svd(rows)
    Xh = vh[..., 3, :]
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], world-to-camera (Tcw)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)
