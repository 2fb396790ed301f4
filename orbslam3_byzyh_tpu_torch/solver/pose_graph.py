"""Pose-graph (essential-graph) optimization over Sim3, SE3 or 4 DoF.

Port of ``orbslam3_byzyh_tpu/solver/pose_graph.py`` (ORB-SLAM3's
``Optimizer::OptimizeEssentialGraph`` and its 4-DoF inertial variant).
Vertices are world -> keyframe Sim3s (R, t, s); an edge (i, j) holds the
relative Sim3 M_ij = S_i S_j^-1 taken when the graph was built, and its
residual is log(M_ij^-1 S_i S_j^-1). The per-edge (7, 7) Jacobians come
from ``torch.func.jacfwd`` at a zero tangent, the blocks are summed into a
(K, K, 7, 7) system by ``index_add_``, and each Gauss-Newton step is one
dense damped solve.

``dof_mask`` zeroes tangent dimensions: :data:`DOF_SIM3` (monocular loop
closing), :data:`DOF_SE3` (scale fixed) and :data:`DOF_4` (yaw and
translation, with ``right_perturb``: the tangent S exp(d) whose axes live in
the world frame, so that yaw is about gravity).

Two departures from the JAX function, each stated by
``tests/test_torch_sim3_posegraph.py``:
  * with ``n_live`` (the caller's keyframe count) the solve runs over the
    first ``bucket(n_live)`` vertices, not every slot: a vertex with no
    edge has a zero row and right-hand side, so its step is zero, and the
    live block does not couple to the rest. At 1024 slots this is a
    (7 x 256)^2 solve instead of 7168^2 for a 160-keyframe map;
  * the retraction re-projects rotations onto SO(3) by
    ``lie.project_rotation`` (Newton polar, no host synchronisation), not
    by SVD.
The iterations read nothing back to the host; on CUDA they replay as one
CUDA graph per (vertex bucket, edge count).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import device as device_mod
from ..ops import lie
from ..utils import cuda_graph

DOF_SIM3 = (1, 1, 1, 1, 1, 1, 1)
DOF_SE3 = (1, 1, 1, 1, 1, 1, 0)
DOF_4 = (1, 1, 1, 0, 0, 1, 0)   # t + yaw (z) only (Edge4DoF)

# The smallest vertex bucket of a live-prefix solve.
MIN_BUCKET = 16


def sim3_tuple_inv(S):
    return lie.sim3_inv(*S)


def sim3_tuple_mul(A, B):
    return lie.sim3_mul(*A, *B)


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """M_ij = S_i S_j^-1, an edge's measurement."""
    return lie.sim3_mul(Ri, ti, si, *lie.sim3_inv(Rj, tj, sj))


class PoseGraphResult(NamedTuple):
    R: torch.Tensor     # (K, 3, 3)
    t: torch.Tensor     # (K, 3)
    s: torch.Tensor     # (K,)
    cost: torch.Tensor


def _edge_residual(delta_i, delta_j, SiR, Sit, Sis, SjR, Sjt, Sjs, MiR, Mit,
                   Mis, right: bool):
    """r(d) = log(M^-1 S_i(d_i) S_j(d_j)^-1) for one edge, the vertices
    perturbed as exp(d) S (left) or S exp(d) (right). Scales are (1,)."""
    Ei = lie.sim3_exp1(delta_i)
    Ej = lie.sim3_exp1(delta_j)
    Si, Sj = (SiR, Sit, Sis), (SjR, Sjt, Sjs)
    if right:
        Si_new, Sj_new = lie.sim3_mul1(*Si, *Ei), lie.sim3_mul1(*Sj, *Ej)
    else:
        Si_new, Sj_new = lie.sim3_mul1(*Ei, *Si), lie.sim3_mul1(*Ej, *Sj)
    rel = lie.sim3_mul1(MiR, Mit, Mis,
                        *lie.sim3_mul1(*Si_new, *lie.sim3_inv1(*Sj_new)))
    r = lie.sim3_log1(*rel)
    return r, r


def edge_linearization(R, t, s, ei, ej, Minv, right: bool):
    """Residuals (E, 7) and Jacobians d r / d d_i, d r / d d_j (E, 7, 7) at
    zero tangents. ``Minv`` the edges' inverse measurements (R, t, s (E,))."""
    zeros = torch.zeros(ei.shape[0], 7, dtype=R.dtype, device=R.device)
    (Ji, Jj), r = vmap(
        jacfwd(_edge_residual, argnums=(0, 1), has_aux=True),
        in_dims=(0,) * 11 + (None,))(
        zeros, zeros, R[ei], t[ei], s[ei, None], R[ej], t[ej], s[ej, None],
        Minv[0], Minv[1], Minv[2][:, None], right)
    return r, Ji, Jj


def _build(R, t, s, ei, ej, Minv, w, dof, right: bool):
    n = R.shape[0]
    r, Ji, Jj = edge_linearization(R, t, s, ei, ej, Minv, right)
    Ji = Ji * dof
    Jj = Jj * dof
    cost = ((r * r).sum(-1) * w).sum()
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    Hii = torch.einsum("eri,erj->eij", Jiw, Ji)
    Hjj = torch.einsum("eri,erj->eij", Jjw, Jj)
    Hij = torch.einsum("eri,erj->eij", Jiw, Jj)
    H = R.new_zeros((n * n, 7, 7))
    H.index_add_(0, ei * n + ei, Hii)
    H.index_add_(0, ej * n + ej, Hjj)
    H.index_add_(0, ei * n + ej, Hij)
    H.index_add_(0, ej * n + ei, Hij.transpose(-1, -2))
    b = R.new_zeros((n, 7))
    b.index_add_(0, ei, -torch.einsum("eri,er->ei", Jiw, r))
    b.index_add_(0, ej, -torch.einsum("eri,er->ei", Jjw, r))
    return H.reshape(n, n, 7, 7), b, cost


def _solve(H, b, lam, fixed, dof):
    n = H.shape[0]
    k = torch.arange(n, device=H.device)
    free = (~fixed).to(H.dtype)
    H = H * free[:, None, None, None] * free[None, :, None, None]
    diag_fix = (fixed.to(H.dtype)[:, None]
                + (1.0 - dof)[None, :] * free[:, None]).clamp_max(1.0)
    H[k, k] += torch.diag_embed(diag_fix)
    b = b * free[:, None] * dof[None, :]
    Hd = H.permute(0, 2, 1, 3).reshape(n * 7, n * 7)
    damp = lam * torch.diagonal(Hd).clamp_min(1e-6)
    Hd = Hd + torch.diag(damp)
    return torch.linalg.solve_ex(Hd, b.reshape(-1, 1))[0].reshape(n, 7)


def _retract(R, t, s, dx, fixed, right: bool):
    E = lie.sim3_exp(dx)
    if right:
        Rn, tn, sn = lie.sim3_mul(R, t, s, *E)
    else:
        Rn, tn, sn = lie.sim3_mul(*E, R, t, s)
    Rn = torch.where(fixed[:, None, None], R, Rn)
    tn = torch.where(fixed[:, None], t, tn)
    sn = torch.where(fixed, s, sn)
    return lie.project_rotation(Rn), tn, sn


def _optimize(R, t, s, ei, ej, meas_R, meas_t, meas_s, w, fixed, dof,
              n_iters: int, right: bool):
    Minv = lie.sim3_inv(meas_R, meas_t, meas_s)
    _, _, cost = _build(R, t, s, ei, ej, Minv, w, dof, right)
    lam = torch.full((), 1e-4, dtype=R.dtype, device=R.device)
    for _ in range(n_iters):
        H, b, _ = _build(R, t, s, ei, ej, Minv, w, dof, right)
        dx = _solve(H, b, lam, fixed, dof)
        Rn, tn, sn = _retract(R, t, s, dx, fixed, right)
        _, _, cost_new = _build(Rn, tn, sn, ei, ej, Minv, w, dof, right)
        accept = cost_new < cost
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        s = torch.where(accept, sn, s)
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        cost = torch.where(accept, cost_new, cost)
    return R, t, s, cost


def optimize_pose_graph(R, t, s, edges_i, edges_j, meas_R, meas_t, meas_s,
                        edge_w, fixed, dof_mask, n_iters: int = 20,
                        right_perturb: bool = False,
                        n_live: int | None = None) -> PoseGraphResult:
    """Levenberg-Marquardt pose-graph optimization. R, t, s: (K, ...)
    vertex Sim3s; edges_*: (E,) endpoints; meas_*: the measurements M_ij;
    edge_w: (E,) weights (0 masks a padding edge); fixed: (K,) bool;
    dof_mask: 7 flags. With ``n_live`` every edge must join vertices below
    it, and the vertices from ``bucket(n_live)`` on are returned as they
    came (see the module docstring)."""
    K = R.shape[0]
    P = (K if n_live is None
         else cuda_graph.bucket(max(int(n_live), 1), MIN_BUCKET, K))
    dof = device_mod.upload(np.asarray(dof_mask, np.float32), R.device)
    Rp, tp, sp, cost = cuda_graph.call(
        "pose_graph", _optimize, R[:P], t[:P], s[:P], edges_i.long(),
        edges_j.long(), meas_R, meas_t, meas_s, edge_w, fixed[:P], dof,
        n_iters, right_perturb)
    if P < K:
        Rp = torch.cat([Rp, R[P:]])
        tp = torch.cat([tp, t[P:]])
        sp = torch.cat([sp, s[P:]])
    return PoseGraphResult(R=Rp, t=tp, s=sp, cost=cost)
