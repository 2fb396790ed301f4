"""Joint visual-inertial bundle adjustment over 15-DoF keyframe states.

Port of ``orbslam3_byzyh_tpu/solver/inertial_ba.py`` (ORB-SLAM3's
``Optimizer::LocalInertialBA`` and ``FullInertialBA``): reprojection rows
(stereo rows where ``obs_ur >= 0``), 9-dim preintegration factors and the
bias random walk between chain-consecutive keyframes, over the states
[pose (6), velocity (3), gyro bias (3), accel bias (3)].

The landmarks are Schur-eliminated with the port's ``solver/ba.py``
pieces (the one-hot ``schur_pieces``, as the JAX package assembles them;
their cross terms touch only the pose's 6 dims); the inertial edges add
15 x 15 blocks from ``torch.func.jacfwd`` of the edge residual, vmapped over
the edges. The reduced (15K, 15K) system is solved with
``torch.linalg.solve_ex`` and the LM accept/reject is a ``torch.where``:
nothing is read back to the host. On CUDA the whole solve is replayed as
one CUDA graph per problem shape (``utils/cuda_graph.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops import camera as cam
from ..ops import imu, lie
from ..utils import cuda_graph
from . import ba, inertial, lm


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


class VIBAProblem(NamedTuple):
    # Keyframe body states.
    R_wb: torch.Tensor       # (K, 3, 3)
    p_w: torch.Tensor        # (K, 3)
    v_w: torch.Tensor        # (K, 3)
    bg: torch.Tensor         # (K, 3)
    ba: torch.Tensor         # (K, 3)
    # Landmarks and observations, landmark-major (as ba.BAProblem).
    points: torch.Tensor     # (L, 3)
    obs_kf: torch.Tensor     # (L, O) window index, -1 none
    obs_uv: torch.Tensor     # (L, O, 2)
    obs_w: torch.Tensor      # (L, O)
    obs_valid: torch.Tensor  # (L, O)
    lm_valid: torch.Tensor   # (L,)
    # Inertial chain: edge e joins keyframe edges_i[e] -> edges_j[e].
    edges_i: torch.Tensor    # (E,)
    edges_j: torch.Tensor    # (E,)
    preints: imu.PreintState  # batched (E, ...)
    edge_valid: torch.Tensor  # (E,)
    walk_info: torch.Tensor   # (6,) bias random-walk information
    # Extrinsics and camera.
    R_cb: torch.Tensor       # (3, 3)
    t_cb: torch.Tensor       # (3,)
    cam_params: torch.Tensor
    fixed: torch.Tensor      # (K,) bool
    # Absolute bias prior weights [w_gyro, w_acc] on keyframe 0
    # (EdgePriorGyro / EdgePriorAcc of FullInertialBA).
    prior_bias_w: torch.Tensor  # (2,)
    # Optional stereo rows: right-image u per observation (-1 = mono) and
    # baseline x fx.
    obs_ur: torch.Tensor = None  # (L, O) or None
    bf: torch.Tensor = None


class VIBAResult(NamedTuple):
    R_wb: torch.Tensor
    p_w: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def camera_pose(R_wb, p_w, R_cb, t_cb):
    """Tcw of a body state: R_cw = R_cb R_wb^T, t_cw = t_cb - R_cw p_w."""
    R_cw = R_cb @ R_wb.transpose(-1, -2)
    return R_cw, t_cb - _mv(R_cw, p_w)


def _visual_system(p: VIBAProblem, R_wb, p_w, points, inlier, robust,
                   delta2, model_id):
    """Visual residuals and Jacobians with respect to the BODY pose tangent
    (right perturbation: R' = R exp(phi), p' = p + R dp), in the (L, O)
    layout, and their normal-equation blocks."""
    kf = p.obs_kf.clamp_min(0).long()
    Rk = R_wb[kf]                                    # (L, O, 3, 3)
    pk = p_w[kf]
    pw = points[:, None, :].expand(pk.shape)
    x_b = (Rk.transpose(-1, -2) @ (pw - pk)[..., None])[..., 0]
    x_c = x_b @ p.R_cb.T + p.t_cb
    uv = cam.project(model_id, p.cam_params, x_c)
    r = p.obs_uv - uv
    JR = cam.project_jac(model_id, p.cam_params, x_c) @ p.R_cb
    eye = torch.eye(3, dtype=x_b.dtype, device=x_b.device).expand(
        x_b.shape[:-1] + (3, 3))
    dxb_dpose = torch.cat([-eye, lie.skew(x_b)], -1)          # (L, O, 3, 6)
    Jp = -(JR @ dxb_dpose)
    Jl = -(JR @ Rk.transpose(-1, -2))                        # d x_b / d x_w
    depth_ok = x_c[..., 2] > 0.05

    if p.obs_ur is not None:
        # The stereo row u_r = u - bf / z_c.
        iz = 1.0 / x_c[..., 2].clamp_min(1e-6)
        has_ur = p.obs_ur >= 0.0
        r3 = torch.where(has_ur, p.obs_ur - (uv[..., 0] - p.bf * iz), 0.0)
        e = p.bf * iz * iz
        row2 = p.R_cb[2]                                     # d z_c / d x_b
        M = (row2 @ dxb_dpose)                               # (L, O, 6)
        N = _mv(Rk, row2)                                    # (L, O, 3)
        Jp3 = torch.where(has_ur[..., None],
                          Jp[..., 0, :] - e[..., None] * M, 0.0)
        Jl3 = torch.where(has_ur[..., None],
                          Jl[..., 0, :] - e[..., None] * N, 0.0)
        r = torch.cat([r, r3[..., None]], -1)
        Jp = torch.cat([Jp, Jp3[..., None, :]], -2)
        Jl = torch.cat([Jl, Jl3[..., None, :]], -2)

    chi2 = (r * r).sum(-1) * p.obs_w
    mask = (p.obs_valid & inlier & depth_ok & (p.obs_kf >= 0)
            & p.lm_valid[:, None])
    w_rob = lm.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = w_rob * p.obs_w * mask
    if robust:
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * chi2) - delta2)
    else:
        rho = chi2
    cost = (rho * mask).sum()

    Jpw = Jp * w[..., None, None]
    Jlw = Jl * w[..., None, None]
    return dict(Hll=torch.einsum("lori,lorj->lij", Jlw, Jl),
                bl=-torch.einsum("lori,lor->li", Jlw, r),
                W=torch.einsum("lori,lorj->loij", Jpw, Jl),
                Hpp_o=torch.einsum("lori,lorj->loij", Jpw, Jp),
                bp_o=-torch.einsum("lori,lor->loi", Jpw, r),
                cost=cost, chi2=chi2, mask=mask)


def _edge_residual(di, dj, Ri, pi, vi, bgi, bai, Rj, pj, vj, bgj, baj, pre,
                   Ws, wi):
    """One edge's 15 rows as a function of its endpoints' 15-tangents."""
    def apply(d, R, pp, v, bgv, bav):
        return (R @ lie.so3_exp(d[3:6]), pp + _mv(R, d[:3]), v + d[6:9],
                bgv + d[9:12], bav + d[12:15])

    Ri_, pi_, vi_, bgi_, bai_ = apply(di, Ri, pi, vi, bgi, bai)
    Rj_, pj_, vj_, bgj_, baj_ = apply(dj, Rj, pj, vj, bgj, baj)
    r9 = _mv(Ws, inertial.inertial_residual(Ri_, pi_, vi_, Rj_, pj_, vj_,
                                            bgi_, bai_, pre))
    r_rw = torch.cat([bgj_ - bgi_, baj_ - bai_]) * wi
    r = torch.cat([r9, r_rw])
    return r, r


def _inertial_blocks(p: VIBAProblem, R_wb, p_w, v_w, bg, ba_):
    """Per-edge 15 x 15 blocks and right-hand sides of the preintegration
    and bias random-walk rows, linearized by forward mode at zero
    tangents."""
    Wsqrt = inertial.preint_info_sqrt(p.preints)            # (E, 9, 9)
    wi = torch.sqrt(p.walk_info)
    ei, ej = p.edges_i.long(), p.edges_j.long()
    zeros = torch.zeros(ei.shape[0], 15, device=R_wb.device)
    (Ji, Jj), r = vmap(
        jacfwd(_edge_residual, argnums=(0, 1), has_aux=True),
        in_dims=(0,) * 14 + (None,))(
        zeros, zeros, R_wb[ei], p_w[ei], v_w[ei], bg[ei], ba_[ei],
        R_wb[ej], p_w[ej], v_w[ej], bg[ej], ba_[ej], p.preints, Wsqrt, wi)
    ev = p.edge_valid.to(r.dtype)
    r = r * ev[:, None]
    Ji = Ji * ev[:, None, None]
    Jj = Jj * ev[:, None, None]
    Ji_T = Ji.transpose(-1, -2)
    Jj_T = Jj.transpose(-1, -2)
    return (Ji_T @ Ji, Jj_T @ Jj, Ji_T @ Jj, -_mv(Ji_T, r), -_mv(Jj_T, r),
            (r * r).sum())


def problem_cost(p: VIBAProblem, model_id: int = cam.PINHOLE) -> torch.Tensor:
    """The whole objective at the problem's own states: the visual rows
    without the robust kernel (all observations), the inertial and
    random-walk rows, the bias prior. For checking that a solve lowers
    it."""
    delta2 = (lm.CHI2_MONO if p.obs_ur is None else torch.where(
        p.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO))
    vis = _visual_system(p, p.R_wb, p.p_w, p.points,
                         torch.ones_like(p.obs_valid), False, delta2,
                         model_id)
    inr = _inertial_blocks(p, p.R_wb, p.p_w, p.v_w, p.bg, p.ba)
    prior = (p.prior_bias_w[0] * (p.bg[0] ** 2).sum()
             + p.prior_bias_w[1] * (p.ba[0] ** 2).sum())
    return vis["cost"] + inr[5] + prior


# The system blocks an accepted step carries into the next iteration.
_CARRIED = ("Hll", "bl", "W", "Hpp_o", "bp_o")


def vi_bundle_adjust(p: VIBAProblem, model_id: int = cam.PINHOLE,
                     stages: tuple = (5, 10)) -> VIBAResult:
    """LM over the visual-inertial system, ``stages`` iterations a stage;
    between stages the visual rows are re-gated (chi2 <= 5.991, 7.815 on a
    stereo row) and the last stage drops the robust kernel. A fixed
    keyframe keeps every state."""
    return cuda_graph.call("vi_bundle_adjust", _vi_bundle_adjust, p,
                           int(model_id), tuple(stages))


def _vi_bundle_adjust(p: VIBAProblem, model_id, stages) -> VIBAResult:
    if p.obs_ur is None:
        delta2 = lm.CHI2_MONO
    else:
        delta2 = torch.where(p.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)
    n_kf = p.R_wb.shape[0]
    dev = p.R_wb.device
    k = torch.arange(n_kf, device=dev)
    ei, ej = p.edges_i.long(), p.edges_j.long()
    wg, wa = p.prior_bias_w[0], p.prior_bias_w[1]
    zero9 = torch.zeros(9, device=dev)
    prior_diag = torch.diag(torch.cat([zero9, wg.expand(3), wa.expand(3)]))
    free = (~p.fixed).to(torch.float32)
    eye15 = torch.eye(15, device=dev)

    def build_sys(state, inlier, robust):
        """Both factor families linearized at ``state``, with the total
        cost: one build serves the acceptance test and the next step."""
        R_wb, p_w, v_w, bg, ba_, points = state
        vis = _visual_system(p, R_wb, p_w, points, inlier, robust, delta2,
                             model_id)
        inr = _inertial_blocks(p, R_wb, p_w, v_w, bg, ba_)
        prior_cost = (wg * (bg[0] ** 2).sum() + wa * (ba_[0] ** 2).sum())
        sys = {n: vis[n] for n in _CARRIED}
        sys["inr"] = inr[:5]
        sys["cost"] = vis["cost"] + inr[5] + prior_cost
        return sys

    def step_from(sys, state, lam):
        pieces = ba.schur_pieces(p.obs_kf, sys, lam, n_kf)
        Hii, Hjj, Hij, bi, bj = sys["inr"]
        R_wb, p_w, v_w, bg, ba_, points = state

        # The 15-dof system, (K, K, 15, 15).
        S = torch.zeros(n_kf, n_kf, 15, 15, device=dev)
        S6 = -pieces["cross"]
        S6[k, k] += pieces["Hpp"]
        S[:, :, :6, :6] += S6
        rhs = torch.zeros(n_kf, 15, device=dev)
        rhs[:, :6] += pieces["bp"] - pieces["corr"]
        Sf = S.view(n_kf * n_kf, 15, 15)
        Sf.index_add_(0, ei * n_kf + ei, Hii)
        Sf.index_add_(0, ej * n_kf + ej, Hjj)
        Sf.index_add_(0, ei * n_kf + ej, Hij)
        Sf.index_add_(0, ej * n_kf + ei, Hij.transpose(-1, -2))
        rhs.index_add_(0, ei, bi)
        rhs.index_add_(0, ej, bj)

        # The absolute bias prior on keyframe 0 (r = bias, J = I).
        S[0, 0] += prior_diag
        rhs[0, 9:12] -= wg * bg[0]
        rhs[0, 12:15] -= wa * ba_[0]

        # Damping, then the fixed keyframes' identity rows.
        diag = torch.diagonal(S[k, k], dim1=-2, dim2=-1)
        S[k, k] += torch.diag_embed(lam * diag.clamp_min(1e-9) + 1e-8)
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S[k, k] += eye15 * p.fixed.to(torch.float32)[:, None, None]
        rhs = rhs * free[:, None]

        Sd = S.permute(0, 2, 1, 3).reshape(n_kf * 15, n_kf * 15)
        dx, _ = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1))
        dx = dx.reshape(n_kf, 15)
        dl = ba.back_substitute(p.obs_kf, sys, pieces["Hll_inv"],
                                pieces["has_obs"], dx[:, :6])

        keep = p.fixed
        R_new = torch.where(keep[:, None, None], R_wb,
                            R_wb @ lie.so3_exp(dx[:, 3:6]))
        p_new = torch.where(keep[:, None], p_w, p_w + _mv(R_wb, dx[:, :3]))
        v_new = torch.where(keep[:, None], v_w, v_w + dx[:, 6:9])
        bg_new = torch.where(keep[:, None], bg, bg + dx[:, 9:12])
        ba_new = torch.where(keep[:, None], ba_, ba_ + dx[:, 12:15])
        return (R_new, p_new, v_new, bg_new, ba_new, points + dl)

    state = (p.R_wb, p.p_w, p.v_w, p.bg, p.ba, p.points)
    inlier = torch.ones_like(p.obs_valid)
    for si, n_iters in enumerate(stages):
        robust = si < len(stages) - 1
        sys = build_sys(state, inlier, robust)
        lam = torch.full((), 1e-4, device=dev)
        for _ in range(n_iters):
            # One linearization per iteration: the candidate's system is
            # kept when it is accepted.
            cand = step_from(sys, state, lam)
            sys_c = build_sys(cand, inlier, robust)
            acc = sys_c["cost"] < sys["cost"]
            state = tuple(torch.where(acc, b, a) for a, b in zip(state, cand))
            sys = {n: (tuple(torch.where(acc, b, a)
                             for a, b in zip(sys[n], sys_c[n]))
                       if n == "inr" else torch.where(acc, sys_c[n], sys[n]))
                   for n in sys}
            lam = torch.where(acc, lam * 0.5, lam * 10.0)

        # Re-gate the visual outliers.
        R_wb, p_w, _, _, _, points = state
        vis = _visual_system(p, R_wb, p_w, points,
                             torch.ones_like(p.obs_valid), False, delta2,
                             model_id)
        inlier = vis["chi2"] <= delta2

    R_wb, p_w, v_w, bg, ba_, points = state
    vis = _visual_system(p, R_wb, p_w, points, inlier, False, delta2, model_id)
    return VIBAResult(R_wb=R_wb, p_w=p_w, v_w=v_w, bg=bg, ba=ba_,
                      points=points, obs_inlier=inlier & vis["mask"],
                      cost=vis["cost"])
