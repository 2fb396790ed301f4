"""Inertial factors and optimizers: the preintegration residual, the
inertial-only initialization, the tracking-time pose-inertial optimization.

Port of ``orbslam3_byzyh_tpu/solver/inertial.py`` (ORB-SLAM3's
``EdgeInertial``/``EdgeInertialGS``, ``Optimizer::InertialOptimization``,
``PoseInertialOptimizationLastKeyFrame``/``LastFrame`` and the bias
random-walk edges). States are BODY frame (R_wb, p_w, v_w); the camera
extrinsics enter only in the visual rows.

The Jacobians come from ``torch.func.jacfwd`` on tangent perturbations, as
the JAX package takes them from ``jax.jacfwd``: one batched forward-mode
pass per linearization. The projection onto SO(3) inside the retraction is
:func:`lie.project_rotation`, which carries the JAX package's custom JVP.
Every solve is ``torch.linalg.solve_ex`` and the Cholesky ``cholesky_ex``,
which report failure in a tensor; the LM accept/reject is a
``torch.where``. The one operation that waits for the device is the
eigendecomposition of a carried marginalization prior (:func:`prior_sqrt`,
``torch.linalg.eigh``); a caller that runs it before it queues other work
pays nothing for the wait. On CUDA each solve is replayed as a CUDA graph
(``utils/cuda_graph.py``): the host then launches one graph where it
would launch tens of thousands of small operations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..ops import camera as cam
from ..ops import imu, lie
from ..utils import cuda_graph


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def inertial_residual(R_i, p_i, v_i, R_j, p_j, v_j, bg, ba, preint,
                      g_w=None) -> torch.Tensor:
    """The 9-dim preintegration residual [r_dR, r_dV, r_dP] (EdgeInertial).
    ``preint`` an :class:`imu.PreintState` batched as the poses; bg / ba the
    current bias estimate, applied through the bias Jacobians."""
    if g_w is None:
        g_w = imu.gravity_vec(R_i)
    t = preint.dT[..., None]
    bias = torch.cat([bg, ba], -1)
    dR = imu.delta_rotation(preint, bias, normalize=False)
    dV = imu.delta_velocity(preint, bias)
    dP = imu.delta_position(preint, bias)
    Ri_T = R_i.transpose(-1, -2)
    r_dR = lie.so3_log(dR.transpose(-1, -2) @ (Ri_T @ R_j))
    r_dV = _mv(Ri_T, v_j - v_i - g_w * t) - dV
    r_dP = _mv(Ri_T, p_j - p_i - v_i * t - 0.5 * g_w * (t * t)) - dP
    return torch.cat([r_dR, r_dV, r_dP], -1)


def preint_info_sqrt(preint, eps: float = 1e-8) -> torch.Tensor:
    """Whitening W with W^T W = C[:9, :9]^-1: the inverse Cholesky factor of
    the symmetrised, floored covariance (``cholesky_ex``, no host check)."""
    C = preint.C[..., :9, :9]
    C = 0.5 * (C + C.transpose(-1, -2))
    eye = torch.eye(9, dtype=C.dtype, device=C.device).expand(C.shape)
    L, _ = torch.linalg.cholesky_ex(C + eps * eye)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _solve_damped(H, b, lam):
    """(H + lam diag(max(diag H, 1e-9))) dx = b, without a host check."""
    d = torch.diagonal(H).clamp_min(1e-9)
    dx, _ = torch.linalg.solve_ex(H + torch.diag(lam * d), b[:, None])
    return dx[:, 0]


def _lm_iteration(res_fn, x, lam, cost):
    """One LM iteration of the JAX package's loops: the Jacobian by
    forward mode, the damped normal equations, accept iff the cost falls."""
    J, r = jacfwd(lambda x_: (res_fn(x_),) * 2, has_aux=True)(x)
    dx = _solve_damped(J.T @ J, -(J.T @ r), lam)
    x_new = x + dx
    r_new = res_fn(x_new)
    c_new = (r_new * r_new).sum()
    acc = c_new < cost
    return (torch.where(acc, x_new, x),
            torch.where(acc, lam * 0.5, lam * 10.0),
            torch.where(acc, c_new, cost))


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor      # (3, 3) gravity-direction rotation (world <- g)
    scale: torch.Tensor     # () map scale correction
    bg: torch.Tensor        # (3,)
    ba: torch.Tensor        # (3,)
    vel: torch.Tensor       # (K, 3) body velocities
    cost: torch.Tensor


def inertial_only_optimization(R_wb, p_w, preints, prior_g: float,
                               prior_a: float, n_iters: int = 60,
                               fix_scale: bool = False) -> InertialInitResult:
    """MAP estimate of gravity direction, scale, biases and velocities with
    the visual map frozen (InertialOptimization). R_wb (K, 3, 3), p_w (K, 3)
    body states from vision; ``preints`` batched (K - 1) between consecutive
    keyframes; prior_g / prior_a the bias prior weights.

    On CUDA the chain is padded (:func:`pad_chain`) to
    :func:`cuda_graph.bucket`'s next power of two from 16 keyframes, so
    that one graph serves every chain of that length; the bias priors ride
    in as tensors for the same reason. On the CPU nothing is captured and
    nothing is padded."""
    n_kf = R_wb.shape[0]
    dev = R_wb.device
    n_pad = (cuda_graph.bucket(n_kf, 16) - n_kf) if dev.type == "cuda" else 0
    sqrt_prior = torch.cat([torch.full((1,), math.sqrt(w), device=dev)
                            for w in (prior_g, prior_a)])
    res = cuda_graph.call("inertial_only", _inertial_only,
                          *pad_chain(R_wb, p_w, preints, n_pad), sqrt_prior,
                          int(n_iters), bool(fix_scale))
    return res._replace(vel=res.vel[n_pad:])


def pad_chain(R_wb, p_w, preints, n_pad: int):
    """The chain with ``n_pad`` keyframes put before its oldest, and the
    weight (K + n_pad - 1,) of each preintegration: a pad keyframe repeats
    the oldest pose, its preintegration is empty and weighs 0, and its
    velocity starts at zero and stays there (no residual sees it), so the
    inertial-only solve of the padded chain is that of the chain. Returns
    (R_wb, p_w, preints, weight)."""
    dev = R_wb.device
    idle = imu.init_state(preints.bias[:1].expand(n_pad, 6))
    preints = imu.PreintState(*(torch.cat(x) for x in zip(idle, preints)))
    weight = (torch.arange(R_wb.shape[0] + n_pad - 1, device=dev)
              >= n_pad).float()
    return (torch.cat([R_wb[:1].expand(n_pad, 3, 3), R_wb]),
            torch.cat([p_w[:1].expand(n_pad, 3), p_w]), preints, weight)


def _inertial_only(R_wb, p_w, preints, weight, sqrt_prior, n_iters,
                   fix_scale) -> InertialInitResult:
    n_kf = R_wb.shape[0]
    dev = R_wb.device
    # (K-1, 9, 9), a pad row's weight 0.
    Wsqrt = preint_info_sqrt(preints) * weight[:, None, None]

    # Initial gravity direction from the preintegrated velocities
    # (LocalMapping::InitializeIMU): dirG = -sum R_i dV_i.
    dirG = -_mv(R_wb[:-1], preints.dV).sum(0)
    dirG = dirG / torch.linalg.vector_norm(dirG).clamp_min(1e-9)
    gI = torch.zeros(3, device=dev).index_fill(
        0, torch.full((1,), 2, device=dev), -1.0)
    v_axis = torch.linalg.cross(gI, dirG, dim=-1)
    v_axis = v_axis / torch.linalg.vector_norm(v_axis).clamp_min(1e-9)
    ang = torch.arccos((gI * dirG).sum(-1, keepdim=True).clamp(-1.0, 1.0))
    Rwg0 = lie.so3_exp(v_axis * ang)

    # Initial velocities by finite differences.
    dt = preints.dT
    v0 = (p_w[1:] - p_w[:-1]) / dt[:, None].clamp_min(1e-6)
    v0 = torch.cat([v0, v0[-1:]], 0)
    # [theta_g (2), log_s (1), bg (3), ba (3), v (K*3)]
    x0 = torch.cat([torch.zeros(9, device=dev), v0.reshape(-1)])
    g_unit = imu.gravity_vec(R_wb)
    sqrt_g, sqrt_a = sqrt_prior[:1], sqrt_prior[1:]

    def unpack(x):
        th = torch.cat([x[:2], torch.zeros_like(x[:1])])
        Rwg = Rwg0 @ lie.so3_exp(th)
        # (1,), not 0-d: see lie.so3_exp on forward mode and 0-d tensors.
        s = torch.ones_like(x[2:3]) if fix_scale else torch.exp(x[2:3])
        return Rwg, s, x[3:6], x[6:9], x[9:].reshape(n_kf, 3)

    def residuals(x):
        Rwg, s, bg, ba, v = unpack(x)
        g_w = _mv(Rwg, g_unit)
        r = inertial_residual(
            R_wb[:-1], s * p_w[:-1], v[:-1], R_wb[1:], s * p_w[1:], v[1:],
            bg.expand(n_kf - 1, 3), ba.expand(n_kf - 1, 3), preints,
            g_w=g_w)
        r_white = _mv(Wsqrt, r)
        prior = torch.cat([sqrt_g * bg, sqrt_a * ba])
        return torch.cat([r_white.reshape(-1), prior])

    x = x0
    r0 = residuals(x0)
    cost = (r0 * r0).sum()
    lam = torch.full((), 1e-2, device=dev)
    for _ in range(n_iters):
        x, lam, cost = _lm_iteration(residuals, x, lam, cost)
    Rwg, s, bg, ba, v = unpack(x)
    return InertialInitResult(R_wg=Rwg, scale=s[0], bg=bg, ba=ba, vel=v,
                              cost=cost)


class PoseInertialResult(NamedTuple):
    R: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor
    # Marginal information on the solved frame's [pose, v, bg, ba] tangent:
    # the ConstraintPoseImu prior of the next frame's solve.
    H_marg: torch.Tensor     # (15, 15)


def prior_sqrt(prior_H: torch.Tensor) -> torch.Tensor:
    """L with L L^T the carried prior projected onto the PSD cone (the
    symmetrised matrix's eigenvalues clamped at 0) plus a trace-scaled
    damping, as the JAX package builds it. ``torch.linalg.eigh`` waits for
    the device (its convergence check is read on the host): the one
    synchronisation of the LastFrame variant."""
    H = 0.5 * (prior_H + prior_H.T)
    eigval, eigvec = torch.linalg.eigh(H)
    damp = 1e-6 * (1.0 + torch.trace(H) / 15.0)
    return eigvec * torch.sqrt(eigval.clamp_min(0.0) + damp)[None, :]


def _stereo_gates(obs_ur, rd, dtype):
    mono = (5.991, 5.991, 5.991, 5.991)[rd]
    if obs_ur is None:
        return mono
    stereo = (15.6, 9.8, 7.815, 7.815)[rd]
    return torch.where(obs_ur >= 0.0, stereo, mono).to(dtype)


def pose_inertial_optimization(
        R0, p0, v0, bg0, ba0,
        R_prev, p_prev, v_prev, bg_prev, ba_prev,
        preint,
        pts_w, obs_uv, inv_sigma2, valid,
        cam_params, R_cb, t_cb,
        walk_info,
        prior_H=None,
        obs_ur=None, bf=None,
        n_rounds: int = 4, n_iters: int = 10,
        with_prior: bool = False,
        prior_L=None) -> PoseInertialResult:
    """Tracking-time visual-inertial pose optimization
    (PoseInertialOptimizationLastKeyFrame / LastFrame), argument for
    argument the JAX package's.

    ``with_prior=False``: the previous state is fixed and the current
    frame's 15-dim tangent is solved. ``with_prior=True``: the previous frame
    is free under the marginalization prior ``prior_H`` (linearized at the
    previous state given), the joint 30-dim system is solved and the
    previous frame is Schur-marginalized out. ``prior_L``, when given, is
    :func:`prior_sqrt` of ``prior_H`` computed by the caller (so that its
    synchronisation falls where the caller chooses).

    ``obs_ur`` / ``bf``: stereo rows for the observations with ``obs_ur >=
    0`` (the u_r = u - bf / z residual) with the {15.6, 9.8, 7.815, 7.815}
    chi2 anneal; mono rows keep 5.991.

    ``H_marg`` is the marginal information on the solved frame, the next
    frame's prior. Nothing is read back to the host."""
    if with_prior and prior_L is None:
        prior_L = prior_sqrt(prior_H)
    if obs_ur is not None and not isinstance(bf, torch.Tensor):
        bf = torch.full((), float(bf), device=R0.device)
    return cuda_graph.call(
        "pose_inertial", _pose_inertial, R0, p0, v0, bg0, ba0, R_prev,
        p_prev, v_prev, bg_prev, ba_prev, preint, pts_w, obs_uv,
        inv_sigma2, valid, cam_params, R_cb, t_cb, walk_info,
        prior_L if with_prior else None, obs_ur,
        bf if obs_ur is not None else None, int(n_rounds), int(n_iters),
        bool(with_prior))


def _pose_inertial(R0, p0, v0, bg0, ba0, R_prev, p_prev, v_prev, bg_prev,
                   ba_prev, preint, pts_w, obs_uv, inv_sigma2, valid,
                   cam_params, R_cb, t_cb, walk_info, prior_L, obs_ur, bf,
                   n_rounds, n_iters, with_prior) -> PoseInertialResult:
    dev = R0.device
    Wsqrt = preint_info_sqrt(preint)
    use_stereo = obs_ur is not None
    n_x = 30 if with_prior else 15
    w_obs = torch.sqrt(inv_sigma2)
    sqrt_walk = torch.sqrt(walk_info)

    def split_state(xc, Rb, pb, vb, bgb, bab):
        dR, dp = lie.se3_exp(xc[:6])
        R = lie.project_rotation(dR @ Rb)
        return R, pb + dp, vb + xc[6:9], bgb + xc[9:12], bab + xc[12:15]

    def split(x):
        xc = x[15:] if with_prior else x
        return split_state(xc, R0, p0, v0, bg0, ba0)

    def split_prev(x):
        if with_prior:
            return split_state(x[:15], R_prev, p_prev, v_prev, bg_prev,
                               ba_prev)
        return R_prev, p_prev, v_prev, bg_prev, ba_prev

    def visual_residual(x):
        R, p, _, _, _ = split(x)
        # Tcw = Tcb Tbw.
        R_bw = R.T
        R_cw = R_cb @ R_bw
        t_cw = _mv(R_cb, -_mv(R_bw, p)) + t_cb
        pc = pts_w @ R_cw.T + t_cw
        uv = cam.project(cam.PINHOLE, cam_params, pc)
        r = (obs_uv - uv) * w_obs[:, None]
        if use_stereo:
            ur_pred = uv[:, 0] - bf / pc[:, 2].clamp_min(1e-6)
            r_ur = torch.where(obs_ur >= 0.0, (obs_ur - ur_pred) * w_obs,
                               0.0)
            r = torch.cat([r, r_ur[:, None]], -1)
        return r, pc[:, 2] > 0.05

    def inertial_rows(x):
        R, p, v, bg, ba = split(x)
        Rp, pp, vp, bgp, bap = split_prev(x)
        r9 = _mv(Wsqrt, inertial_residual(Rp, pp, vp, R, p, v, bg, ba,
                                          preint))
        r_rw = torch.cat([bg - bgp, ba - bap]) * sqrt_walk
        if not with_prior:
            return torch.cat([r9, r_rw])
        # EdgePriorPoseImu on the previous frame.
        return torch.cat([r9, r_rw, prior_L.T @ x[:15]])

    def full_residual(x, inlier_w):
        rv, depth_ok = visual_residual(x)
        rv = rv * (inlier_w * depth_ok)[:, None]
        return torch.cat([rv.reshape(-1), inertial_rows(x)])

    inlier = valid
    x = torch.zeros(n_x, device=dev)
    for rd in range(n_rounds):
        delta2 = _stereo_gates(obs_ur, rd, x.dtype)
        inl_w = inlier.to(torch.float32)

        def res_fn(x_, w=inl_w):
            return full_residual(x_, w)

        lam = torch.full((), 1e-3, device=dev)
        r = res_fn(x)
        cost = (r * r).sum()
        for _ in range(n_iters):
            x, lam, cost = _lm_iteration(res_fn, x, lam, cost)
        rv, depth_ok = visual_residual(x)
        chi2 = (rv * rv).sum(-1)
        inlier = (chi2 <= delta2) & valid & depth_ok

    # Marginal information for the next frame's ConstraintPoseImu.
    J_fin = jacfwd(lambda x_: full_residual(x_, inlier.to(torch.float32)))(x)
    H_fin = J_fin.T @ J_fin
    if with_prior:
        Hpp = H_fin[:15, :15] + 1e-6 * torch.eye(15, device=dev)
        Hpc = H_fin[:15, 15:]
        sol, _ = torch.linalg.solve_ex(Hpp, Hpc)
        H_marg = H_fin[15:, 15:] - Hpc.T @ sol
    else:
        H_marg = H_fin

    R, p, v, bg, ba = split(x)
    return PoseInertialResult(R=R, p=p, v=v, bg=bg, ba=ba, inlier=inlier,
                              n_inliers=inlier.sum(), H_marg=H_marg)
