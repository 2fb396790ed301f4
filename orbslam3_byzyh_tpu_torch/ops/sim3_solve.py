"""Closed-form Sim3 / SE3 alignment, its RANSAC, and the Sim3 refinement.

Port of ``orbslam3_byzyh_tpu/ops/sim3_solve.py`` (ORB-SLAM3's
``Sim3Solver`` and ``Optimizer::OptimizeSim3``): Horn's closed form on
3-point samples with every RANSAC hypothesis solved in one batch, and a
Gauss-Newton refinement of a Sim3 over both projection directions.

The RANSAC's (n_iters, 3) sample rows come from the caller
(:func:`draw_indices` draws them from an explicit generator): the JAX
function's ``jax.random.choice`` stream cannot be reproduced in torch, so
parity tests pass the JAX rows in. Rows are padded: ``mask`` marks the
matched pairs, and the RANSAC's median and refit see those alone. The
3 x 3 SVDs synchronise the stream on CUDA (``torch.linalg.svd``), two a
RANSAC (the batched hypotheses, the refit); nothing else reads the device.
:func:`optimize_sim3` has no host read and replays as a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_graph
from . import geometry, lie

N_ITERS = 128
SAMPLE_SIZE = 3


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor          # (3, 3), pb ~ s R pa + t
    t: torch.Tensor          # (3,)
    s: torch.Tensor          # ()
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int64
    ok: torch.Tensor         # () bool


class OptimizeSim3Result(NamedTuple):
    R: torch.Tensor            # refined rotation, x_q = s R x_c + t
    t: torch.Tensor
    s: torch.Tensor
    inliers_a: torch.Tensor    # (M,) forward-direction inlier mask
    n_inliers: torch.Tensor    # pairs inlying in every active direction


def draw_indices(generator: torch.Generator, mask: torch.Tensor,
                 n_iters: int = N_ITERS) -> torch.Tensor:
    """(n_iters, 3) rows drawn without replacement in proportion to
    ``mask`` + 1e-9 (the JAX function's weights), by weighted Gumbel top-k
    from ``generator``, on the device."""
    return geometry.sample_indices(generator, n_iters, SAMPLE_SIZE,
                                   mask.to(torch.float32) + 1e-9)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices by the triple product (no
    factorisation)."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :],
                                              dim=-1)).sum(-1)


def horn_sim3(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor,
              with_scale: bool = True):
    """Weighted Horn alignment, batched over leading dimensions: (R, t, s)
    with pb ~ s R pa + t. pa, pb (..., N, 3); w (..., N)."""
    wsum = w.sum(-1).clamp_min(1e-9)
    mu_a = (pa * w[..., None]).sum(-2) / wsum[..., None]
    mu_b = (pb * w[..., None]).sum(-2) / wsum[..., None]
    ac = pa - mu_a[..., None, :]
    bc = pb - mu_b[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", bc * w[..., None],
                       ac) / wsum[..., None, None]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(_det3(U) * _det3(Vt))
    one = torch.ones_like(d)
    D = torch.stack([one, one, d], -1)
    R = (U * D[..., None, :]) @ Vt
    var_a = ((ac * ac).sum(-1) * w).sum(-1) / wsum
    if with_scale:
        s = (S * D).sum(-1) / var_a.clamp_min(1e-12)
    else:
        s = torch.ones_like(var_a)
    t = mu_b - s[..., None] * (R @ mu_a[..., None])[..., 0]
    return R, t, s


def _residual(pa, pb, R, t, s):
    return torch.linalg.vector_norm(
        pb - (s[..., None, None] * (pa @ R.transpose(-1, -2))
              + t[..., None, :]), dim=-1)


def _median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of the masked entries (the mean of the two middle
    ones for an even count), with no host read."""
    xs = torch.sort(torch.where(mask, x, torch.inf)).values
    n = mask.sum()
    lo = ((n - 1).clamp_min(0) // 2).reshape(1)
    hi = (n // 2).clamp_max(x.shape[0] - 1).reshape(1)
    return 0.5 * (xs.gather(0, lo) + xs.gather(0, hi))[0]


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor without a host read (a 0-d tensor index
    is read back to the host by torch's indexing)."""
    return x.index_select(0, i.reshape(1))[0]


def sim3_ransac(idx: torch.Tensor, pa, pb, mask, th: float = 0.05,
                with_scale: bool = True,
                min_inliers: int = 20) -> Sim3RansacResult:
    """RANSAC Horn alignment of the matched points pa, pb (N, 3) (``mask``
    (N,) the real pairs) over the sample rows ``idx`` (I, 3). The inlier
    gate is 3D: ``th`` times the median distance of pb's points from their
    mean. The best hypothesis (the first with the most inliers) is refitted
    on its inliers."""
    m = mask.to(pa.dtype)
    mean_b = (pb * m[:, None]).sum(0) / m.sum().clamp_min(1.0)
    scene = _median(torch.linalg.vector_norm(pb - mean_b, dim=-1), mask)
    abs_th = th * scene.clamp_min(1e-6)

    ones = torch.ones(idx.shape, dtype=pa.dtype, device=pa.device)
    Rs, ts, ss = horn_sim3(pa[idx], pb[idx], ones, with_scale)  # (I, ...)
    counts = ((_residual(pa, pb, Rs, ts, ss) < abs_th) & mask).sum(-1)
    best = torch.argmax(counts)
    R0, t0, s0 = _pick(Rs, best), _pick(ts, best), _pick(ss, best)
    inl = (_residual(pa, pb, R0, t0, s0) < abs_th) & mask
    R, t, s = horn_sim3(pa, pb, inl.to(pa.dtype) + 1e-9 * m, with_scale)
    inl = (_residual(pa, pb, R, t, s) < abs_th) & mask
    n = inl.sum()
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inl, n_inliers=n,
                            ok=n >= min_inliers)


def _huber_w(chi2, th2: float):
    """IRLS weight of the Huber loss at squared error chi2, knee th2."""
    return torch.where(chi2 <= th2, torch.ones_like(chi2),
                       torch.sqrt(th2 / chi2.clamp_min(1e-12)))


def _proj(Rcw, tcw, p_world, uv, w, cam_params):
    """Residual (M, 2), camera point (M, 3) and chi2 (M,) of world points
    projected by the pose (Rcw, tcw)."""
    pc = p_world @ Rcw.T + tcw
    z = pc[:, 2].clamp_min(1e-6)
    u = cam_params[0] * pc[:, 0] / z + cam_params[2]
    v = cam_params[1] * pc[:, 1] / z + cam_params[3]
    r = torch.stack([u, v], -1) - uv
    return r, pc, (r * r).sum(-1) * w


def _proj_jac(Rcw, pc, cam_params):
    """d(pixel) / d(world point) (M, 2, 3) at camera points pc."""
    fx, fy = cam_params[0], cam_params[1]
    inv_z = 1.0 / pc[:, 2].clamp_min(1e-6)
    zero = torch.zeros_like(inv_z)
    Jpi = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * pc[:, 0] * inv_z ** 2], -1),
        torch.stack([zero, fy * inv_z, -fy * pc[:, 1] * inv_z ** 2], -1),
    ], 1)
    return Jpi @ Rcw


def _optimize_sim3(R0, t0, s0, p_c, uv_q, invs2_a, valid_a, R_qw, t_qw,
                   p_q, uv_c, invs2_b, valid_b, R_cw, t_cw, cam_params,
                   fix_scale: bool, th2: float, n_iters: int):
    dev = p_c.device
    eye3 = torch.eye(3, dtype=p_c.dtype, device=dev)
    va = valid_a.to(p_c.dtype)
    vb = valid_b.to(p_c.dtype)
    # The tangent's scale coordinate is held with a fixed scale.
    mask7 = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(
        p_c.dtype)
    R, t, s = R0, t0, s0
    act = torch.ones(p_c.shape[0], dtype=torch.bool, device=dev)
    for i in range(n_iters):
        # Direction A: y = U(p_c), the residual in the query camera.
        y = s * (p_c @ R.T) + t
        rA, pcA, chi2A = _proj(R_qw, t_qw, y, uv_q, invs2_a, cam_params)
        JyA = torch.cat([-lie.skew(y), eye3.expand(y.shape[0], 3, 3),
                         y[:, :, None]], -1)                       # (M, 3, 7)
        JA = _proj_jac(R_qw, pcA, cam_params) @ JyA                # (M, 2, 7)
        wA = _huber_w(chi2A, th2) * invs2_a * va * act
        # Direction B: z = U^-1(p_q), the residual in the candidate camera.
        z3 = (1.0 / s) * ((p_q - t) @ R)
        rB, pcB, chi2B = _proj(R_cw, t_cw, z3, uv_c, invs2_b, cam_params)
        JzB = torch.cat([lie.skew(p_q), -eye3.expand(p_q.shape[0], 3, 3),
                         -p_q[:, :, None]], -1)
        JzB = (1.0 / s) * (R.T @ JzB)
        JB = _proj_jac(R_cw, pcB, cam_params) @ JzB
        wB = _huber_w(chi2B, th2) * invs2_b * vb * act

        H = (torch.einsum("mac,m,mab->cb", JA, wA, JA)
             + torch.einsum("mac,m,mab->cb", JB, wB, JB))
        b = (torch.einsum("mac,m,ma->c", JA, wA, rA)
             + torch.einsum("mac,m,ma->c", JB, wB, rB))
        if fix_scale:
            H = H * mask7[:, None] * mask7[None, :] + torch.diag(1.0 - mask7)
            b = b * mask7
        H = H + 1e-6 * torch.eye(7, dtype=H.dtype, device=dev)
        delta = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        xi = torch.cat([delta[3:6], delta[:3], delta[6:7]])      # Sophus
        Rd, td, sd = lie.sim3_exp(xi)
        R, t, s = lie.sim3_mul(Rd, td, sd, R, t, s)
        if i == n_iters // 2 - 1:
            # The midpoint round drops a pair whose chi2 exceeds th2 in an
            # active direction (the reference's removeEdge pass).
            good = (((chi2A < th2) | ~valid_a) & ((chi2B < th2) | ~valid_b))
            act = act & good
    y = s * (p_c @ R.T) + t
    _, _, chi2A = _proj(R_qw, t_qw, y, uv_q, invs2_a, cam_params)
    z3 = (1.0 / s) * ((p_q - t) @ R)
    _, _, chi2B = _proj(R_cw, t_cw, z3, uv_c, invs2_b, cam_params)
    inl_a = valid_a & (chi2A < th2)
    inl = inl_a & torch.where(valid_b, chi2B < th2, True)
    return R, t, s, inl_a, inl.sum()


def optimize_sim3(R0, t0, s0, p_c, uv_q, invs2_a, valid_a, R_qw, t_qw,
                  p_q, uv_c, invs2_b, valid_b, R_cw, t_cw, cam_params,
                  fix_scale: bool = False, th2: float = 10.0,
                  n_iters: int = 10) -> OptimizeSim3Result:
    """Gauss-Newton refinement of the Sim3 ``U = (R, t, s)`` that maps
    candidate-side world points into the query-side world (x_q = s R x_c +
    t), over two directions of M rows each: A, candidate landmarks ``p_c``
    through U into the query keyframe (R_qw, t_qw) against its keypoints
    ``uv_q``; B, query landmarks ``p_q`` through U^-1 into the candidate
    keyframe against ``uv_c``. ``invs2_*`` weight the rows, ``valid_*``
    mask them. Huber weights (knee ``th2``); at the midpoint iteration a
    pair over ``th2`` in an active direction is dropped. Returns the
    refined transform and the pairs inlying in every active direction. On
    CUDA the iterations replay as one graph (no host read)."""
    R, t, s, inl_a, n = cuda_graph.call(
        "optimize_sim3", _optimize_sim3, R0, t0,
        torch.as_tensor(s0, dtype=p_c.dtype, device=p_c.device), p_c, uv_q,
        invs2_a, valid_a, R_qw, t_qw, p_q, uv_c, invs2_b, valid_b, R_cw,
        t_cw, cam_params, fix_scale, th2, n_iters)
    return OptimizeSim3Result(R=R, t=t, s=s, inliers_a=inl_a, n_inliers=n)
