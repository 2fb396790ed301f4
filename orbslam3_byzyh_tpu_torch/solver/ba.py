"""Bundle adjustment with Schur-complement landmark elimination.

Port of ``orbslam3_byzyh_tpu/solver/ba.py`` (pinhole). Observations are
landmark-major:
  * ``obs_kf    (L, O) int32``  keyframe index per observation slot (-1 empty)
  * ``obs_uv    (L, O, 2)``     measured pixels
  * ``obs_w     (L, O)``        information (1 / sigma^2 of the level)
  * ``obs_valid (L, O) bool``
  * ``obs_ur    (L, O)``        optional: right-image u (-1 = a mono row);
    a stereo row adds the residual u_r - (u - bf / z)
    (EdgeStereoSE3ProjectXYZ) and gates at 7.815.

Each landmark row is eliminated by its closed-form 3x3 inverse; its Schur
contribution is summed into the dense reduced camera system (K, K, 6, 6) by
one of two assemblies with the same results:

  * ``schur_pieces``: a one-hot (L, O, K) keyframe indicator and matmuls, as
    the JAX package assembles it for the TPU's matrix unit. Its cross term
    is an (L, K, 6, 3) x (L, K, 6, 3) product: at K = 1024 and L = 65536
    about 1.5e13 flop and 20 GB. The windowed BA (K = 32) uses it.
  * ``schur_pieces_scatter``: ``index_add_`` of the observations' blocks
    into their keyframes and of each landmark's observation-pair blocks
    into their keyframe pair: O(L O^2) work, whatever K. The full-map BA
    uses it.

The 6K x 6K solve is ``torch.linalg.solve_ex``, which reports failure in a
tensor instead of reading it back to the host. The LM accept/reject
decision is a ``torch.where`` on the device.

Robust kernel: Huber sqrt(5.991) (sqrt(7.815) on a stereo row); outliers
are re-classified between stages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera as cam
from ..ops import lie
from . import lm

def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det, the determinant
    guarded at 1e-20)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(det.abs() < 1e-20,
                                torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1)], -2)
    return adj * inv_det[..., None, None]


class BAProblem(NamedTuple):
    R: torch.Tensor          # (K, 3, 3) Rcw per keyframe
    t: torch.Tensor          # (K, 3)
    points: torch.Tensor     # (L, 3) world landmarks
    obs_kf: torch.Tensor     # (L, O) int32, -1 = empty slot
    obs_uv: torch.Tensor     # (L, O, 2)
    obs_w: torch.Tensor      # (L, O) information weights
    obs_valid: torch.Tensor  # (L, O) bool
    fixed: torch.Tensor      # (K,) bool: poses held constant
    lm_valid: torch.Tensor   # (L,) bool
    cam_params: torch.Tensor  # (4,) fx, fy, cx, cy
    # Stereo observations: right-image u per observation, -1 = mono.
    obs_ur: torch.Tensor = None   # (L, O) or None
    bf: torch.Tensor = None       # baseline x fx (required with obs_ur)


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (L, O) post-gating mask
    cost: torch.Tensor


def _residuals(p: BAProblem, R, t, points, model_id):
    """Per-observation residuals (L, O, R), pose Jacobians (L, O, R, 6),
    point Jacobians (L, O, R, 3) and the depth gate (L, O); R is 2, or 3
    with stereo rows (the third row zero on a mono observation)."""
    kf = p.obs_kf.clamp_min(0).long()
    Rk = R[kf]                                   # (L, O, 3, 3)
    tk = t[kf]                                   # (L, O, 3)
    pw = points[:, None, :].expand(tk.shape)
    pc = (Rk @ pw[..., None])[..., 0] + tk
    uv = cam.project(model_id, p.cam_params, pc)
    r = p.obs_uv - uv
    Jproj = cam.project_jac(model_id, p.cam_params, pc)    # (L, O, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    dpc_dpose = torch.cat([eye, -lie.skew(pc)], -1)        # (L, O, 3, 6)
    Jp = -(Jproj @ dpc_dpose)
    Jl = -(Jproj @ Rk)
    depth_ok = pc[..., 2] > 0.05
    if p.obs_ur is None:
        return r, Jp, Jl, depth_ok
    # The third row, u_r = u - bf / z, on the stereo rows only.
    iz = 1.0 / pc[..., 2].clamp_min(1e-6)
    has_ur = p.obs_ur >= 0.0
    r3 = torch.where(has_ur, p.obs_ur - (uv[..., 0] - p.bf * iz), 0.0)
    e = p.bf * iz * iz                                   # d(-bf / z) / dz
    zero = torch.zeros_like(e)
    extra_pose = torch.stack([zero, zero, e, e * pc[..., 1], -e * pc[..., 0],
                              zero], -1)
    Jp3 = torch.where(has_ur[..., None], Jp[..., 0, :] - extra_pose, 0.0)
    Jl3 = torch.where(has_ur[..., None],
                      Jl[..., 0, :] - e[..., None] * Rk[..., 2, :], 0.0)
    return (torch.cat([r, r3[..., None]], -1),
            torch.cat([Jp, Jp3[..., None, :]], -2),
            torch.cat([Jl, Jl3[..., None, :]], -2), depth_ok)


def _build_system(p: BAProblem, R, t, points, inlier, model_id, robust,
                  delta2) -> dict:
    """The normal-equation blocks of every landmark row and the cost. ``bl``
    and ``bp_o`` carry the Gauss-Newton sign (H dx = b, b = -J^T W r)."""
    r, Jp, Jl, depth_ok = _residuals(p, R, t, points, model_id)
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
    Hll = torch.einsum("lori,lorj->lij", Jlw, Jl)            # (L, 3, 3)
    bl = -torch.einsum("lori,lor->li", Jlw, r)               # (L, 3)
    Wlo = torch.einsum("lori,lorj->loij", Jpw, Jl)           # (L, O, 6, 3)
    Hpp_o = torch.einsum("lori,lorj->loij", Jpw, Jp)         # (L, O, 6, 6)
    bp_o = -torch.einsum("lori,lor->loi", Jpw, r)            # (L, O, 6)
    return dict(Hll=Hll, bl=bl, W=Wlo, Hpp_o=Hpp_o, bp_o=bp_o,
                cost=cost, chi2=chi2, mask=mask)


def _landmark_inverses(Hll, lam):
    """The damped landmark blocks' inverses Hll_inv (L, 3, 3), identity
    where a landmark has no signal, and has_obs (L,)."""
    diag_l = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_d = Hll + torch.diag_embed(lam * diag_l.clamp_min(1e-9))
    has_obs = diag_l.sum(-1) > 1e-12
    eye = torch.eye(3, dtype=Hll.dtype, device=Hll.device).expand(Hll.shape)
    Hll_d = torch.where(has_obs[:, None, None], Hll_d, eye)
    return _inv3x3(Hll_d), has_obs


def schur_pieces(obs_kf, sys: dict, lam, n_kf: int) -> dict:
    """The Schur contributions summed over landmarks: Hpp (K, 6, 6), bp
    (K, 6), cross (K, K, 6, 6), corr (K, 6); plus the per-landmark damped
    inverses Hll_inv (L, 3, 3) and has_obs (L,) for back-substitution.
    Segment sums over the keyframe index are matmuls with the one-hot
    indicator E (L, O, K)."""
    kf = obs_kf.clamp_min(0)
    Hll = sys["Hll"]
    Hll_inv, has_obs = _landmark_inverses(Hll, lam)

    E = (kf[..., None] == torch.arange(n_kf, device=kf.device)).to(
        Hll.dtype)                                           # (L, O, K)
    Hpp = torch.einsum("lok,loij->kij", E, sys["Hpp_o"])
    bp = torch.einsum("lok,loi->ki", E, sys["bp_o"])
    W = sys["W"]
    WHinv = torch.einsum("loij,ljk->loik", W, Hll_inv)       # (L, O, 6, 3)
    U = torch.einsum("lok,loij->lkij", E, WHinv)             # (L, K, 6, 3)
    V = torch.einsum("lok,loij->lkij", E, W)
    cross = torch.einsum("lkim,lqjm->kqij", U, V)            # (K, K, 6, 6)
    corr_o = torch.einsum("loik,lk->loi", WHinv, sys["bl"])
    corr = torch.einsum("lok,loi->ki", E, corr_o)
    return dict(Hpp=Hpp, bp=bp, cross=cross, corr=corr, Hll_inv=Hll_inv,
                has_obs=has_obs)


# Spare rows that take the scatter form's zero blocks, spread so that their
# atomic adds do not queue on a few addresses.
_SPARE_ROWS = 4096


def _segment_sum(x: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Sum the rows of ``x`` (M, ...) into ``n`` rows at ``rows`` (M,),
    where ``rows`` in [n, n + _SPARE_ROWS) is a spare row that is dropped."""
    out = x.new_zeros((n + _SPARE_ROWS,) + x.shape[1:])
    return out.index_add_(0, rows, x)[:n]


def schur_pieces_scatter(obs_kf, sys: dict, lam, n_kf: int) -> dict:
    """``schur_pieces`` by scatter-add: the same Hpp, bp, cross, corr,
    Hll_inv and has_obs. Hpp, bp and corr add each observation's block into
    its keyframe; cross adds, for every landmark and pair of its
    observations (o1, o2), WHinv[o1] W[o2]^T into the cell (kf[o1],
    kf[o2]): L O^2 blocks of 6x6 (1.36 GB at L = 65536, O = 12), however
    many keyframes. An observation whose Hpp_o diagonal is zero carries no
    weight and adds nothing; it and every pair it is part of go to spare
    rows spread over ``_SPARE_ROWS`` (the one-hot form sends them to
    keyframe 0, and millions of atomic adds of zero blocks would queue on
    one cell)."""
    L, O = obs_kf.shape
    dev = obs_kf.device
    Hll_inv, has_obs = _landmark_inverses(sys["Hll"], lam)
    W = sys["W"]
    WHinv = torch.einsum("loij,ljk->loik", W, Hll_inv)       # (L, O, 6, 3)
    corr_o = torch.einsum("loik,lk->loi", WHinv, sys["bl"])

    diag = torch.diagonal(sys["Hpp_o"], dim1=-2, dim2=-1).sum(-1)
    live = (obs_kf >= 0) & (diag != 0)                        # (L, O)
    kf = obs_kf.long()
    spare = torch.arange(L * O, device=dev) % _SPARE_ROWS
    rows = torch.where(live.reshape(-1), kf.reshape(-1), n_kf + spare)
    Hpp = _segment_sum(sys["Hpp_o"].reshape(L * O, 6, 6), rows, n_kf)
    bp = _segment_sum(sys["bp_o"].reshape(L * O, 6), rows, n_kf)
    corr = _segment_sum(corr_o.reshape(L * O, 6), rows, n_kf)

    pairs = torch.einsum("loim,lpjm->lopij", WHinv, W).reshape(-1, 6, 6)
    pair_live = (live[:, :, None] & live[:, None, :]).reshape(-1)
    cells = (kf[:, :, None] * n_kf + kf[:, None, :]).reshape(-1)
    spare = torch.arange(L * O * O, device=dev) % _SPARE_ROWS
    cells = torch.where(pair_live, cells, n_kf * n_kf + spare)
    cross = _segment_sum(pairs, cells, n_kf * n_kf).reshape(n_kf, n_kf, 6, 6)
    return dict(Hpp=Hpp, bp=bp, cross=cross, corr=corr, Hll_inv=Hll_inv,
                has_obs=has_obs)


def schur_solve(Hpp, bp, cross, corr, lam, fixed, n_kf: int):
    """Assemble and solve the reduced camera system -> dp (K, 6). Fixed
    poses get identity rows and columns and a zero right-hand side."""
    dtype, dev = Hpp.dtype, Hpp.device
    k = torch.arange(n_kf, device=dev)
    diag_p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    S = -cross
    S[k, k] += Hpp
    S[k, k] += torch.diag_embed(lam * diag_p.clamp_min(1e-9))
    free = (~fixed).to(dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[k, k] += eye6 * fixed.to(dtype)[:, None, None]
    rhs = (bp - corr) * free[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(n_kf * 6, n_kf * 6)
    dp, _ = torch.linalg.solve_ex(Sd, rhs.reshape(-1, 1))
    return dp.reshape(n_kf, 6)


def back_substitute(obs_kf, sys: dict, Hll_inv, has_obs, dp):
    """Landmark updates: dl = Hll_inv (bl - sum_o W^T dp[kf])."""
    kf = obs_kf.clamp_min(0).long()
    Wt_dp = torch.einsum("loij,loi->lj", sys["W"], dp[kf])
    dl = torch.einsum("lij,lj->li", Hll_inv, sys["bl"] - Wt_dp)
    return torch.where(has_obs[:, None], dl, torch.zeros_like(dl))


def _schur_reduce(p: BAProblem, sys: dict, lam, n_kf: int, assembly):
    """One Schur step: pieces, solve, back-substitute -> (dp, dl)."""
    pieces = assembly(p.obs_kf, sys, lam, n_kf)
    dp = schur_solve(pieces["Hpp"], pieces["bp"], pieces["cross"],
                     pieces["corr"], lam, p.fixed, n_kf)
    dl = back_substitute(p.obs_kf, sys, pieces["Hll_inv"],
                         pieces["has_obs"], dp)
    return dp, dl


def _retract(R, t, points, dp, dl, fixed):
    """Left SE(3) update of the free poses, one Newton-Schulz
    re-orthonormalisation R (3I - R^T R) / 2, and the point update."""
    dR, dt = lie.se3_exp(dp)
    Rn = dR @ R
    RtR = Rn.transpose(-1, -2) @ Rn
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(RtR.shape)
    Rn = 0.5 * (Rn @ (3.0 * eye - RtR))
    tn = (dR @ t[..., None])[..., 0] + dt
    keep = fixed[:, None]
    return (torch.where(keep[..., None], R, Rn), torch.where(keep, t, tn),
            points + dl)


# The system blocks an accepted step carries into the next iteration.
_CARRIED = ("Hll", "bl", "W", "Hpp_o", "bp_o")


def sum_on(xs, dev):
    """The sum of the shards' tensors, on ``dev`` (in shard order)."""
    out = xs[0].to(dev)
    for x in xs[1:]:
        out = out + x.to(dev)
    return out


def bundle_adjust(p, model_id: int = cam.PINHOLE, stages: tuple = (5, 10),
                  assembly=schur_pieces) -> BAResult:
    """Schur-complement LM bundle adjustment. ``stages``: LM iterations per
    stage; between stages the observations are re-classified (chi2 <= 5.991,
    7.815 on a stereo row, and depth > 0.05), and the last stage drops the
    robust kernel. ``assembly``: ``schur_pieces`` or
    ``schur_pieces_scatter``. Every decision stays on the device.

    ``p``: one ``BAProblem``, or a sequence of them that split the landmark
    axis (``parallel.dist_ba.shard_problem``: each on its shard's device,
    the poses, fixed mask and camera on every one). Each shard then builds
    its landmarks' blocks and Schur pieces; the pieces and costs are summed
    on the first shard's device, where the one solve and the accept
    decision run, and ``dp`` and the decision go back to every shard. The
    result lies on the first shard's device, the points and inlier masks
    in the original landmark order."""
    shards = (p,) if isinstance(p, BAProblem) else tuple(p)
    dev0 = shards[0].R.device
    n_kf = shards[0].R.shape[0]
    fixed0 = shards[0].fixed.to(dev0)
    delta2 = [lm.CHI2_MONO if s.obs_ur is None
              else torch.where(s.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)
              for s in shards]
    inlier = [torch.ones_like(s.obs_valid) for s in shards]
    state = [(s.R, s.t, s.points) for s in shards]

    def build(i, st, robust):
        return _build_system(shards[i], *st, inlier[i], model_id, robust,
                             delta2[i])

    for si, n_iters in enumerate(stages):
        robust = si < len(stages) - 1
        sys_cur = [build(i, st, robust) for i, st in enumerate(state)]
        cost = sum_on([s_["cost"] for s_ in sys_cur], dev0)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev0)
        for _ in range(n_iters):
            pieces = [assembly(s.obs_kf, sys_cur[i], lam.to(s.R.device),
                               n_kf) for i, s in enumerate(shards)]
            dp = schur_solve(*(sum_on([pc[k] for pc in pieces], dev0)
                               for k in ("Hpp", "bp", "cross", "corr")),
                             lam, fixed0, n_kf)
            cand, sys_cand = [], []
            for i, s in enumerate(shards):
                dp_i = dp.to(s.R.device)
                dl = back_substitute(s.obs_kf, sys_cur[i],
                                     pieces[i]["Hll_inv"],
                                     pieces[i]["has_obs"], dp_i)
                cand.append(_retract(*state[i], dp_i, dl, s.fixed))
                sys_cand.append(build(i, cand[i], robust))
            cost_cand = sum_on([s_["cost"] for s_ in sys_cand], dev0)
            accept = cost_cand < cost
            for i, s in enumerate(shards):
                acc = accept.to(s.R.device)
                state[i] = tuple(torch.where(acc, b, a)
                                 for a, b in zip(state[i], cand[i]))
                sys_cur[i] = {k: torch.where(acc, sys_cand[i][k],
                                             sys_cur[i][k])
                              for k in _CARRIED}
            lam = torch.where(accept, lam * 0.5, lam * 10.0)
            cost = torch.where(accept, cost_cand, cost)
        for i, s in enumerate(shards):
            r, _, _, depth_ok = _residuals(s, *state[i], model_id)
            chi2 = (r * r).sum(-1) * s.obs_w
            inlier[i] = (chi2 <= delta2[i]) & depth_ok

    final = [build(i, st, False) for i, st in enumerate(state)]
    if len(shards) == 1:
        (R, t, points), = state
        return BAResult(R=R, t=t, points=points,
                        obs_inlier=inlier[0] & final[0]["mask"],
                        cost=final[0]["cost"])
    return BAResult(
        R=state[0][0].to(dev0), t=state[0][1].to(dev0),
        points=torch.cat([st[2].to(dev0) for st in state]),
        obs_inlier=torch.cat([(inlier[i] & f["mask"]).to(dev0)
                              for i, f in enumerate(final)]),
        cost=sum_on([f["cost"] for f in final], dev0))
