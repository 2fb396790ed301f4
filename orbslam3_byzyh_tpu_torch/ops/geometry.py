"""Multi-view geometry: DLT triangulation and the two-view initialisation.

Port of ``orbslam3_byzyh_tpu/ops/geometry.py`` (GeometricTools and
TwoViewReconstruction). Every hypothesis of both models is scored in one
batch: one SVD over the (I, 16, 9) homography systems, one over the (I, 8, 9)
fundamental systems, and one ``check_rt`` triangulation over all 12 pose
candidates.

The RANSAC takes its (I, 8) sample indices from the caller in place of a
``jax.random`` key: :func:`sample_indices` draws them on the device from an
explicit ``torch.Generator`` (the JAX package's stream cannot be reproduced
in torch, so parity tests pass the JAX package's indices in).

``torch.linalg.svd`` synchronises with the host on CUDA (it has no ``_ex``
form); inverses are ``torch.linalg.inv_ex`` and 3x3 determinants are closed
form, so nothing else here reads back to the host. Constants (the W of the
essential decomposition, the candidates' sign patterns) are built on the
device from ``arange`` rather than copied from host lists.

Behaviour constants: 200 iterations of 8-point samples, sigma 1, the H score
threshold 5.991 in both directions, the F thresholds 3.841 / 5.991, RH =
SH / (SH + SF) > 0.5 between two families that both reconstruct; a pose
needs at least 50 triangulated points (and 90 % of its inliers), a runner-up
below 75 % of it and a parallax of at least 1 degree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_ITERS = 200
SAMPLE_SIZE = 8


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor,
                    x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. P1, P2: (..., 3, 4) projection matrices; x1, x2:
    (..., 2) coordinates consistent with them. Returns (..., 3): the right
    singular vector of the smallest singular value, dehomogenised.

    ``torch.linalg.svd`` synchronises with the host on CUDA (it has no
    ``_ex`` form); the keyframe bundle calls it once per neighbour."""
    rows = torch.stack(torch.broadcast_tensors(
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ), dim=-2)                                     # (..., 4, 4)
    _, _, vh = torch.linalg.svd(rows)
    Xh = vh[..., 3, :]
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], world-to-camera (Tcw)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without a host read."""
    return x.index_select(0, i.reshape(1))[0]


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` with values of magnitude below ``eps`` replaced by ``eps``."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of (..., m,
    9), as (..., 3, 3). Below 9 rows the full V is needed."""
    _, _, vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    return vh[..., 8, :].reshape(A.shape[:-2] + (3, 3))


# ---------------------------------------------------------------------------
# Normalisation (TwoViewReconstruction::Normalize)
# ---------------------------------------------------------------------------

def normalize_points(x: torch.Tensor, mask: torch.Tensor):
    """Mean-centre and scale to unit mean absolute deviation per axis over
    the rows weighted by ``mask`` (N,). Returns (xn, T) with xn = T x in the
    homogeneous sense."""
    wsum = mask.sum().clamp_min(1.0)
    mean = (x * mask[:, None]).sum(0) / wsum
    dev = ((x - mean).abs() * mask[:, None]).sum(0) / wsum
    s = 1.0 / torch.where(dev < 1e-9, torch.full_like(dev, 1e-9), dev)
    xn = (x - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return xn, T


# ---------------------------------------------------------------------------
# Minimal solvers, batched over leading dimensions
# ---------------------------------------------------------------------------

def homography_dlt(x1: torch.Tensor, x2: torch.Tensor,
                   w: torch.Tensor = None) -> torch.Tensor:
    """H with x2 ~ H x1 from the rows of x1, x2 (..., S, 2) (ComputeH21).
    Optional per-pair weights w (..., S) zero out rows (the inlier refit).
    Returns (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zeros, ones = torch.zeros_like(u1), torch.ones_like(u1)
    rows_a = torch.stack([zeros, zeros, zeros, -u1, -v1, -ones,
                          v2 * u1, v2 * v1, v2], -1)
    rows_b = torch.stack([u1, v1, ones, zeros, zeros, zeros,
                          -u2 * u1, -u2 * v1, -u2], -1)
    if w is not None:
        rows_a = rows_a * w[..., None]
        rows_b = rows_b * w[..., None]
    return _null_vector(torch.cat([rows_a, rows_b], -2))     # (..., 2S, 9)


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor,
                    w: torch.Tensor = None) -> torch.Tensor:
    """F with x2^T F x1 = 0 from the rows of x1, x2 (..., S, 2), projected
    to rank 2 (ComputeF21). Optional per-pair weights w (..., S). Returns
    (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], -1)
    if w is not None:
        A = A * w[..., None]
    U, S, Vh = torch.linalg.svd(_null_vector(A))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vh


# ---------------------------------------------------------------------------
# Hypothesis scoring (CheckHomography, CheckFundamental), batched over models
# ---------------------------------------------------------------------------

def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def score_homography(H: torch.Tensor, x1, x2, mask, sigma: float = 1.0):
    """Symmetric transfer score of (..., 3, 3) homographies over the pairs
    (N, 2). Returns (score (...), inliers (..., N))."""
    th = 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    Hinv, _ = torch.linalg.inv_ex(H)

    def transfer(Hm, a, b):
        p = _homogeneous(a) @ Hm.transpose(-1, -2)          # (..., N, 3)
        w = _guard(p[..., 2], 1e-9)
        return ((b - p[..., :2] / w[..., None]) ** 2).sum(-1)

    chi1 = transfer(H, x1, x2) * inv_s2
    chi2 = transfer(Hinv, x2, x1) * inv_s2
    ok = (chi1 <= th) & (chi2 <= th) & mask
    score = torch.where(ok, (th - chi1) + (th - chi2),
                        torch.zeros_like(chi1)).sum(-1)
    return score, ok


def score_fundamental(F: torch.Tensor, x1, x2, mask, sigma: float = 1.0):
    """Symmetric epipolar-distance score of (..., 3, 3) fundamental matrices
    over the pairs (N, 2). Returns (score (...), inliers (..., N))."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    x1h, x2h = _homogeneous(x1), _homogeneous(x2)
    l2 = x1h @ F.transpose(-1, -2)        # epipolar lines in image 2
    l1 = x2h @ F                          # epipolar lines in image 1
    d2 = ((l2 * x2h).sum(-1) ** 2) / (l2[..., 0] ** 2
                                      + l2[..., 1] ** 2).clamp_min(1e-12)
    d1 = ((l1 * x1h).sum(-1) ** 2) / (l1[..., 0] ** 2
                                      + l1[..., 1] ** 2).clamp_min(1e-12)
    chi1 = d1 * inv_s2
    chi2 = d2 * inv_s2
    ok = (chi1 <= th) & (chi2 <= th) & mask
    zero = torch.zeros_like(chi1)
    score = (torch.where(chi1 <= th, th_score - chi1, zero)
             + torch.where(chi2 <= th, th_score - chi2, zero))
    score = torch.where(mask, score, zero).sum(-1)
    return score, ok


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

def sample_indices(generator: torch.Generator, n_iters: int,
                   sample_size: int, weights: torch.Tensor) -> torch.Tensor:
    """(n_iters, sample_size) int64 row indices, each row drawn without
    replacement in proportion to ``weights`` (N,) (Gumbel top-k: the
    ``sample_size`` largest of log w + Gumbel noise), on ``weights``'
    device from ``generator`` (a generator of that device), with no host
    read."""
    u = torch.rand((n_iters, weights.shape[0]), generator=generator,
                   device=weights.device)
    keys = torch.log(weights) - torch.log(-torch.log(u))
    return torch.topk(keys, sample_size, dim=-1).indices


def ransac_two_models(idx: torch.Tensor, x1, x2, mask, sigma: float = 1.0):
    """Score the H and F hypotheses of every sample row of ``idx`` (I, 8) in
    one batch each and keep the best of each model, refitted on all its
    inliers where the refit scores better (a deviation of the JAX package
    from the reference, kept here). x1, x2: (N, 2) undistorted pixels; mask:
    (N,) valid pairs. "SH"/"SF" stay the minimal samples' scores: the model
    choice must not see a refit F on a planar scene. Returns a dict as the
    JAX package's."""
    m = mask.to(torch.float32)
    x1n, T1 = normalize_points(x1, m)
    x2n, T2 = normalize_points(x2, m)
    T2inv, _ = torch.linalg.inv_ex(T2)

    def denormalize_h(Hn):
        H = T2inv @ Hn @ T1
        return H / _guard(H[..., 2, 2], 1e-9)[..., None, None]

    def denormalize_f(Fn):
        return T2.T @ Fn @ T1

    Hs = denormalize_h(homography_dlt(x1n[idx], x2n[idx]))     # (I, 3, 3)
    Fs = denormalize_f(fundamental_8pt(x1n[idx], x2n[idx]))
    h_scores, h_inl = score_homography(Hs, x1, x2, mask, sigma)
    f_scores, f_inl = score_fundamental(Fs, x1, x2, mask, sigma)
    bi_h = torch.argmax(h_scores)
    bi_f = torch.argmax(f_scores)

    H_r = denormalize_h(homography_dlt(x1n, x2n,
                                       _pick(h_inl, bi_h).to(torch.float32)))
    sh_r, h_inl_r = score_homography(H_r, x1, x2, mask, sigma)
    F_r = denormalize_f(fundamental_8pt(x1n, x2n,
                                        _pick(f_inl, bi_f).to(torch.float32)))
    sf_r, f_inl_r = score_fundamental(F_r, x1, x2, mask, sigma)

    sh, sf = _pick(h_scores, bi_h), _pick(f_scores, bi_f)
    h_better, f_better = sh_r > sh, sf_r > sf
    return {
        "H": torch.where(h_better, H_r, _pick(Hs, bi_h)), "SH": sh,
        "h_inliers": torch.where(h_better, h_inl_r, _pick(h_inl, bi_h)),
        "F": torch.where(f_better, F_r, _pick(Fs, bi_f)), "SF": sf,
        "f_inliers": torch.where(f_better, f_inl_r, _pick(f_inl, bi_f)),
    }


# ---------------------------------------------------------------------------
# Pose recovery (ReconstructF, ReconstructH, CheckRT)
# ---------------------------------------------------------------------------

def check_rt(R, t, x1, x2, K, mask, sigma2: float = 1.0,
             th_parallax_cos: float = 0.99998):
    """Triangulate the pairs under each candidate (R (B, 3, 3), t (B, 3))
    and count the good points; ``mask`` (B, N) per candidate. A point
    counts with a finite position, positive depth in both views unless it
    lacks parallax, and reprojection chi2 < 4 sigma2 in both; it is good
    when it also has parallax (cos < ``th_parallax_cos``). Returns (n_good
    (B,), parallax (B,): the 51st largest angle in degrees among the
    counted points, points (B, N, 3) in the first camera's frame, good (B,
    N))."""
    B = R.shape[0]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = projection_matrix(K, eye, torch.zeros_like(t[0]))
    P2 = projection_matrix(K, R, t)                            # (B, 3, 4)
    X = triangulate_dlt(P1, P2[:, None], x1, x2)               # (B, N, 3)
    finite = torch.isfinite(X).all(-1)

    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]          # (B, 3)
    n2 = X - C2[:, None]
    cos_par = (X * n2).sum(-1) / (torch.linalg.vector_norm(X, dim=-1)
                                  * torch.linalg.vector_norm(n2, dim=-1)
                                  ).clamp_min(1e-12)
    z1 = X[..., 2]
    z2 = (X @ R.transpose(-1, -2) + t[:, None])[..., 2]

    def reproj_err(P, x_obs):
        p = _homogeneous(X) @ P.transpose(-1, -2)
        w = _guard(p[..., 2], 1e-9)
        return ((x_obs - p[..., :2] / w[..., None]) ** 2).sum(-1)

    e1 = reproj_err(P1, x1)
    e2 = reproj_err(P2, x2)
    has_parallax = cos_par < th_parallax_cos
    # Negative depth rejects only points with parallax (CheckRT).
    depth_ok = (((z1 > 0) | ~has_parallax) & ((z2 > 0) | ~has_parallax))
    counted = (mask & finite & depth_ok & (e1 < 4.0 * sigma2)
               & (e2 < 4.0 * sigma2))
    good = counted & has_parallax
    n_good = counted.sum(-1)
    par_deg = torch.rad2deg(torch.arccos(cos_par.clamp(-1.0, 1.0)))
    par_sorted = torch.sort(torch.where(counted, par_deg,
                                        torch.full_like(par_deg, -1.0)),
                            dim=-1, descending=True).values
    k = (n_good - 1).clamp(0, 50)
    parallax = torch.where(n_good > 0,
                           par_sorted.gather(-1, k[:, None])[:, 0],
                           torch.zeros((B,), dtype=X.dtype, device=X.device))
    return n_good, parallax, X, good


def decompose_fundamental(F: torch.Tensor, K: torch.Tensor):
    """E = K^T F K -> the 4 candidate (R (4, 3, 3), t (4, 3)), unit t."""
    E = K.T @ F @ K
    U, _, Vh = torch.linalg.svd(E)
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: column
    # permutations, as exact as the products.
    UW = torch.stack([U[:, 1], -U[:, 0], U[:, 2]], -1)
    UWt = torch.stack([-U[:, 1], U[:, 0], U[:, 2]], -1)
    R1 = UW @ Vh
    R2 = UWt @ Vh
    R1 = R1 * torch.sign(_det3(R1))
    R2 = R2 * torch.sign(_det3(R2))
    t = U[:, 2]
    t = t / torch.linalg.vector_norm(t).clamp_min(1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras' SVD decomposition -> the 8 candidate (R (8, 3, 3), t (8,
    3)), unit t: four with d' > 0, then four with d' < 0 (ReconstructH)."""
    Kinv, _ = torch.linalg.inv_ex(K)
    U, w, Vh = torch.linalg.svd(Kinv @ H @ K)
    s = _det3(U) * _det3(Vh.T)
    d1, d2, d3 = w[0], w[1], w[2]
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
                      .clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
                      .clamp_min(0.0))
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                      .clamp_min(0.0))
    # Candidate i's signs: x1 (1, 1, -1, -1), x3 (1, -1, 1, -1) and the
    # rotation's sine (1, -1, -1, 1).
    i = torch.arange(4, device=H.device)
    sa = (1 - 2 * (i // 2)).to(H.dtype)
    sb = (1 - 2 * (i % 2)).to(H.dtype)
    x1s, x3s = sa * aux1, sb * aux3
    z, o = torch.zeros_like(x1s), torch.ones_like(x1s)

    # d' > 0: a rotation about y by theta.
    stheta = sa * sb * (root / ((d1 + d3) * d2))
    ctheta = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand(4)
    Rp_pos = torch.stack([torch.stack([ctheta, z, -stheta], -1),
                          torch.stack([z, o, z], -1),
                          torch.stack([stheta, z, ctheta], -1)], -2)
    tp_pos = torch.stack([x1s, z, -x3s], -1) * (d1 - d3)
    # d' < 0: a reflection-rotation by phi.
    sphi = sa * sb * (root / ((d1 - d3) * d2))
    cphi = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2)).expand(4)
    Rp_neg = torch.stack([torch.stack([cphi, z, sphi], -1),
                          torch.stack([z, -o, z], -1),
                          torch.stack([sphi, z, -cphi], -1)], -2)
    tp_neg = torch.stack([x1s, z, x3s], -1) * (d1 + d3)

    Rp = torch.cat([Rp_pos, Rp_neg])                           # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])
    Rs = s * ((U @ Rp) @ Vh)
    ts = (U @ tp[..., None])[..., 0]
    ts = ts / torch.linalg.vector_norm(ts, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    return Rs, ts


class TwoViewResult(NamedTuple):
    success: torch.Tensor   # () bool
    R: torch.Tensor         # (3, 3) cam1 -> cam2
    t: torch.Tensor         # (3,) unit length
    points: torch.Tensor    # (N, 3) in cam1's frame
    good: torch.Tensor      # (N,) triangulated inliers
    used_h: torch.Tensor    # () bool


def two_view_reconstruct(idx: torch.Tensor, x1, x2, K, mask,
                         sigma: float = 1.0,
                         min_triangulated: int = 50) -> TwoViewResult:
    """The monocular initialisation's two-view solve (Reconstruct), with
    the JAX package's deviation from the reference: both families are
    decomposed and checked (all 12 candidates in one ``check_rt``), and a
    family counts only if its best candidate reconstructs (enough good
    points, dominant over its runner-up, parallax above 1 degree); RH
    decides between two families that both do. ``idx``: (I, 8) sample
    indices, e.g. from :func:`sample_indices`."""
    models = ransac_two_models(idx, x1, x2, mask, sigma)
    rh = models["SH"] / (models["SH"] + models["SF"]).clamp_min(1e-9)
    Rs_h, ts_h = decompose_homography(models["H"], K)
    Rs_f, ts_f = decompose_fundamental(models["F"], K)
    n = x1.shape[0]
    inl = torch.cat([models["h_inliers"].expand(8, n),
                     models["f_inliers"].expand(4, n)])
    Rs, ts = torch.cat([Rs_h, Rs_f]), torch.cat([ts_h, ts_f])
    n_good, parallax, Xs, goods = check_rt(Rs, ts, x1, x2, K, inl,
                                           sigma * sigma)

    def family_best(lo: int, hi: int, fam_inl):
        ng = n_good[lo:hi]
        best = torch.argmax(ng)
        ng_best = _pick(ng, best)
        second = torch.sort(ng).values[-2]
        n_min = torch.clamp_min((0.9 * fam_inl.sum()).to(torch.int32),
                                min_triangulated)
        ok = ((ng_best >= n_min) & (second < 0.75 * ng_best)
              & (_pick(parallax[lo:hi], best) > 1.0) & (ng_best > 0))
        return ok, best + lo

    ok_h, best_h = family_best(0, 8, models["h_inliers"])
    ok_f, best_f = family_best(8, 12, models["f_inliers"])
    prefer_h = torch.where(ok_h & ok_f, rh > 0.50, ok_h)
    success = ok_h | ok_f
    c = torch.where(prefer_h, best_h, best_f)
    return TwoViewResult(
        success=success, R=_pick(Rs, c), t=_pick(ts, c),
        points=_pick(Xs, c), good=_pick(goods, c) & success,
        used_h=prefer_h & success)
