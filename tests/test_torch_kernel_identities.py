"""The identities the card kernels K2 and K3 rest on, checked on the CPU.

* K3 (``csrc/pose_opt.cu``) makes one pass over the points per LM
  iteration: the pass at the candidate gives its cost together with H and g
  there, a rejected candidate keeps the current H and g, and the re-marking
  of a round's inliers shares the next round's first pass. Written here in
  float64 torch, that schedule must land on the plain version's pose.
* K2 (``csrc/match.cu``) takes the Hamming distance as
  popc(a) + popc(b) - 2 popc(a AND b), the sum that the tensor cores' 1-bit
  AND-popc product gives, and merges per-partition top-2 results with a
  lexicographic rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_pose_opt import make_problem
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.ops import matching as jm
from orbslam3_byzyh_tpu.solver import pallas_pose_opt
from orbslam3_byzyh_tpu_torch.ops import camera as cam
from orbslam3_byzyh_tpu_torch.ops import lie
from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt, lm, pose_opt

INVALID = jm.INVALID_DIST


def one_pass_schedule(R0, t0, pts, obs, inv_s2, valid, cam_params,
                      n_rounds=4, n_iters=10):
    """K3's schedule: (R, t, chi2, number of passes over the points)."""
    delta2 = lm.CHI2_MONO
    passes = 0

    def sweep(R, tt, inlier, robust, remark):
        """One pass at (R, tt): chi2 of every point; with ``remark`` the
        inliers re-marked from it first; then over the mask H, g, cost."""
        nonlocal passes
        passes += 1
        r, J, depth_ok = pose_opt._residuals_mono(R, tt, pts, obs, cam_params,
                                                  cam.PINHOLE)
        chi2 = (r * r).sum(-1) * inv_s2
        chi2_far = torch.where(depth_ok, chi2, 1e9)
        if remark:
            inlier = (chi2_far <= delta2) & valid
        mask = inlier & depth_ok
        outer = robust & (chi2 > delta2)
        w_rob = torch.where(outer, torch.sqrt(delta2 / chi2), 1.0)
        rho = torch.where(outer, 2.0 * torch.sqrt(delta2 * chi2) - delta2,
                          chi2)
        H, b = lm.assemble_normal(J, r, w_rob * inv_s2 * mask)
        return H, -b, (rho * mask).sum(), chi2_far, inlier

    R, tt, inlier = R0, t0, valid
    for rnd in range(n_rounds):
        robust = rnd < n_rounds - 1
        H, g, cost, chi2, inlier = sweep(R, tt, inlier, robust, rnd > 0)
        lam = torch.tensor(1e-3, dtype=torch.float32)   # as the plain version
        for _ in range(n_iters):
            dR, dt = lie.se3_exp(lm.solve_damped(H, g, lam))
            Rc, tc = lie.normalize_rotation(dR @ R), dR @ tt + dt
            Hc, gc, cost_c, chi2_c, _ = sweep(Rc, tc, inlier, robust, False)
            if cost_c < cost:           # accept: the pass's H and g carry on
                R, tt, H, g, cost, chi2 = Rc, tc, Hc, gc, cost_c, chi2_c
                lam *= 0.5
            else:                       # reject: H and g are still exact
                lam *= 10.0
    passes += 1          # K3's last pass writes chi2 at the final pose
    return R, tt, chi2, passes


@pytest.fixture(scope="module")
def pose_problem():
    rng = np.random.default_rng(5)
    R_gt, t_gt, pts, uv, inv_s2, valid, cam_p, _ = make_problem(
        rng, n=200, n_outliers=20)
    R0 = jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])) @ R_gt
    t0 = t_gt + jnp.asarray([0.05, -0.03, 0.08])
    return tuple(np.asarray(a) for a in (R0, t0, pts, uv, inv_s2, valid,
                                         cam_p))


def test_one_pass_schedule_matches_plain_and_pallas(pose_problem):
    args64 = [t(a).double() if a.dtype != bool else t(a)
              for a in pose_problem]
    R, tt, chi2, passes = one_pass_schedule(*args64)
    assert passes == 1 + 4 * 10 + 3 + 1     # what the kernel makes
    # The plain version (two passes an iteration) in float64: the same pose.
    Rp, tp, chi2p = cuda_pose_opt.pose_optimization_plain(*args64)
    np.testing.assert_allclose(n(R), n(Rp), atol=1e-6)
    np.testing.assert_allclose(n(tt), n(tp), atol=1e-6)
    np.testing.assert_allclose(n(chi2), n(chi2p), rtol=1e-9)
    valid = args64[5]
    # The JAX Pallas kernel, interpreted, in float32.
    Rk, tk, inl, _, _ = pallas_pose_opt.pose_optimization_fused(
        *[jnp.asarray(a) for a in pose_problem], interpret=True)
    np.testing.assert_allclose(n(R), np.asarray(Rk), atol=1e-4)
    np.testing.assert_allclose(n(tt), np.asarray(tk), atol=1e-4)
    assert (n((chi2 <= lm.CHI2_MONO) & valid) != np.asarray(inl)).sum() <= 2


def _bits(words):
    """(K, 8) uint32 words -> (K, 256) 0/1 bits, bit i of word w at 32w + i."""
    w = np.asarray(words).view(np.uint32)
    return ((w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        len(w), 256).astype(np.int64)


def test_and_popc_distance_equals_masked_hamming(rng):
    """d = popc(a) + popc(b) - 2 popc(a AND b), with popc(a AND b) the 0/1
    bit product summed over k = 256 (what one BMMA sums), bit for bit
    against the JAX package's masked_hamming."""
    na, nb = 90, 70
    db = rng.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
    db[1::2] = db[0::2]                         # duplicate columns
    da = rng.integers(0, 2 ** 32, (na, 8), dtype=np.uint32)
    da[::4] = db[rng.integers(0, nb, len(da[::4]))]
    da[1] = 0xFFFFFFFF
    db[0] = db[1] = 0
    va, vb = rng.random(na) > 0.1, rng.random(nb) > 0.1
    ba, bb = _bits(da), _bits(db)
    dot = ba @ bb.T
    d = ba.sum(1)[:, None] + bb.sum(1)[None, :] - 2 * dot
    mine = np.where(va[:, None] & vb[None, :], d, INVALID)
    ref = np.asarray(jm.masked_hamming(da, db, jnp.asarray(va),
                                       jnp.asarray(vb)))
    np.testing.assert_array_equal(mine, ref)
    assert (ref == 0).any()                     # equal descriptors met


def _push(best, second, bj, d, j):
    """K2's per-thread update, columns visited in increasing order."""
    lt = d < best
    second = np.where(lt, best, np.where(d < second, d, second))
    return np.where(lt, d, best), second, np.where(lt, j, bj)


def _merge(a, b):
    """K2's merge of two disjoint column sets' (best, second, best_j)."""
    (b1, s1, j1), (b2, s2, j2) = a, b
    mine = (b1 < b2) | ((b1 == b2) & (j1 < j2))
    return (np.where(mine, b1, b2),
            np.where(mine, np.minimum(s1, b2), np.minimum(s2, b1)),
            np.where(mine, j1, j2))


@pytest.mark.parametrize("parts", [1, 2, 5, 17])
def test_merge_rule_over_column_partitions(rng, parts):
    """Each part of a random column partition scanned in increasing order,
    the parts folded in a random order: the JAX package's best_two, ties
    and rows without a candidate included."""
    nr, nc = 64, 40
    dist = rng.integers(0, 9, (nr, nc)).astype(np.int32)   # many ties
    dist[rng.random((nr, nc)) < 0.3] = INVALID
    dist[::9] = INVALID                                     # no candidate
    owner = rng.integers(0, parts, nc)
    results = []
    for p in rng.permutation(parts):
        top = (np.full(nr, INVALID), np.full(nr, INVALID), np.zeros(nr, int))
        for j in np.flatnonzero(owner == p):   # a masked pair never enters
            top = _push(*top, dist[:, j], j)
        results.append(top)
    folded = results[0]
    for r in results[1:]:
        folded = _merge(folded, r)
    for mine, ref in zip(folded, jm.best_two(jnp.asarray(dist))):
        np.testing.assert_array_equal(mine, np.asarray(ref))
