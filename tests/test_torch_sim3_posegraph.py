"""Port parity: the Sim3 RANSAC, OptimizeSim3 and the pose graph against
the JAX package (``test_sim3_posegraph.py``'s five cases on the same numpy
inputs).

The RANSAC runs on the JAX function's own sample rows (recomputed here
from ``jax.random.split`` and ``choice``: the stream cannot be reproduced
in torch). Tolerances: the RANSAC's (R, t, s) within 1e-4 of the JAX
result and its inliers equal (a 3 x 3 SVD in each package, float32);
OptimizeSim3 within 1e-4; the pose graph within 1e-4 in all three DoF
modes after 25-30 LM iterations (float32 dense solves of different
libraries; the port re-projects rotations by Newton polar iterations,
the JAX package by SVD). The live-prefix solve against the all-slot one:
within 1e-4 (float32 LU at two sizes). Each case also holds the JAX test's
own gates on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.ops import sim3_solve as jsim3
from orbslam3_byzyh_tpu.solver import pose_graph as jpg
from orbslam3_byzyh_tpu_torch.ops import sim3_solve as tsim3
from orbslam3_byzyh_tpu_torch.solver import pose_graph as tpg

TOL = 1e-4


def jax_rows(key, n_rows: int, n_iters: int = 128) -> np.ndarray:
    """The JAX sim3_ransac's (n_iters, 3) sample rows for ``key`` over
    ``n_rows`` pairs, all valid."""
    keys = jax.random.split(key, n_iters)
    w = jnp.ones(n_rows) + 1e-9
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n_rows, (3,), replace=False, p=w / w.sum()))(keys))


def _ransac_problem(rng, n_pts=200, scale=0.3, outliers=50):
    pa = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    xi = rng.uniform(-0.5, 0.5, 7).astype(np.float32)
    xi[6] = scale
    R, tt, s = jlie.sim3_exp(jnp.asarray(xi))
    pb = np.array(jlie.sim3_apply(R, tt, s, jnp.asarray(pa)))
    if outliers:
        pb += rng.normal(0, 0.01, pb.shape)
        out = rng.choice(n_pts, outliers, replace=False)
        pb[out] += rng.uniform(1, 3, (outliers, 3))
    else:
        out = np.zeros(0, int)
    return pa, pb.astype(np.float32), (R, tt, s), out


def _compare_ransac(res_t, res_j):
    np.testing.assert_allclose(n(res_t.R), np.asarray(res_j.R), atol=TOL)
    np.testing.assert_allclose(n(res_t.t), np.asarray(res_j.t), atol=TOL)
    np.testing.assert_allclose(float(res_t.s), float(res_j.s), atol=TOL)
    np.testing.assert_array_equal(n(res_t.inliers), np.asarray(res_j.inliers))
    assert bool(res_t.ok) == bool(res_j.ok)


class TestSim3Ransac:
    def test_recovers_transform_with_outliers(self, rng):
        pa, pb, (R, tt, s), out = _ransac_problem(rng)
        n_pts = pa.shape[0]
        key = jax.random.PRNGKey(0)
        res_j = jsim3.sim3_ransac(key, jnp.asarray(pa), jnp.asarray(pb),
                                  jnp.ones(n_pts, bool))
        res = tsim3.sim3_ransac(torch.from_numpy(jax_rows(key, n_pts)),
                                t(pa), t(pb), torch.ones(n_pts, dtype=bool))
        _compare_ransac(res, res_j)
        assert bool(res.ok)
        inl = n(res.inliers)
        assert not inl[out].any() or inl[out].mean() < 0.1
        assert abs(float(res.s) - float(s)) < 0.01
        np.testing.assert_allclose(n(res.R), np.asarray(R), atol=5e-3)
        np.testing.assert_allclose(n(res.t), np.asarray(tt), atol=5e-2)

    def test_se3_mode(self, rng):
        pa, pb, _, _ = _ransac_problem(rng, 100, 0.0, 0)
        key = jax.random.PRNGKey(0)
        res_j = jsim3.sim3_ransac(key, jnp.asarray(pa), jnp.asarray(pb),
                                  jnp.ones(100, bool), with_scale=False)
        res = tsim3.sim3_ransac(torch.from_numpy(jax_rows(key, 100)), t(pa),
                                t(pb), torch.ones(100, dtype=bool),
                                with_scale=False)
        _compare_ransac(res, res_j)
        assert bool(res.ok)
        assert abs(float(res.s) - 1.0) < 1e-6

    @pytest.mark.parametrize("n_pts", [63, 64])
    def test_padded_rows(self, rng, n_pts):
        """The port's pairs stay one row per keypoint, masked: the same
        RANSAC on the compact pairs spread over padded rows (odd and even
        counts, for the median), the JAX rows mapped through the mask."""
        pa, pb, _, _ = _ransac_problem(rng, n_pts, 0.2, 10)
        N = 160
        rows = np.sort(rng.choice(N, n_pts, replace=False))
        mask = np.zeros(N, bool)
        mask[rows] = True
        pa_p = rng.normal(size=(N, 3)).astype(np.float32) * 50
        pb_p = rng.normal(size=(N, 3)).astype(np.float32) * 50
        pa_p[rows], pb_p[rows] = pa, pb
        key = jax.random.PRNGKey(7)
        res_j = jsim3.sim3_ransac(key, jnp.asarray(pa), jnp.asarray(pb),
                                  jnp.ones(n_pts, bool), th=0.1)
        idx = rows[jax_rows(key, n_pts)]
        res = tsim3.sim3_ransac(torch.from_numpy(idx), t(pa_p), t(pb_p),
                                torch.from_numpy(mask), th=0.1)
        np.testing.assert_allclose(n(res.R), np.asarray(res_j.R), atol=TOL)
        np.testing.assert_allclose(n(res.t), np.asarray(res_j.t), atol=TOL)
        np.testing.assert_allclose(float(res.s), float(res_j.s), atol=TOL)
        np.testing.assert_array_equal(n(res.inliers)[rows],
                                      np.asarray(res_j.inliers))
        assert not n(res.inliers)[~mask].any()

    def test_draw_indices(self):
        """The port's own draw: three distinct rows, all inside the mask."""
        mask = torch.zeros(300, dtype=torch.bool)
        mask[torch.arange(5, 300, 7)] = True
        idx = tsim3.draw_indices(torch.Generator().manual_seed(3), mask)
        assert idx.shape == (128, 3)
        assert mask[idx].all()
        assert (idx[:, 0] != idx[:, 1]).all() and (idx[:, 1] != idx[:, 2]).all()
        assert (idx[:, 0] != idx[:, 2]).all()


def _opt_sim3_problem(rng, M=64, scale=1.2):
    cam = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    R_qw = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.02, -0.1, 0.03],
                                                        np.float32))))
    t_qw = np.array([0.1, -0.05, 0.2], np.float32)
    R_cw = np.asarray(jlie.so3_exp(jnp.asarray(np.array([-0.03, 0.2, 0.01],
                                                        np.float32))))
    t_cw = np.array([-0.2, 0.05, 0.1], np.float32)
    xi = np.array([0.05, -0.02, 0.03, 0.01, 0.02, -0.015, np.log(scale)],
                  np.float32)
    U = [np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(xi))]
    # Candidate-world points in front of both cameras.
    pc_c = np.stack([rng.uniform(-1, 1, M), rng.uniform(-0.8, 0.8, M),
                     rng.uniform(3, 6, M)], -1).astype(np.float32)
    p_c = (pc_c - t_cw) @ R_cw
    p_q = (U[2] * p_c @ U[0].T + U[1]).astype(np.float32)

    def proj(R, tt, p):
        pc = p @ R.T + tt
        return np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                         cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], -1)

    uv_q = (proj(R_qw, t_qw, p_q) + rng.normal(0, 0.5, (M, 2))).astype(
        np.float32)
    uv_c = (proj(R_cw, t_cw, p_c) + rng.normal(0, 0.5, (M, 2))).astype(
        np.float32)
    uv_q[:4] += 40.0                    # gross outliers
    valid_a = np.arange(M) < M - 6
    valid_b = valid_a & (np.arange(M) % 3 != 0)
    invs2 = np.ones(M, np.float32)
    x0 = jlie.sim3_exp(jnp.asarray(xi + np.float32(0.02)))
    return ([np.asarray(a) for a in x0], p_c.astype(np.float32), uv_q, invs2,
            valid_a, R_qw, t_qw, p_q, uv_c, invs2, valid_b, R_cw, t_cw, cam,
            U)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3(rng, fix_scale):
    """OptimizeSim3 (10 Gauss-Newton iterations over both directions,
    the midpoint outlier drop) against the JAX function."""
    p = _opt_sim3_problem(rng, scale=1.0 if fix_scale else 1.2)
    (R0, t0, s0), rest, U = p[0], p[1:-1], p[-1]
    if fix_scale:
        s0 = np.float32(1.0)
    res_j = jsim3.optimize_sim3(R0, t0, s0, *(jnp.asarray(a) for a in rest),
                                fix_scale=fix_scale)
    res = tsim3.optimize_sim3(t(R0), t(t0), float(s0),
                              *(t(a) for a in rest), fix_scale=fix_scale)
    np.testing.assert_allclose(n(res.R), np.asarray(res_j.R), atol=TOL)
    np.testing.assert_allclose(n(res.t), np.asarray(res_j.t), atol=TOL)
    np.testing.assert_allclose(float(res.s), float(res_j.s), atol=TOL)
    np.testing.assert_array_equal(n(res.inliers_a),
                                  np.asarray(res_j.inliers_a))
    assert int(res.n_inliers) == int(res_j.n_inliers)
    # It recovers the planted Sim3 and drops the planted outliers.
    np.testing.assert_allclose(n(res.R), U[0], atol=5e-3)
    np.testing.assert_allclose(float(res.s), float(U[2]), atol=5e-3)
    assert not n(res.inliers_a)[:4].any()


def make_loop_problem(rng, n_kf=12, drift=0.02):
    """``test_sim3_posegraph.make_loop_problem`` (numpy, with the JAX
    package's group functions)."""
    Rs_gt, ts_gt = [], []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        Rwc = np.asarray(jlie.so3_exp(jnp.asarray(
            np.array([0, ang, 0], np.float32))))
        c = np.array([np.sin(ang) * 3, 0, 3 - np.cos(ang) * 3], np.float32)
        Rs_gt.append(Rwc.T)
        ts_gt.append(-Rwc.T @ c)
    Rs_gt, ts_gt = np.stack(Rs_gt), np.stack(ts_gt)
    Rs_o, ts_o = [Rs_gt[0]], [ts_gt[0]]
    rels = []
    one = jnp.asarray(1.0)
    for k in range(1, n_kf):
        Rrel, trel, _ = jpg.relative_sim3(
            jnp.asarray(Rs_gt[k]), jnp.asarray(ts_gt[k]), one,
            jnp.asarray(Rs_gt[k - 1]), jnp.asarray(ts_gt[k - 1]), one)
        dR = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, drift, 3).astype(np.float32))))
        Rrel_n = dR @ np.asarray(Rrel)
        trel_n = (np.asarray(trel) + rng.normal(0, drift, 3)).astype(
            np.float32)
        rels.append((Rrel_n, trel_n))
        R_new, t_new, _ = jlie.sim3_mul(
            jnp.asarray(Rrel_n), jnp.asarray(trel_n), one,
            jnp.asarray(Rs_o[-1]), jnp.asarray(ts_o[-1]), one)
        Rs_o.append(np.asarray(R_new))
        ts_o.append(np.asarray(t_new))
    return Rs_gt, ts_gt, np.stack(Rs_o), np.stack(ts_o), rels


def _chain_edges(Rs, ts, loop_R, loop_t, loop_w, rels=None):
    n_kf = Rs.shape[0]
    ei, ej, mR, mt, w = [], [], [], [], []
    one = jnp.asarray(1.0)
    for k in range(1, n_kf):
        if rels is None:
            Rrel, trel, _ = jpg.relative_sim3(
                jnp.asarray(Rs[k]), jnp.asarray(ts[k]), one,
                jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]), one)
        else:
            Rrel, trel = rels[k - 1]
        ei.append(k)
        ej.append(k - 1)
        mR.append(np.asarray(Rrel))
        mt.append(np.asarray(trel))
        w.append(1.0)
    ei.append(n_kf - 1)
    ej.append(0)
    mR.append(np.asarray(loop_R))
    mt.append(np.asarray(loop_t))
    w.append(loop_w)
    E = len(ei)
    return (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.ones(E, np.float32), np.asarray(w, np.float32))


def _run_both(Rs, ts, edges, dof, n_iters, right=False):
    n_kf = Rs.shape[0]
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    args = (Rs.astype(np.float32), ts.astype(np.float32),
            np.ones(n_kf, np.float32), *edges, fixed)
    res_j = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in args), dof,
                                    n_iters=n_iters, right_perturb=right)
    res = tpg.optimize_pose_graph(*(torch.from_numpy(np.asarray(a))
                                    for a in args), dof, n_iters=n_iters,
                                  right_perturb=right)
    for a, b in ((res.R, res_j.R), (res.t, res_j.t), (res.s, res_j.s)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=TOL)
    np.testing.assert_allclose(float(res.cost), float(res_j.cost), rtol=1e-3,
                               atol=1e-6)
    return res, args


def _gt_loop(Rs_gt, ts_gt):
    one = jnp.asarray(1.0)
    R, tt, _ = jpg.relative_sim3(
        jnp.asarray(Rs_gt[-1]), jnp.asarray(ts_gt[-1]), one,
        jnp.asarray(Rs_gt[0]), jnp.asarray(ts_gt[0]), one)
    return np.asarray(R), np.asarray(tt)


class TestPoseGraph:
    def test_loop_closure_reduces_drift(self, rng):
        n_kf = 12
        Rs_gt, ts_gt, Rs_o, ts_o, rels = make_loop_problem(rng, n_kf)
        edges = _chain_edges(Rs_o, ts_o, *_gt_loop(Rs_gt, ts_gt), 1.0, rels)
        drift_before = np.linalg.norm(
            (-Rs_o[-1].T @ ts_o[-1]) - (-Rs_gt[-1].T @ ts_gt[-1]))
        res, _ = _run_both(Rs_o, ts_o, edges, tpg.DOF_SE3, 25)
        c_after = -np.einsum("nji,nj->ni", n(res.R), n(res.t))
        c_gt = -np.einsum("nji,nj->ni", Rs_gt, ts_gt)
        drift_after = np.linalg.norm(c_after - c_gt, axis=-1)[-1]
        assert drift_after < 0.5 * drift_before, (drift_before, drift_after)
        assert np.all(np.abs(n(res.s) - 1.0) < 1e-4)

    def test_scale_drift_correction_sim3(self, rng):
        n_kf = 10
        Rs_gt, ts_gt, _, _, _ = make_loop_problem(rng, n_kf, drift=0.0)
        scales = np.cumprod(np.full(n_kf, 1.03))
        Rs_o = Rs_gt.copy()
        ts_o = (ts_gt * scales[:, None]).astype(np.float32)
        edges = _chain_edges(Rs_o, ts_o, *_gt_loop(Rs_gt, ts_gt), 5.0)
        res, _ = _run_both(Rs_o, ts_o, edges, tpg.DOF_SIM3, 30)
        s_out = n(res.s)
        assert s_out.std() > 1e-3
        c_after = -n(res.R)[-1].T @ (n(res.t)[-1] / s_out[-1])
        c_gt = -Rs_gt[-1].T @ ts_gt[-1]
        c_before = -Rs_o[-1].T @ ts_o[-1]
        assert np.linalg.norm(c_after - c_gt) < np.linalg.norm(c_before - c_gt)

    def test_4dof_world_yaw_preserves_gravity(self, rng):
        n_kf = 12
        pitch = np.asarray(jlie.so3_exp(jnp.asarray(
            np.array([0.5, 0, 0], np.float32))))
        Rs_gt, ts_gt = [], []
        for k in range(n_kf):
            ang = 2 * np.pi * k / n_kf
            yaw = np.asarray(jlie.so3_exp(jnp.asarray(
                np.array([0, 0, ang], np.float32))))
            R_wc = yaw @ pitch
            c = np.array([np.cos(ang) * 3, np.sin(ang) * 3, 1.0], np.float32)
            Rs_gt.append(R_wc.T)
            ts_gt.append(-R_wc.T @ c)
        Rs_gt, ts_gt = np.stack(Rs_gt), np.stack(ts_gt)
        Rs_o = np.stack([Rs_gt[k] @ np.asarray(jlie.so3_exp(jnp.asarray(
            np.array([0, 0, 0.04 * k], np.float32)))) for k in range(n_kf)
        ]).astype(np.float32)
        ts_o = ts_gt.astype(np.float32)
        edges = _chain_edges(Rs_o, ts_o, *_gt_loop(Rs_gt, ts_gt), 5.0)
        res, _ = _run_both(Rs_o, ts_o, edges, tpg.DOF_4, 30, right=True)
        R_out = n(res.R)

        def rot_err(Ra, Rb):
            return np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))

        assert rot_err(R_out[-1], Rs_gt[-1]) < 0.5 * rot_err(Rs_o[-1],
                                                             Rs_gt[-1])
        ez = np.array([0, 0, 1.0], np.float32)
        tilt = np.arccos(np.clip(((Rs_o @ ez) * (R_out @ ez)).sum(-1), -1, 1))
        assert tilt.max() < 1e-3, tilt.max()
        assert np.all(np.abs(n(res.s) - 1.0) < 1e-4)

    @pytest.mark.parametrize("dof", ["sim3", "se3", "4dof"])
    def test_live_prefix_equals_all_slots(self, rng, dof):
        """The port's live-prefix solve (``n_live``) against the all-slot
        solve, the map padded to 40 slots (12 live): the prefix's poses
        within 1e-4, the other slots returned as they came."""
        mode = {"sim3": tpg.DOF_SIM3, "se3": tpg.DOF_SE3, "4dof": tpg.DOF_4}
        n_kf, K = 12, 40
        Rs_gt, ts_gt, Rs_o, ts_o, rels = make_loop_problem(rng, n_kf)
        edges = _chain_edges(Rs_o, ts_o, *_gt_loop(Rs_gt, ts_gt), 5.0, rels)
        R = np.concatenate([Rs_o, np.tile(np.eye(3), (K - n_kf, 1, 1))])
        tt = np.concatenate([ts_o, rng.normal(size=(K - n_kf, 3))])
        fixed = np.zeros(K, bool)
        fixed[0] = True
        args = [torch.from_numpy(np.asarray(a, dtype)) for a, dtype in (
            (R, np.float32), (tt, np.float32), (np.ones(K), np.float32))]
        args += [torch.from_numpy(a) for a in edges]
        args.append(torch.from_numpy(fixed))
        right = dof == "4dof"
        full = tpg.optimize_pose_graph(*args, mode[dof], n_iters=25,
                                       right_perturb=right)
        live = tpg.optimize_pose_graph(*args, mode[dof], n_iters=25,
                                       right_perturb=right, n_live=n_kf)
        P = 16                                   # bucket(12) from 16
        for a, b in ((live.R, full.R), (live.t, full.t), (live.s, full.s)):
            np.testing.assert_allclose(n(a)[:n_kf], n(b)[:n_kf], atol=TOL)
        np.testing.assert_array_equal(n(live.t)[P:], n(args[1])[P:])
        np.testing.assert_array_equal(n(live.R)[P:], n(args[0])[P:])
