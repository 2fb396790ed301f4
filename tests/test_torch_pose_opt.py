"""Port parity: the LM primitives and K3's plain version (the XLA path of
pose optimization) against the JAX package, on ``make_problem`` of the
Pallas pose-opt test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_pose_opt import make_problem
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.solver import lm as jlm
from orbslam3_byzyh_tpu.solver import pallas_pose_opt, pose_opt
from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt
from orbslam3_byzyh_tpu_torch.solver import lm as tlm
from orbslam3_byzyh_tpu_torch.solver import pose_opt as tpose

# R and t of two float32 runs of the same schedule: 1e-4 absolute.
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    R_gt, t_gt, pts, uv, inv_s2, valid, cam, _ = make_problem(rng)
    R0 = jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])) @ R_gt
    t0 = t_gt + jnp.asarray([0.05, -0.03, 0.08])
    return tuple(np.asarray(a) for a in (R0, t0, pts, uv, inv_s2, valid, cam))


def test_lm_primitives(rng):
    chi2 = rng.uniform(0, 20, 300).astype(np.float32)
    np.testing.assert_allclose(n(tlm.huber_weight(t(chi2), tlm.CHI2_MONO)),
                               n(jlm.huber_weight(chi2, jlm.CHI2_MONO)),
                               rtol=1e-6)
    J = rng.normal(0, 10, (300, 2, 6)).astype(np.float32)
    r = rng.normal(0, 1, (300, 2)).astype(np.float32)
    w = rng.uniform(0, 1, 300).astype(np.float32)
    H, b = tlm.assemble_normal(t(J), t(r), t(w))
    Hj, bj = jlm.assemble_normal(J, r, w)
    # float32 sums of 300 terms in another order.
    np.testing.assert_allclose(n(H), n(Hj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(n(b), n(bj), rtol=1e-5, atol=1e-3)
    dx = tlm.solve_damped(H, b, torch.tensor(1e-3))
    dxj = jlm.solve_damped(Hj, bj, 1e-3)
    np.testing.assert_allclose(n(dx), n(dxj), rtol=1e-4, atol=1e-6)


def test_plain_matches_xla_path(problem):
    ref = pose_opt.pose_optimization(*[jnp.asarray(a) for a in problem])
    out = tpose.pose_optimization(*[t(a) for a in problem])
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=POSE_TOL)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=POSE_TOL)
    np.testing.assert_array_equal(n(out.inlier), n(ref.inlier))
    assert int(out.n_inliers) == int(ref.n_inliers)


def test_plain_matches_pallas_interpret(problem):
    Rk, tk, inl, _, _ = pallas_pose_opt.pose_optimization_fused(
        *[jnp.asarray(a) for a in problem], interpret=True)
    R, tt, chi2 = cuda_pose_opt.pose_optimization_plain(
        *[t(a) for a in problem])
    np.testing.assert_allclose(n(R), n(Rk), atol=POSE_TOL)
    np.testing.assert_allclose(n(tt), n(tk), atol=POSE_TOL)
    inlier = (chi2 <= cuda_pose_opt.CHI2_MONO) & t(problem[5])
    np.testing.assert_array_equal(n(inlier), n(inl))


def test_batched_cpu_dispatch(problem):
    """A batch on the CPU runs the plain version problem by problem."""
    R0, t0, pts, uv, inv_s2, valid, cam = (t(a) for a in problem)
    R0b = torch.stack([R0, torch.eye(3) @ R0])
    args = (R0b, torch.stack([t0, t0 * 0.9]), torch.stack([pts, pts]),
            torch.stack([uv, uv]), torch.stack([inv_s2, inv_s2]),
            torch.stack([valid, valid]), cam)
    before = cuda_pose_opt.KERNEL.launches
    R, tt, chi2 = cuda_pose_opt.pose_optimization(*args)
    assert R.shape == (2, 3, 3) and chi2.shape == (2, pts.shape[0])
    R1, t1, c1 = cuda_pose_opt.pose_optimization_plain(
        R0b[1], args[1][1], pts, uv, inv_s2, valid, cam)
    assert torch.equal(R[1], R1) and torch.equal(tt[1], t1)
    assert cuda_pose_opt.KERNEL.launches == before


# --- pose_optimization_stereo (K3s's plain version) against the XLA path ---

def _stereo_problem(rng, n=500, bf=40.0):
    """test_pose_opt.py TestStereoPoseOpt's problem: half the rows stereo,
    noise 0.4 px on u, v and u_r."""
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 12, n)], -1).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.05, 3).astype(np.float32))))
    t_gt = np.array([0.2, -0.1, 0.3], np.float32)
    pc = pts @ R_gt.T + t_gt
    uv = np.stack([420 * pc[:, 0] / pc[:, 2] + 320,
                   420 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv += rng.normal(0, 0.4, uv.shape)
    ur = uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.4, n)
    ur = np.where(rng.uniform(size=n) < 0.5, ur, -1.0).astype(np.float32)
    cam = np.array([420.0, 420.0, 320.0, 240.0], np.float32)
    return R_gt, t_gt, pts, uv.astype(np.float32), ur, bf, cam


def _both_stereo(R0, t0, pts, uv, ur, bf, cam, valid=None):
    n_ = pts.shape[0]
    ones = np.ones(n_, np.float32)
    valid = np.ones(n_, bool) if valid is None else valid
    ref = pose_opt.pose_optimization_stereo(
        *(jnp.asarray(a) for a in (R0, t0, pts, uv, ur)), bf,
        jnp.asarray(ones), jnp.asarray(valid), jnp.asarray(cam))
    out = tpose.pose_optimization_stereo(
        *(t(np.asarray(a, np.float32)) for a in (R0, t0, pts, uv, ur)), bf,
        t(ones), t(valid), t(cam))
    return ref, out


def _same(out, ref):
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=POSE_TOL)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=POSE_TOL)
    np.testing.assert_array_equal(n(out.inlier), n(ref.inlier))
    assert int(out.n_inliers) == int(ref.n_inliers)


def test_stereo_recovers_pose_mixed(rng):
    """TestStereoPoseOpt.test_recovers_pose_mixed: the same result as the
    XLA path, and its gates (0.15 degrees, 0.02 m, 90 % inliers)."""
    R_gt, t_gt, pts, uv, ur, bf, cam = _stereo_problem(rng)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.015, 0.01]))) @ R_gt
    t0 = t_gt + np.array([0.05, -0.04, 0.08], np.float32)
    ref, out = _both_stereo(R0, t0, pts, uv, ur, bf, cam)
    _same(out, ref)
    ang = np.degrees(np.linalg.norm(np.asarray(jlie.so3_log(
        jnp.asarray(n(out.R) @ R_gt.T)))))
    assert ang < 0.15
    assert np.linalg.norm(n(out.t) - t_gt) < 0.02
    assert int(out.n_inliers) > 0.9 * pts.shape[0]


def test_stereo_all_mono_matches_mono_solver(rng):
    """TestStereoPoseOpt.test_all_mono_matches_mono_solver, and with every
    row mono K3s's plain version is K3's within 1e-5 (the three-row normal
    equations sum in another order over 40 iterations)."""
    R_gt, t_gt, pts, uv, _, bf, cam = _stereo_problem(rng)
    ur = np.full(pts.shape[0], -1.0, np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.015, 0.01, -0.02]))) @ R_gt
    t0 = t_gt + np.array([-0.04, 0.05, 0.06], np.float32)
    ref, out = _both_stereo(R0, t0, pts, uv, ur, bf, cam)
    _same(out, ref)
    ones = np.ones(pts.shape[0], np.float32)
    mono = tpose.pose_optimization(
        *(t(np.asarray(a, np.float32)) for a in (R0, t0, pts, uv, ones)),
        t(np.ones(pts.shape[0], bool)), t(cam))
    np.testing.assert_allclose(n(out.R), n(mono.R), atol=1e-5)
    np.testing.assert_allclose(n(out.t), n(mono.t), atol=1e-5)
    np.testing.assert_array_equal(n(out.inlier), n(mono.inlier))


def test_stereo_tightens_depth_axis(rng):
    """TestStereoPoseOpt.test_stereo_tightens_depth_axis: 60 near-collinear
    points pushed 0.4 m along z; the u_r rows pull it back under 0.05 m.
    The 60 rows are padded to the other cases' 500 with invalid rows, so
    the JAX function compiles once for the file."""
    n_, bf = 60, 40.0
    pts = np.stack([rng.uniform(-0.5, 0.5, n_), rng.uniform(-0.4, 0.4, n_),
                    rng.uniform(6, 8, n_)], -1).astype(np.float32)
    uv = np.stack([420 * pts[:, 0] / pts[:, 2] + 320,
                   420 * pts[:, 1] / pts[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    ur = (uv[:, 0] - bf / pts[:, 2]).astype(np.float32)
    cam = np.array([420.0, 420.0, 320.0, 240.0], np.float32)
    pad = 500 - n_
    ref, out = _both_stereo(
        np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 0.4], np.float32),
        np.concatenate([pts, np.tile(pts[:1], (pad, 1))]),
        np.concatenate([uv, np.tile(uv[:1], (pad, 1))]),
        np.concatenate([ur, np.full(pad, -1.0, np.float32)]), bf, cam,
        valid=np.arange(500) < n_)
    _same(out, ref)
    assert abs(float(out.t[2])) < 0.05


def test_stereo_batched_cpu_dispatch(rng):
    """A batch of stereo problems on the CPU: each row is its single run."""
    R_gt, t_gt, pts, uv, ur, bf, cam = _stereo_problem(rng, n=200)
    ones, valid = np.ones(200, np.float32), np.ones(200, bool)
    one = [t(np.asarray(a, np.float32)) for a in (R_gt, t_gt, pts, uv, ur)]
    batch = [torch.stack([a, a]) for a in one]
    batch[1][1] += 0.05
    R, tt, chi2 = cuda_pose_opt.pose_optimization_stereo(
        *batch, bf, torch.stack([t(ones)] * 2), torch.stack([t(valid)] * 2),
        t(cam))
    R1, t1, c1 = cuda_pose_opt.pose_optimization_stereo_plain(
        batch[0][1], batch[1][1], *one[2:], bf, t(ones), t(valid), t(cam))
    assert torch.equal(R[1], R1) and torch.equal(tt[1], t1)
    assert torch.equal(chi2[1], c1)
