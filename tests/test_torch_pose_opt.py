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
