"""Port parity: the inertial factors and the inertial-only initialization
(``solver/inertial.py``) against the JAX package, on
tests/test_inertial.py's synthetic keyframe chains (the same numpy inputs
to both); the pose-inertial optimization is in
tests/test_torch_pose_inertial.py.

Tolerances: the residual within 1e-6 (absolute; float32, the same formulas,
the port's so3_log at float32 rounding); the whitening within 1e-5
relative; the inertial-only solve's gravity rotation within 1e-6, its
biases within 2e-6 (the accel bias under a 1e5 prior is itself about
1e-6), its scale within 1e-5 relative, its velocities within 1e-5 m/s; the
prior's square root within 1e-5 of the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_inertial import make_kf_chain
from torch_port_util import n, t

from orbslam3_byzyh_tpu.solver import inertial as jin
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.solver import inertial as tin


def _tpre(p):
    return convert.preint_to_torch(p, "cpu")


@pytest.mark.parametrize("case", ["truth", "wrong_velocity"])
def test_inertial_residual(case):
    """test_inertial's residual cases: ~0 at the truth, large with a wrong
    velocity, and the port's rows equal the JAX rows."""
    Rs, ps, vs, preints = make_kf_chain(n_kf=5)
    if case == "wrong_velocity":
        vs = vs + 0.5
    bg = np.zeros((4, 3), np.float32)
    args = (Rs[:-1], ps[:-1], vs[:-1], Rs[1:], ps[1:], vs[1:], bg, bg)
    ref = n(jin.inertial_residual(*map(jnp.asarray, args), preints))
    out = n(tin.inertial_residual(*map(t, args), _tpre(preints)))
    np.testing.assert_allclose(out, ref, atol=1e-6)
    if case == "truth":
        assert np.abs(out).max() < 2e-2
    else:
        assert np.abs(out).max() > 0.05


def test_preint_info_sqrt():
    """W^T W = C[:9, :9]^-1, and W equals the JAX whitening."""
    _, _, _, preints = make_kf_chain(n_kf=4)
    ref = n(jin.preint_info_sqrt(preints))
    out = n(tin.preint_info_sqrt(_tpre(preints)))
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert (np.abs(out - ref) <= 1e-5 * scale).all()
    C = n(preints.C)[:, :9, :9].astype(np.float64) + 1e-8 * np.eye(9)
    WtW = np.einsum("kji,kjl->kil", out.astype(np.float64), out)
    for k in range(len(C)):
        np.testing.assert_allclose(WtW[k] @ C[k], np.eye(9), atol=1e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_only_optimization(fix_scale):
    """test_inertial's init cases: gravity, scale and gyro bias from a
    tilted, half-scale visual chain (the free-scale case), velocities with
    the scale fixed; the port's solve equals the JAX solve."""
    if fix_scale:
        Rs, ps, vs, preints = make_kf_chain(n_kf=8)
        R_in, p_in, prior = Rs, ps, (1e2, 1e5)
    else:
        bg_true = np.array([0.004, -0.003, 0.002], np.float32)
        Rs, ps, vs, preints = make_kf_chain(n_kf=11, bg_true=bg_true)
        from scipy.spatial.transform import Rotation
        R_vw = Rotation.from_euler("xy", [8, -5], degrees=True).as_matrix() \
            .astype(np.float32)
        R_in = np.einsum("ij,kjl->kil", R_vw, Rs)
        p_in = (ps @ R_vw.T) / 2.0
        prior = (1e2, 1e10)
    ref = jin.inertial_only_optimization(
        jnp.asarray(R_in), jnp.asarray(p_in), preints, prior_g=prior[0],
        prior_a=prior[1], fix_scale=fix_scale)
    out = tin.inertial_only_optimization(
        t(R_in), t(p_in), _tpre(preints), prior_g=prior[0],
        prior_a=prior[1], fix_scale=fix_scale)
    np.testing.assert_allclose(n(out.R_wg), n(ref.R_wg), atol=1e-6)
    np.testing.assert_allclose(n(out.bg), n(ref.bg), atol=2e-6)
    np.testing.assert_allclose(n(out.ba), n(ref.ba), atol=2e-6)
    np.testing.assert_allclose(n(out.vel), n(ref.vel), atol=1e-5)
    assert abs(float(out.scale) - float(ref.scale)) <= 1e-5 * float(ref.scale)
    if fix_scale:
        assert float(out.scale) == 1.0
        np.testing.assert_allclose(n(out.vel), vs, atol=0.05)
    else:
        assert abs(float(out.scale) - 2.0) / 2.0 < 0.02
        g_est = n(out.R_wg) @ np.array([0, 0, -1.0])
        g_true = R_vw @ np.array([0, 0, -1.0])
        assert np.degrees(np.arccos(np.clip(g_est @ g_true, -1, 1))) < 1.0
        np.testing.assert_allclose(n(out.bg), bg_true, atol=2.5e-3)


def test_prior_sqrt_is_the_psd_projection():
    """L = prior_sqrt(H): L L^T = the symmetrised H with its negative
    eigenvalue clamped at 0, plus the trace-scaled damping, as the JAX
    package builds L_prior."""
    from test_torch_pose_inertial import _prior
    H = _prior()
    L = n(tin.prior_sqrt(t(H))).astype(np.float64)
    Hs = 0.5 * (H + H.T).astype(np.float64)
    lam, V = np.linalg.eigh(Hs)
    damp = 1e-6 * (1.0 + np.trace(Hs) / 15.0)
    want = (V * (np.maximum(lam, 0.0) + damp)) @ V.T
    assert np.abs(L @ L.T - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_pad", [5, 21])
def test_padded_chain_solves_as_the_chain(n_pad):
    """The CUDA path pads the chain to a power of two (``pad_chain``): the
    padded solve's gravity, scale, biases and the chain's velocities are
    the unpadded solve's (the free-scale case of 11 keyframes padded to 16
    and 32; float32 sums over more rows: within 1e-5 of the largest entry,
    or 1e-8 where all are smaller than 1e-3, as the accel bias under the
    1e10 prior, about 1e-8; the pad velocities exactly 0)."""
    import math

    import torch
    bg_true = np.array([0.004, -0.003, 0.002], np.float32)
    Rs, ps, _, preints = make_kf_chain(n_kf=11, bg_true=bg_true)
    R_in, p_in, pre = t(Rs), t(ps / 2.0), _tpre(preints)
    sqrt_prior = torch.tensor([math.sqrt(1e2), math.sqrt(1e10)])
    ones = torch.ones(len(Rs) - 1)
    plain = tin._inertial_only(R_in, p_in, pre, ones, sqrt_prior, 60, False)
    padded = tin._inertial_only(*tin.pad_chain(R_in, p_in, pre, n_pad),
                                sqrt_prior, 60, False)
    assert np.all(n(padded.vel[:n_pad]) == 0.0)
    for a, b in ((padded.R_wg, plain.R_wg), (padded.bg, plain.bg),
                 (padded.ba, plain.ba), (padded.scale, plain.scale),
                 (padded.vel[n_pad:], plain.vel)):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 1e-5 * scale
