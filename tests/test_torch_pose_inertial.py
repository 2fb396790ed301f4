"""Port parity: the tracking-time pose-inertial optimization
(``solver/inertial.pose_inertial_optimization``) against the JAX package on
tests/test_inertial.py's scene: both variants (LastKeyFrame, and LastFrame
with a carried prior that the PSD projection must repair), mono and with
the stereo rows.

Tolerances: the pose within 1e-5; the velocity and biases within 2e-4
(with the prior the 30-dim system is ill-conditioned along the previous
frame's bias directions, where float32 reordering moves the JAX solve
itself by more); the same inliers; H_marg within 1e-4 of its largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_inertial import make_kf_chain
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.solver import inertial as jin
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.solver import inertial as tin

CAM = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
BF = 400.0 * 0.2


def _tpre(p):
    return convert.preint_to_torch(p, "cpu")


def _pose_problem(stereo: bool, seed: int = 5, n_pts: int = 48):
    """test_inertial's pose-inertial scene: keyframe 1 of a 3-keyframe
    chain seen by 48 points (stereo rows on two in three), the start
    0.02 rad and 0.1 m off."""
    rng = np.random.default_rng(seed)
    Rs, ps, vs, preints = make_kf_chain(n_kf=3, seg_steps=40)
    pc = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                   rng.uniform(3, 6, n_pts)], -1).astype(np.float32)
    pw = (pc @ Rs[1].T + ps[1]).astype(np.float32)
    uv = np.stack([400.0 * pc[:, 0] / pc[:, 2] + 320.0,
                   400.0 * pc[:, 1] / pc[:, 2] + 240.0], -1)
    ur = uv[:, 0] - BF / pc[:, 2] + rng.normal(0, 0.3, n_pts)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    ur = np.where(np.arange(n_pts) % 3 == 0, -1.0, ur).astype(np.float32)
    uv[:3] += 40.0                                   # three outliers
    dR = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.02, 3).astype(np.float32))))
    z3 = np.zeros(3, np.float32)
    f = np.float32
    state = [(dR @ Rs[1]).astype(f), (ps[1] + 0.1).astype(f),
             (vs[1] + 0.1).astype(f), z3, z3, Rs[0], ps[0], vs[0], z3, z3]
    visual = [pw, uv, np.ones(n_pts, f), np.ones(n_pts, bool), CAM,
              np.eye(3, dtype=f), z3, np.full((6,), 1e6, f)]
    pre = jax.tree.map(lambda x: x[0], preints)
    return state, visual, pre, (ur if stereo else None), Rs[1], ps[1], vs[1]


def _prior(seed=3):
    """A 15 x 15 prior with one eigenvalue slightly negative."""
    rng = np.random.default_rng(seed)
    lam = np.concatenate([[-1e-3], np.logspace(1.0, 6.0, 14)])
    Q, _ = np.linalg.qr(rng.normal(size=(15, 15)))
    return ((Q * lam) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("variant", ["mono", "stereo", "stereo_prior"])
def test_pose_inertial_optimization(variant):
    """Both variants (the LastKeyFrame solve, and the LastFrame solve with a
    carried prior that the PSD projection must repair), mono and with the
    stereo rows and their chi2 anneal: the port equals the JAX solve, and
    both reach the truth (test_inertial's 3 cm gate)."""
    stereo = variant != "mono"
    with_prior = variant == "stereo_prior"
    state, visual, pre, ur, R_t, p_t, v_t = _pose_problem(stereo)
    H = _prior() if with_prior else None
    kw_j = dict(prior_H=None if H is None else jnp.asarray(H),
                with_prior=with_prior)
    kw_t = dict(prior_H=None if H is None else t(H), with_prior=with_prior)
    if stereo:
        kw_j.update(obs_ur=jnp.asarray(ur), bf=jnp.asarray(BF))
        kw_t.update(obs_ur=t(ur), bf=BF)
    ref = jin.pose_inertial_optimization(
        *map(jnp.asarray, state), pre, *map(jnp.asarray, visual), **kw_j)
    out = tin.pose_inertial_optimization(
        *map(t, state), _tpre(pre), *map(t, visual), **kw_t)
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=1e-5)
    np.testing.assert_allclose(n(out.p), n(ref.p), atol=1e-5)
    for f in ("v", "bg", "ba"):
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=2e-4)
    np.testing.assert_array_equal(n(out.inlier), n(ref.inlier))
    assert int(out.n_inliers) == int(ref.n_inliers) == 45
    Hr = n(ref.H_marg)
    assert np.abs(n(out.H_marg) - Hr).max() <= 1e-4 * np.abs(Hr).max()
    assert np.linalg.norm(n(out.p) - p_t) < 0.03
    # The carried marginal is nearly PSD, as the JAX test asks.
    Hs = 0.5 * (n(out.H_marg) + n(out.H_marg).T).astype(np.float64)
    assert np.linalg.eigvalsh(Hs).min() > -1e-2 * np.abs(Hs).max()
