"""Port parity: the SE(3), Sim(3) and quaternion operations against the
JAX package (``test_lie.py``'s cases, on the same numpy inputs), and the
pose graph's per-edge Jacobians at a zero tangent.

Tolerances: group operations within 1e-5 of the JAX functions (float32,
the same formulas; the port inverts Sim3's W by cofactors where the JAX
package calls ``inv``), and the JAX test's own gates on the port's
values. The Jacobians must be finite at a zero tangent (the small-angle
and small-sigma branches, where sqrt(theta^2) has an infinite derivative)
and within 2e-4 of ``jax.jacfwd``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.solver import pose_graph as jpg
from orbslam3_byzyh_tpu_torch.ops import lie as tlie
from orbslam3_byzyh_tpu_torch.solver import pose_graph as tpg

ATOL = 1e-5


def random_rotvecs(rng, n_=64, max_angle=3.0):
    axes = rng.normal(size=(n_, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = rng.uniform(0, max_angle, size=(n_, 1))
    return (axes * angles).astype(np.float32)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=atol)


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.uniform(-1.5, 1.5, size=(64, 6)).astype(np.float32)
        R, tt = tlie.se3_exp(t(xi))
        back = tlie.se3_log(R, tt)
        _close(back, jlie.se3_log(*jlie.se3_exp(jnp.asarray(xi))), 2e-5)
        np.testing.assert_allclose(n(back), xi, atol=3e-4)

    def test_mul_inv(self, rng):
        xi = rng.uniform(-1, 1, size=(16, 6)).astype(np.float32)
        R, tt = tlie.se3_exp(t(xi))
        Ri, ti = tlie.se3_inv(R, tt)
        Rj, tj = jlie.se3_inv(*jlie.se3_exp(jnp.asarray(xi)))
        _close(Ri, Rj)
        _close(ti, tj)
        Re, te = tlie.se3_mul(R, tt, Ri, ti)
        _close(Re, np.broadcast_to(np.eye(3), Re.shape))
        _close(te, 0)

    def test_apply(self, rng):
        xi = rng.uniform(-1, 1, size=(6,)).astype(np.float32)
        p = rng.normal(size=(10, 3)).astype(np.float32)
        R, tt = tlie.se3_exp(t(xi))
        ref = jlie.se3_apply(*jlie.se3_exp(jnp.asarray(xi)), jnp.asarray(p))
        _close(tlie.se3_apply(R, tt, t(p)), ref)
        np.testing.assert_allclose(n(tlie.se3_apply(R, tt, t(p))),
                                   p @ n(R).T + n(tt), atol=1e-5)

    def test_identity(self):
        R, tt = tlie.se3_identity((4,), device="cpu")
        Rj, tj = jlie.se3_identity((4,))
        _close(R, Rj, 0)
        _close(tt, tj, 0)


class TestSim3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.uniform(-1.0, 1.0, size=(64, 7)).astype(np.float32)
        S = tlie.sim3_exp(t(xi))
        Sj = jlie.sim3_exp(jnp.asarray(xi))
        for a, b in zip(S, Sj):
            _close(a, b, 2e-6)
        back = tlie.sim3_log(*S)
        _close(back, jlie.sim3_log(*Sj), 2e-5)
        np.testing.assert_allclose(n(back), xi, atol=1e-3)

    def test_small_tangent_roundtrip(self, rng):
        xi = rng.uniform(-1e-6, 1e-6, size=(16, 7)).astype(np.float32)
        R, tt, s = tlie.sim3_exp(t(xi))
        np.testing.assert_allclose(n(s), 1.0, atol=1e-5)
        back = tlie.sim3_log(R, tt, s)
        np.testing.assert_allclose(n(back), xi, atol=1e-6)
        _close(back, jlie.sim3_log(*jlie.sim3_exp(jnp.asarray(xi))), 1e-7)

    @pytest.mark.parametrize("case", ["theta0", "sigma0", "both0"])
    def test_calc_w_branches(self, rng, case):
        """Each small branch of calcW against the JAX function."""
        xi = rng.uniform(-0.5, 0.5, size=(16, 7)).astype(np.float32)
        if case in ("theta0", "both0"):
            xi[:, 3:6] *= 1e-7
        if case in ("sigma0", "both0"):
            xi[:, 6] *= 1e-7
        for a, b in zip(tlie.sim3_exp(t(xi)), jlie.sim3_exp(jnp.asarray(xi))):
            _close(a, b, 2e-6)

    def test_mul_inv(self, rng):
        xi = rng.uniform(-1, 1, size=(16, 7)).astype(np.float32)
        S = tlie.sim3_exp(t(xi))
        Si = tlie.sim3_inv(*S)
        for a, b in zip(Si, jlie.sim3_inv(*jlie.sim3_exp(jnp.asarray(xi)))):
            _close(a, b, 2e-5)
        Re, te, se = tlie.sim3_mul(*S, *Si)
        _close(Re, np.broadcast_to(np.eye(3), Re.shape))
        _close(te, 0)
        _close(se, 1)

    def test_apply_composition(self, rng):
        xa = rng.uniform(-1, 1, size=(7,)).astype(np.float32)
        xb = rng.uniform(-1, 1, size=(7,)).astype(np.float32)
        p = rng.normal(size=(10, 3)).astype(np.float32)
        A, B = tlie.sim3_exp(t(xa)), tlie.sim3_exp(t(xb))
        AB = tlie.sim3_mul(*A, *B)
        lhs = tlie.sim3_apply(*AB, t(p))
        rhs = tlie.sim3_apply(*A, tlie.sim3_apply(*B, t(p)))
        np.testing.assert_allclose(n(lhs), n(rhs), atol=1e-4)
        Aj = jlie.sim3_exp(jnp.asarray(xa))
        Bj = jlie.sim3_exp(jnp.asarray(xb))
        _close(lhs, jlie.sim3_apply(*jlie.sim3_mul(*Aj, *Bj),
                                    jnp.asarray(p)), 2e-5)

    def test_identity(self):
        for a, b in zip(tlie.sim3_identity((3,), device="cpu"),
                        jlie.sim3_identity((3,))):
            _close(a, b, 0)


class TestQuaternion:
    def test_quat_roundtrip(self, rng):
        w = random_rotvecs(rng, n_=128, max_angle=3.1)
        R = tlie.so3_exp(t(w))
        q = tlie.rot_to_quat(R)
        R_back = tlie.quat_to_rot(q)
        np.testing.assert_allclose(n(R_back), n(R), atol=1e-5)
        _close(R_back, jlie.quat_to_rot(jnp.asarray(n(q))), 1e-6)

    def test_quat_to_rot_unnormalised(self, rng):
        q = rng.normal(size=(32, 4)).astype(np.float32) * 3.0
        _close(tlie.quat_to_rot(t(q)), jlie.quat_to_rot(jnp.asarray(q)),
               1e-6)


def _edges(rng, E=24, scale=True):
    """Random vertex Sim3s and measurements near their relative poses."""
    xi_i = rng.uniform(-1, 1, (E, 7)).astype(np.float32)
    xi_j = rng.uniform(-1, 1, (E, 7)).astype(np.float32)
    if not scale:
        xi_i[:, 6] = 0
        xi_j[:, 6] = 0
    Si = jlie.sim3_exp(jnp.asarray(xi_i))
    Sj = jlie.sim3_exp(jnp.asarray(xi_j))
    M = jpg.relative_sim3(*Si, *Sj)
    noise = jlie.sim3_exp(jnp.asarray(
        rng.normal(0, 0.01, (E, 7)).astype(np.float32)))
    M = jlie.sim3_mul(*noise, *M)
    return [np.asarray(x) for x in (*Si, *Sj, *M)]


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_edge_jacobians_at_zero(rng, right, exact):
    """The pose graph's per-edge (7, 7) Jacobians by jacfwd at a zero
    tangent: finite, and equal to the JAX function's. ``exact`` makes every
    measurement the edge's own relative pose, so the residual's rotation
    and scale are zero: the small-theta and small-sigma branches."""
    SiR, Sit, Sis, SjR, Sjt, Sjs, MR, Mt, Ms = _edges(rng)
    if exact:
        MR, Mt, Ms = (np.asarray(x) for x in jpg.relative_sim3(
            *(jnp.asarray(a) for a in (SiR, Sit, Sis, SjR, Sjt, Sjs))))
    Minv = jlie.sim3_inv(*(jnp.asarray(a) for a in (MR, Mt, Ms)))
    E = SiR.shape[0]
    zeros = jnp.zeros((E, 7))

    def one(di, dj, *a):
        return jpg._edge_residual(di, dj, a[0:3], a[3:6], a[6:9], right)

    args = [jnp.asarray(a) for a in (SiR, Sit, Sis, SjR, Sjt, Sjs)] + list(
        Minv)
    r_j = jax.vmap(one)(zeros, zeros, *args)
    Ji_j = jax.vmap(jax.jacfwd(one, argnums=0))(zeros, zeros, *args)
    Jj_j = jax.vmap(jax.jacfwd(one, argnums=1))(zeros, zeros, *args)

    R = t(np.concatenate([SiR, SjR]))
    tt = t(np.concatenate([Sit, Sjt]))
    s = t(np.concatenate([Sis, Sjs]))
    ei = torch.arange(E)
    ej = torch.arange(E, 2 * E)
    Minv_t = tuple(t(np.asarray(x)) for x in Minv)
    r, Ji, Jj = tpg.edge_linearization(R, tt, s, ei, ej, Minv_t, right)
    for x in (r, Ji, Jj):
        assert torch.isfinite(x).all()
    np.testing.assert_allclose(n(r), np.asarray(r_j), atol=2e-5)
    np.testing.assert_allclose(n(Ji), np.asarray(Ji_j), atol=2e-4)
    np.testing.assert_allclose(n(Jj), np.asarray(Jj_j), atol=2e-4)
