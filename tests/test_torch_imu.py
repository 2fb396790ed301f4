"""Port parity: IMU preintegration (``ops/imu.py``) and the lie additions
(``vee``, ``so3_log``, ``so3_right_jacobian_inv``, ``project_rotation``)
against the JAX package.

Replays tests/test_imu.py's six cases on both packages (the same numpy
inputs), then holds the port to the JAX results. Tolerances: the
preintegration state within 5e-6 relative to each field's largest entry
(2e-5 over the 1000-step window: float32 recursions whose rounding
walks; the port projects dR onto SO(3) by Newton polar iterations where
the JAX package takes the SVD, within 1e-6 per step); the covariance within
1e-5 relative; the lie functions within 1e-6 (near pi, where both
packages divide by a float32 sine of about 1e-4, 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_imu import NOISE, WALK, synth_trajectory
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import imu as jimu
from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu_torch.ops import imu as timu
from orbslam3_byzyh_tpu_torch.ops import lie as tlie

NOISE_T, WALK_T = t(np.asarray(NOISE)), t(np.asarray(WALK))
RTOL = 5e-6


def _both(acc, gyr, dts, bias=None):
    bias = np.zeros(6, np.float32) if bias is None else bias
    js = jimu.integrate(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                        jnp.asarray(bias), NOISE, WALK)
    ts = timu.integrate(t(acc), t(gyr), t(dts), t(bias), NOISE_T, WALK_T)
    return js, ts


def _assert_state_close(js, ts, rtol=RTOL):
    for f in timu.PreintState._fields:
        a, b = n(getattr(js, f)), n(getattr(ts, f))
        scale = max(float(np.abs(a).max()), 1e-30)
        tol = 1e-5 if f == "C" else rtol
        assert np.abs(a - b).max() <= tol * scale, (f, np.abs(a - b).max(),
                                                    scale)


def test_predicts_analytic_trajectory():
    """test_imu's first case on both: the port's prediction agrees with
    the JAX package's within 2e-5 (relative and absolute) and with the
    truth within its gates."""
    acc, gyr, dts, gt = synth_trajectory(n_steps=1000, rate=1000.0)
    js, ts = _both(acc, gyr, dts)
    _assert_state_close(js, ts, rtol=2e-5)
    f = np.float32
    args = [gt["R0"].astype(f), gt["v0"].astype(f), gt["p0"].astype(f)]
    jR, jv, jp = jimu.predict_state(*map(jnp.asarray, args), js,
                                    jnp.zeros(6))
    tR, tv, tp = timu.predict_state(*map(t, args), ts, torch.zeros(6))
    for a, b in ((jR, tR), (jv, tv), (jp, tp)):
        np.testing.assert_allclose(n(b), n(a), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(n(tR), gt["R1"], atol=2e-3)
    np.testing.assert_allclose(n(tv), gt["v1"], atol=5e-3)
    np.testing.assert_allclose(n(tp), gt["p1"], atol=5e-3)
    assert abs(float(ts.dT) - gt["T"]) < 1e-5


@pytest.mark.parametrize("pad", [30, 14])
def test_padding_is_identity(pad):
    """dt == 0 rows (the JAX rule, each pad row a strict no-op) give the
    unpadded state, bit for bit, and agree with the JAX scan: an arbitrary
    pad, and the 14 rows that ``preintegrate`` adds to a 50-sample window
    (``cuda_graph.bucket``'s 64)."""
    acc, gyr, dts, _ = synth_trajectory(n_steps=50)
    acc_p = np.concatenate([acc, np.ones((pad, 3), np.float32)])
    gyr_p = np.concatenate([gyr, np.ones((pad, 3), np.float32)])
    dts_p = np.concatenate([dts, np.zeros(pad, np.float32)])
    plain = timu.integrate(t(acc), t(gyr), t(dts), torch.zeros(6), NOISE_T,
                           WALK_T)
    padded = timu.integrate(t(acc_p), t(gyr_p), t(dts_p), torch.zeros(6),
                            NOISE_T, WALK_T)
    for a, b in zip(plain, padded):
        assert torch.equal(a, b)
    js = jimu.integrate(jnp.asarray(acc_p), jnp.asarray(gyr_p),
                        jnp.asarray(dts_p), jnp.zeros(6), NOISE, WALK)
    _assert_state_close(js, padded)


def test_bias_jacobians_match_reintegration():
    """The bias-corrected getters against re-integration (test_imu's gates)
    and against the JAX getters (5e-6 relative to the largest entry)."""
    acc, gyr, dts, _ = synth_trajectory(n_steps=100)
    db = np.array([3e-3, -2e-3, 1e-3, 2e-2, -1e-2, 1.5e-2], np.float32)
    js0, ts0 = _both(acc, gyr, dts)
    _, ts1 = _both(acc, gyr, dts, bias=db)
    for name, atol in (("delta_rotation", 2e-4), ("delta_velocity", 2e-3),
                       ("delta_position", 2e-3)):
        out = n(getattr(timu, name)(ts0, t(db)))
        ref = n(getattr(jimu, name)(js0, jnp.asarray(db)))
        np.testing.assert_allclose(out, ref, atol=5e-6 * np.abs(ref).max())
        field = {"delta_rotation": "dR", "delta_velocity": "dV",
                 "delta_position": "dP"}[name]
        np.testing.assert_allclose(out, n(getattr(ts1, field)), atol=atol)


def test_covariance_psd_and_growth():
    acc, gyr, dts, _ = synth_trajectory(n_steps=100)
    js, ts = _both(acc, gyr, dts)
    _assert_state_close(js, ts)
    C = n(ts.C).astype(np.float64)
    C = 0.5 * (C + C.T)
    assert np.linalg.eigvalsh(C).min() > -1e-10
    expected = (1.7e-4) ** 2 * float(dts[0]) * float(ts.dT)
    np.testing.assert_allclose(np.diag(C)[:3], expected, rtol=0.3)


def test_merge_equals_concatenation():
    """Integrating A then continuing with B's samples step by step equals
    integrating A+B (the keyframe-culling merge), in the port, and the
    continued state agrees with the JAX package's."""
    acc, gyr, dts, _ = synth_trajectory(n_steps=120)
    half = 60
    _, full = _both(acc, gyr, dts)
    s_ab = timu.integrate(t(acc[:half]), t(gyr[:half]), t(dts[:half]),
                          torch.zeros(6), NOISE_T, WALK_T)
    j_ab = jimu.integrate(jnp.asarray(acc[:half]), jnp.asarray(gyr[:half]),
                          jnp.asarray(dts[:half]), jnp.zeros(6), NOISE, WALK)
    for i in range(half, 120):
        s_ab = timu.integrate_step(s_ab, t(acc[i]), t(gyr[i]), t(dts[i]),
                                   NOISE_T, WALK_T)
        j_ab = jimu.integrate_step(j_ab, jnp.asarray(acc[i]),
                                   jnp.asarray(gyr[i]), jnp.asarray(dts[i]),
                                   NOISE, WALK)
    np.testing.assert_allclose(n(s_ab.dP), n(full.dP), atol=1e-5)
    np.testing.assert_allclose(n(s_ab.dR), n(full.dR), atol=1e-6)
    _assert_state_close(j_ab, s_ab)


def test_split_interval():
    stamps = np.array([0.0, 0.01, 0.02, 0.03, 0.04], np.float32)
    out = n(timu.split_interval(0.005, 0.035, t(stamps)))
    ref = n(jimu.split_interval(0.005, 0.035, jnp.asarray(stamps)))
    np.testing.assert_allclose(out, [0.005, 0.01, 0.01, 0.005], atol=1e-7)
    np.testing.assert_allclose(out, ref, atol=1e-9)


def test_batched_windows_equal_single_ones(rng):
    """Every function takes leading batch dimensions: three windows
    integrated as one batch give each window's own state (within 1e-5
    relative: a batched matmul may sum in another order)."""
    acc, gyr, dts, _ = synth_trajectory(n_steps=40)
    A = np.stack([acc, acc * 1.1, acc[::-1].copy()])
    G = np.stack([gyr, gyr * 0.5, gyr[::-1].copy()])
    D = np.stack([dts] * 3)
    bias = rng.normal(0, 1e-2, (3, 6)).astype(np.float32)
    batch = timu.integrate(t(A), t(G), t(D), t(bias), NOISE_T, WALK_T)
    for i in range(3):
        one = timu.integrate(t(A[i]), t(G[i]), t(D[i]), t(bias[i]), NOISE_T,
                             WALK_T)
        for a, b in zip(one, batch):
            np.testing.assert_allclose(n(b[i]), n(a), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("off", [0.0, 1e-6, 1e-3])
def test_project_rotation_against_svd(rng, off):
    """The polar projection against the JAX SVD ``normalize_rotation``
    within 1e-6, on rotations and on matrices up to 1e-3 off SO(3)."""
    w = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    R = n(tlie.so3_exp(t(w))) + rng.normal(0, off, (64, 3, 3)).astype(
        np.float32)
    out = n(tlie.project_rotation(t(R)))
    ref = n(jlie.normalize_rotation(jnp.asarray(R)))
    assert np.abs(out - ref).max() <= 1e-6
    eye = np.einsum("kji,kjl->kil", out.astype(np.float64), out)
    assert np.abs(eye - np.eye(3)).max() <= 1e-6


def test_project_rotation_jvp_is_the_custom_jvp(rng):
    """Forward mode through the projection gives the JAX package's custom
    JVP (the tangent projected at the output), also under vmap; reverse
    mode the same linear map (it is self-adjoint)."""
    R = n(tlie.so3_exp(t(rng.normal(0, 1.0, (8, 3)).astype(np.float32))))
    dR = rng.normal(0, 1.0, (8, 3, 3)).astype(np.float32)
    _, ref = jax.jvp(jlie.normalize_rotation, (jnp.asarray(R),),
                     (jnp.asarray(dR),))
    _, out = torch.func.jvp(tlie.project_rotation, (t(R),), (t(dR),))
    np.testing.assert_allclose(n(out), n(ref), atol=1e-6)
    vm = torch.func.vmap(lambda r, d: torch.func.jvp(
        tlie.project_rotation, (r,), (d,))[1])(t(R), t(dR))
    np.testing.assert_allclose(n(vm), n(ref), atol=1e-6)
    Rt = t(R).requires_grad_(True)
    g = t(dR)
    (tlie.project_rotation(Rt) * g).sum().backward()
    np.testing.assert_allclose(n(Rt.grad), n(ref), atol=1e-6)


@pytest.mark.parametrize("fn", ["vee", "so3_log", "so3_right_jacobian_inv"])
def test_lie_additions(rng, fn):
    """vee, so3_log (generic angles, the Taylor region and within 1e-3 of
    pi) and the inverse right Jacobian against the JAX functions."""
    w = rng.normal(0, 1, (48, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    mags = np.concatenate([np.full(8, 1e-7), rng.uniform(1e-3, 0.5, 16),
                           rng.uniform(0.5, 3.0, 16),
                           np.pi - rng.uniform(1e-5, 5e-4, 8)])
    w = (w * mags[:, None]).astype(np.float32)
    if fn == "vee":
        x = n(jlie.skew(jnp.asarray(w)))
    elif fn == "so3_log":
        x = n(jlie.so3_exp(jnp.asarray(w)))
    else:
        x = w
    ref = n(getattr(jlie, fn)(jnp.asarray(x)))
    out = n(getattr(tlie, fn)(t(x)))
    # Near pi both divide by a float32 sine of about 1e-4.
    near_pi = (mags > np.pi - 1e-3).reshape((-1,) + (1,) * (ref.ndim - 1))
    atol = np.where(near_pi, 3e-3, 1e-6 if fn == "vee" else 2e-6)
    assert (np.abs(out - ref) <= atol).all(), np.abs(out - ref).max()


def test_so3_log_jacobian_matches_jax(rng):
    """Forward mode through so3_log(exp(x) R) at x = 0, as the inertial
    residuals are differentiated: the Jacobians agree with jax.jacfwd."""
    R = n(tlie.so3_exp(t(rng.normal(0, 0.5, 3).astype(np.float32))))

    def jf(x):
        return jlie.so3_log(jlie.so3_exp(x) @ jnp.asarray(R))

    def tf(x):
        return tlie.so3_log(tlie.so3_exp(x) @ t(R))

    ref = n(jax.jacfwd(jf)(jnp.zeros(3)))
    out = n(torch.func.jacfwd(tf)(torch.zeros(3)))
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("t_pad", [32, 8])
def test_imu_buffer_and_make_steps(t_pad):
    """The port's copies of ImuBuffer and make_steps give the JAX
    package's windows and midpoint steps exactly, padded (32 rows) or
    subsampled past the pad (8 rows)."""
    from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
    rng = np.random.default_rng(3)
    ts = 10.0 + np.arange(40) / 200.0 + 0.0025
    gyr = rng.normal(0, 0.1, (40, 3)).astype(np.float32)
    acc = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
    jb, tb = jvi.ImuBuffer(capacity=16), tvi.ImuBuffer(capacity=16)
    for b in (jb, tb):
        b.append(ts[:25], gyr[:25], acc[:25])
        b.append(ts[25:], gyr[25:], acc[25:])
    for w_j, w_t in zip(jb.window(10.03, 10.08), tb.window(10.03, 10.08)):
        np.testing.assert_array_equal(w_t, w_j)
    steps_j = jvi.make_steps(*jb.window(10.03, 10.08), 10.03, 10.08, t_pad)
    steps_t = tvi.make_steps(*tb.window(10.03, 10.08), 10.03, 10.08, t_pad)
    for a, b in zip(steps_j, steps_t):
        np.testing.assert_array_equal(b, a)
