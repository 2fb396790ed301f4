"""Port parity: the lie subset and the pinhole camera against the JAX package.

Tolerance 1e-6 relative (with a 1e-7 floor for entries near zero): both
sides are float32 with the same formulas; sin/cos/sqrt and the SVD may
differ in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import camera as jcam
from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu_torch.ops import camera as tcam
from orbslam3_byzyh_tpu_torch.ops import lie as tlie

RTOL, ATOL = 1e-6, 1e-7


def _tangents(rng, k=64):
    """Rotation vectors spanning the Taylor branch, small and large angles."""
    w = rng.normal(0, 1, (k, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    mags = np.concatenate([np.full(8, 1e-7), np.full(8, 3e-6),
                           rng.uniform(1e-3, 0.1, 24), rng.uniform(0.5, 3.0, 24)])
    return (w * mags[:, None]).astype(np.float32)


@pytest.mark.parametrize("fn", ["skew", "so3_exp", "so3_right_jacobian"])
def test_so3_functions(rng, fn):
    w = _tangents(rng)
    ref = n(getattr(jlie, fn)(jnp.asarray(w)))
    out = n(getattr(tlie, fn)(t(w)))
    # Between the Taylor branch and ~0.5 rad, (1 - cos th) / th^2 cancels:
    # one ulp of cos (6e-8) moves the coefficient of W by 6e-8 / th^2, i.e.
    # an entry by ~6e-8 / th, in both packages alike. The floor says so.
    th = np.linalg.norm(w.astype(np.float64), axis=1)[:, None, None]
    atol = ATOL + 2e-7 / th if fn == "so3_right_jacobian" else ATOL
    assert np.all(np.abs(out - ref) <= atol + RTOL * np.abs(ref))


def test_se3_exp(rng):
    xi = np.concatenate([rng.normal(0, 0.5, (64, 3)).astype(np.float32),
                         _tangents(rng)], 1)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(t(xi))
    np.testing.assert_allclose(n(Rt), n(Rj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(tt), n(tj), rtol=RTOL, atol=ATOL)


def test_normalize_rotation(rng):
    R = n(jlie.so3_exp(jnp.asarray(_tangents(rng))))
    R = (R + rng.normal(0, 1e-4, R.shape)).astype(np.float32)   # off SO(3)
    ref = n(jlie.normalize_rotation(jnp.asarray(R)))
    out = n(tlie.normalize_rotation(t(R)))
    # The polar factor is unique, but two SVD algorithms reach it through
    # different rounding: 1e-6 absolute on unit-size entries.
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)


def _points(rng, k=200):
    return np.stack([rng.uniform(-4, 4, k), rng.uniform(-3, 3, k),
                     rng.uniform(0.5, 20, k)], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["project", "project_jac"])
def test_pinhole(rng, fn):
    pc = _points(rng)
    params = np.array([420.0, 415.0, 320.0, 240.0], np.float32)
    ref = getattr(jcam, fn)(jcam.PINHOLE, jnp.asarray(params), jnp.asarray(pc))
    out = getattr(tcam, fn)(tcam.PINHOLE, t(params), t(pc))
    np.testing.assert_allclose(n(out), n(ref), rtol=RTOL, atol=ATOL)


def test_kb8_not_ported():
    """The Kannala-Brandt model is ported now: ``project`` dispatches KB8
    (tests/test_torch_kb8.py holds it against the JAX package); a point on
    the axis lands on the principal point."""
    params = torch.tensor([190.0, 190.0, 255.0, 256.0, 3e-3, 7e-4, -2e-3,
                           2e-4])
    out = tcam.project(tcam.KB8, params, torch.tensor([0.0, 0.0, 2.0]))
    assert torch.equal(out, params[2:4])
    ref = jcam.project(jcam.KB8, jnp.asarray(n(params)),
                       jnp.asarray([[0.3, -0.2, 1.5]], np.float32))
    got = tcam.project(tcam.KB8, params, torch.tensor([[0.3, -0.2, 1.5]]))
    np.testing.assert_allclose(n(got), n(ref), rtol=RTOL, atol=1e-4)


EUROC_CAM = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
EUROC_DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                      np.float32)
DIST_K3 = np.array([-0.2, 0.05, 1e-3, -5e-4, 0.01], np.float32)


def _pixels(rng, k=400):
    """EuRoC-sized frame, corners included."""
    uv = np.stack([rng.uniform(0, 752, k), rng.uniform(0, 480, k)], -1)
    uv[:4] = [[0, 0], [751, 0], [0, 479], [751, 479]]
    return uv.astype(np.float32)


def test_pinhole_unproject(rng):
    uv = _pixels(rng)
    ref = jcam.pinhole_unproject(jnp.asarray(EUROC_CAM), jnp.asarray(uv))
    out = tcam.pinhole_unproject(t(EUROC_CAM), t(uv))
    np.testing.assert_allclose(n(out), n(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dist", [EUROC_DIST, DIST_K3], ids=["euroc", "k3"])
def test_radtan_distort_undistort(rng, dist):
    xy = (_pixels(rng) - EUROC_CAM[2:]) / EUROC_CAM[:2]
    ref = n(jcam.radtan_distort(jnp.asarray(dist), jnp.asarray(xy)))
    np.testing.assert_allclose(n(tcam.radtan_distort(t(dist), t(xy))), ref,
                               rtol=RTOL, atol=ATOL)
    ref = n(jcam.radtan_undistort(jnp.asarray(dist), jnp.asarray(xy)))
    out = n(tcam.radtan_undistort(t(dist), t(xy)))
    # Eight fixed-point iterations, the same float32 operations in the same
    # order; XLA may still fuse differently, so a few ulps of the normalized
    # coordinates (~1e-6 px at fx 458).
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-6)


def test_undistort_pixels_euroc(rng):
    """The front-end's undistortion on EuRoC's coefficients: within 1e-5 px
    of the JAX package, and a fixed point of the distortion near the
    centre."""
    uv = _pixels(rng)
    ref = n(jcam.undistort_pixels(jnp.asarray(EUROC_CAM),
                                  jnp.asarray(EUROC_DIST), jnp.asarray(uv)))
    out = n(tcam.undistort_pixels(t(EUROC_CAM), t(EUROC_DIST), t(uv)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    back = n(tcam.radtan_distort(
        t(EUROC_DIST), (t(out) - t(EUROC_CAM[2:])) / t(EUROC_CAM[:2])))
    back = back * EUROC_CAM[:2] + EUROC_CAM[2:]
    centre = np.linalg.norm(uv - EUROC_CAM[2:], axis=1) < 200
    np.testing.assert_allclose(back[centre], uv[centre], atol=0.05)
