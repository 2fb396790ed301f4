"""Port parity: the Kannala-Brandt 8 camera (``ops/camera.py``), the KB8
rectification at extraction (``graft.mono_extract(kb8=...)``), a KB8
bundle adjustment and ``graft.kb8_warp``, against the JAX package and
independent checks.

Tolerances: projections within 1e-3 px of the JAX package's and of
``cv2.fisheye.projectPoints``; unprojected rays within 2e-6 of the JAX
package's and round trips within 2e-4 (1e-3 out to 83 degrees, as
test_camera.py's TestKB8); Jacobians within rtol 1e-4 of the JAX
package's and of ``torch.func.jacfwd``; rectified keypoints within 1e-3 px
of the JAX ``MonoSlam._extract``'s; the BA as test_torch_ba.py holds the
pinhole one (poses 1e-4, points 1e-3, the inlier mask equal).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import test_ba
import test_camera
import torch
from test_torch_ba import _perturb
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import camera as jcam
from orbslam3_byzyh_tpu.ops import fast_orb as jfo
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu.solver import ba as jba
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.ops import camera as tcam
from orbslam3_byzyh_tpu_torch.solver import ba as tba

TUMVI_KB8 = test_camera.TUMVI_KB8
# The world's focal length on TUM-VI's coefficients (the port's cells).
WORLD_KB8 = np.array(graft.TUMVI_WORLD_CAM + graft.TUMVI_KB8_1, np.float32)


def _cone(rng, k=128, fov=1.2):
    return test_camera.random_cam_points(rng, n=k, fov_limit=fov)


def _wide(rng, k=64):
    """Points out to 83 degrees off the axis (test_camera.py:107-120)."""
    theta = rng.uniform(0.3, 1.45, size=k)
    psi = rng.uniform(0, 2 * np.pi, size=k)
    d = rng.uniform(1.0, 5.0, size=k)
    return np.stack([d * np.sin(theta) * np.cos(psi),
                     d * np.sin(theta) * np.sin(psi),
                     d * np.cos(theta)], -1).astype(np.float32)


def _points(rng):
    """A cone, the wide-angle set and two points on the axis (the guards'
    branch)."""
    axis = np.array([[0.0, 0.0, 2.0], [1e-12, 0.0, 3.0]], np.float32)
    return np.concatenate([_cone(rng), _wide(rng), axis])


@pytest.mark.parametrize("params", [TUMVI_KB8, WORLD_KB8])
def test_kb8_project_matches_jax(rng, params):
    pc = _points(rng)
    ref = n(jcam.kb8_project(jnp.asarray(params), jnp.asarray(pc)))
    out = n(tcam.kb8_project(t(params), t(pc)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out[-2:], np.broadcast_to(params[2:4],
                                                            (2, 2)))


def test_kb8_project_matches_opencv_fisheye(rng):
    pc = _cone(rng, 64)
    out = n(tcam.kb8_project(t(TUMVI_KB8), t(pc)))
    fx, fy, cx, cy = TUMVI_KB8[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    cv_out, _ = cv2.fisheye.projectPoints(
        pc[:, None, :].astype(np.float64), np.zeros(3), np.zeros(3), K,
        TUMVI_KB8[4:].astype(np.float64))
    np.testing.assert_allclose(out, cv_out[:, 0, :], atol=1e-3)


@pytest.mark.parametrize("params", [TUMVI_KB8, WORLD_KB8])
def test_kb8_unproject_matches_jax_and_round_trips(rng, params):
    pc = np.concatenate([_cone(rng), _wide(rng)])
    uv = jcam.kb8_project(jnp.asarray(params), jnp.asarray(pc))
    ref = n(jcam.kb8_unproject(jnp.asarray(params), uv))
    out = n(tcam.kb8_unproject(t(params), t(n(uv))))
    # The same float32 Newton steps; tan amplifies an ulp of theta near
    # 83 degrees, so the tolerance is relative there.
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)
    k = 128
    np.testing.assert_allclose(out[:k], pc[:k] / pc[:k, 2:3], atol=2e-4)
    np.testing.assert_allclose(out[k:], pc[k:] / pc[k:, 2:3], rtol=1e-3,
                               atol=1e-3)
    # The principal point unprojects to the axis; r_d is clamped at pi / 2.
    centre = t(params[None, 2:4])
    np.testing.assert_array_equal(n(tcam.kb8_unproject(t(params), centre)),
                                  [[0.0, 0.0, 1.0]])
    far = np.array([[params[2] + 4.0 * params[0], params[3]]], np.float32)
    np.testing.assert_allclose(n(tcam.kb8_unproject(t(params), t(far))),
                               n(jcam.kb8_unproject(jnp.asarray(params),
                                                    jnp.asarray(far))),
                               rtol=1e-5)


def test_kb8_project_jac_matches_jax_and_jacfwd(rng):
    pc = np.concatenate([_cone(rng, 32, 1.0), _wide(rng, 32)])
    params = t(TUMVI_KB8)
    ref = n(jcam.kb8_project_jac(jnp.asarray(TUMVI_KB8), jnp.asarray(pc)))
    out = n(tcam.kb8_project_jac(params, t(pc)))
    # rtol 1e-4 of each entry, floored at 1e-4 of its Jacobian's largest.
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)

    def close(a, b):
        assert np.all(np.abs(a - b) <= 1e-4 * (np.abs(b) + scale)), \
            np.abs(a - b).max()

    close(out, ref)
    ad = torch.func.vmap(torch.func.jacfwd(
        lambda p: tcam.kb8_project(params, p)))(t(pc))
    close(out, n(ad))


@pytest.mark.parametrize("fn", ["project", "unproject", "project_jac"])
def test_dispatchers(rng, fn):
    pin = np.array([420.0, 415.0, 320.0, 240.0], np.float32)
    pc = _cone(rng, 64)
    x = pc if fn != "unproject" else n(jcam.kb8_project(
        jnp.asarray(TUMVI_KB8), jnp.asarray(pc)))
    for model, params in ((tcam.PINHOLE, pin), (tcam.KB8, TUMVI_KB8)):
        out = n(getattr(tcam, fn)(model, t(params), t(x)))
        own = {tcam.PINHOLE: "pinhole_", tcam.KB8: "kb8_"}[model] + fn
        np.testing.assert_array_equal(out, n(getattr(tcam, own)(t(params),
                                                                t(x))))
        ref = n(getattr(jcam, fn)(model, jnp.asarray(params),
                                  jnp.asarray(x)))
        np.testing.assert_allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def warped_frame():
    """Golden frame 0 seen through the world-focal TUM-VI KB8 camera at
    512x512 (the port's TUM-VI cells' camera)."""
    g = graft.golden_frames()
    return graft.kb8_warp(g.frames[0], g.camera[:4], WORLD_KB8, (512, 512))


def test_mono_extract_kb8_matches_jax_extract(warped_frame):
    """The port's extraction with KB8 rectification against the JAX
    ``MonoSlam._extract`` on the same frame: matched by raw keypoint
    (>= 97 % of the JAX package's valid keypoints, as
    test_torch_fast_orb.py), the rectified keypoints within 1e-3 px."""
    cam4, kb8 = WORLD_KB8[:4], WORLD_KB8[4:]
    cfg = jsys.SlamConfig(fx=float(cam4[0]), fy=float(cam4[1]),
                          cx=float(cam4[2]), cy=float(cam4[3]), width=512,
                          height=512, kb8=kb8, n_features=1000, max_kf=8,
                          max_lm=256, device_mesh=False,
                          use_loop_closing=False)
    jslam = jsys.MonoSlam(cfg)
    ref = jslam._extract(warped_frame)
    raw = jfo.extract(jnp.asarray(warped_frame, jnp.float32),
                      n_features=1000)
    mcfg = graft.MonoConfig(width=512, height=512, fx=float(cam4[0]),
                            fy=float(cam4[1]), cx=float(cam4[2]),
                            cy=float(cam4[3]), dist=None, n_features=1000)
    img = t(warped_frame.astype(np.float32))
    port_raw = graft.mono_extract(img, t(cam4), None, mcfg)
    out = graft.mono_extract(img, t(cam4), None, mcfg, kb8=t(kb8))
    np.testing.assert_array_equal(n(out.desc), n(port_raw.desc))
    key = {(float(x), float(y), int(lv)): i for i, ((x, y), lv, v) in
           enumerate(zip(n(raw.xy), n(raw.level), n(raw.valid))) if v}
    pairs = [(key[k], i) for i, k in enumerate(
        (float(x), float(y), int(lv)) for (x, y), lv in
        zip(n(port_raw.xy), n(port_raw.level)))
        if n(out.valid)[i] and k in key]
    assert len(pairs) >= 0.97 * n(raw.valid).sum()
    j, i = np.array(pairs).T
    np.testing.assert_allclose(n(out.xy)[i], n(ref.xy)[j], rtol=0, atol=1e-3)
    # Rectification moved the keypoints off the raw ones (away from the
    # centre), so the comparison is not of unrectified points.
    assert np.abs(n(out.xy)[i] - n(port_raw.xy)[i]).max() > 10.0


def _kb8_problem(rng):
    """test_ba.py's refine case observed through a KB8 camera: the points,
    poses and visibility of ``synth_ba``, the observations re-projected
    with the JAX package's ``kb8_project`` (0.5 px noise), then perturbed
    as test_torch_ba.py perturbs them."""
    X, Rs, ts, okf, _, oval = test_ba.synth_ba(rng)
    params = np.array([300.0, 300.0, 376.0, 240.0, *TUMVI_KB8[4:]],
                      np.float32)
    pc = np.einsum("kij,lj->lki", Rs, X) + ts[None]          # (L, K, 3)
    uv_all = n(jcam.kb8_project(jnp.asarray(params),
                                jnp.asarray(pc.astype(np.float32))))
    ouv = np.take_along_axis(uv_all, np.clip(okf, 0, None)[..., None], 1)
    ouv = (ouv + rng.normal(0, 0.5, ouv.shape)).astype(np.float32)
    Xp, Rp, tp = _perturb(rng, X, Rs, ts)
    fixed = np.zeros(len(Rs), bool)
    fixed[:2] = True
    jp = test_ba.make_problem(Xp, Rp, tp, okf, ouv, oval, fixed)._replace(
        cam_params=jnp.asarray(params))
    tp_ = tba.BAProblem(*(t(np.asarray(a)) if a is not None else None
                          for a in jp))
    return jp, tp_, (X, Rs, ts)


def test_bundle_adjust_kb8_matches_jax(rng):
    jp, tp, (X, Rs, ts) = _kb8_problem(rng)
    ref = jba.bundle_adjust(jp, model_id=jcam.KB8)
    got = tba.bundle_adjust(tp, model_id=tcam.KB8)
    np.testing.assert_allclose(n(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(got.t), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(n(got.points), np.asarray(ref.points),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(n(got.obs_inlier),
                                  np.asarray(ref.obs_inlier))
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    # And it refines: the free poses move towards the truth.
    err0 = np.abs(np.asarray(jp.t)[2:] - ts[2:]).max()
    assert np.abs(n(got.t)[2:] - ts[2:]).max() < 0.5 * err0


def test_kb8_warp_puts_points_where_kb8_project_does(rng):
    """An independent check of the warp: dots drawn in a pinhole render at
    the pinhole projections of known points land, in the warped image, at
    the KB8 projections of the same points (intensity-weighted centroids
    within 0.1 px); outside the render the warp paints the background."""
    pin = np.array([400.0, 400.0, 320.0, 240.0])
    h, w = 480, 640
    gx, gy = np.meshgrid(np.linspace(-0.6, 0.6, 4), np.linspace(-0.4, 0.4, 3))
    jitter = rng.uniform(-0.03, 0.03, (12, 2))
    pts = np.stack([gx.ravel() + jitter[:, 0], gy.ravel() + jitter[:, 1],
                    np.ones(12)], -1) * rng.uniform(2, 6, (12, 1))
    uv_pin = pts[:, :2] / pts[:, 2:] * pin[:2] + pin[2:]
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w))
    for u, v in uv_pin:
        img += 200.0 * np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / 8.0)
    img = np.clip(img, 0, 255)
    out = graft.kb8_warp(img, pin, WORLD_KB8, (512, 512), background=0)
    uv_kb8 = n(tcam.kb8_project(t(WORLD_KB8), t(pts.astype(np.float32))))
    oy, ox = np.mgrid[0:512, 0:512]
    for u, v in uv_kb8:
        win = (np.abs(ox - u) <= 6) & (np.abs(oy - v) <= 6)
        wgt = out * win
        c = np.array([(wgt * ox).sum(), (wgt * oy).sum()]) / wgt.sum()
        np.testing.assert_allclose(c, [u, v], atol=0.1)
    # Rows of the 512-row fisheye image beyond the render's 480 rows.
    band = graft.kb8_warp(np.full((h, w), 200.0), pin, WORLD_KB8,
                          (512, 512), background=30)
    assert (band[:20] == 30).all() and (band[-20:] == 30).all()
    assert (band[256, 100:400] == 200).all()
