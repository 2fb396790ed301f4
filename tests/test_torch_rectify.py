"""The port's stereo rectification (``io/rectify.py``: Bouguet's
``stereoRectify``, ``initUndistortRectifyMap`` and the remap, without
OpenCV) against OpenCV and the JAX package's ``build_rectification``.

On ``configs/EuRoC_stereo_inertial.yaml``, ``test_io.py``'s identity rig
and random radtan rigs with rotations up to 2 degrees: R1, R2, P1 and P2
within 1e-6 (relative to each matrix's largest entry) of
``cv2.stereoRectify`` (``CALIB_ZERO_DISPARITY``, ``alpha = 0``), the maps
within 1e-3 px of ``cv2.initUndistortRectifyMap``, the remap within 1e-4 of
``cv2.remap`` (float32, ``INTER_LINEAR``). The ``T_bc`` repair of the
stereo-inertial runner is stated here: the rectified camera's extrinsic
is ``T_b_c1 [R1^T | 0]``; the JAX runner's ``T_b_c1`` is off by R1.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu.io import rectify as jrectify
from orbslam3_byzyh_tpu.io import settings as jsettings
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.io import rectify, settings

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EUROC_YAML = os.path.join(REPO, "configs", "EuRoC_stereo_inertial.yaml")


def _cv2_rectify(cam1, cam2, T):
    K1, K2 = rectify.camera_matrix(cam1), rectify.camera_matrix(cam2)
    d1 = np.asarray(cam1.dist if cam1.dist is not None else np.zeros(4),
                    np.float64)
    d2 = np.asarray(cam2.dist if cam2.dist is not None else np.zeros(4),
                    np.float64)
    R12, t12 = T[:3, :3], T[:3, 3]
    size = (cam1.width, cam1.height)
    R1, R2, P1, P2, _, _, _ = cv2.stereoRectify(
        K1, d1, K2, d2, size, R12.T, (-R12.T @ t12).reshape(3, 1),
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
    maps = [cv2.initUndistortRectifyMap(K, d, R, P, size, cv2.CV_32FC1)
            for K, d, R, P in ((K1, d1, R1, P1), (K2, d2, R2, P2))]
    return (R1, R2, P1, P2), maps


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(b).max(), 1e-300))


def _check(cam1, cam2, T):
    rig = rectify.build_rectification(cam1, cam2, T)
    (R1, R2, P1, P2), maps = _cv2_rectify(cam1, cam2, T)
    for mine, ref in zip((rig.R1, rig.R2, rig.P1, rig.P2), (R1, R2, P1, P2)):
        assert _rel(mine, ref) < 1e-6, (mine, ref)
    for mine, ref in zip((rig.map1x, rig.map1y, rig.map2x, rig.map2y),
                         (maps[0][0], maps[0][1], maps[1][0], maps[1][1])):
        assert mine.dtype == np.float32
        assert np.abs(mine - ref).max() < 1e-3
    return rig


def _euroc():
    s = settings.load_settings(EUROC_YAML)
    return s.cam1, s.cam2, s.Tlr, s


def test_euroc_yaml_against_cv2_and_the_jax_rig():
    cam1, cam2, T, _ = _euroc()
    rig = _check(cam1, cam2, T)
    js = jsettings.load_settings(EUROC_YAML)
    jr = jrectify.build_rectification(js.cam1, js.cam2, js.Tlr)
    for k in ("fx", "fy", "cx", "cy", "bf"):
        assert abs(getattr(rig, k) - getattr(jr, k)) < 1e-6 * abs(
            getattr(jr, k)), k
    for k in ("map1x", "map1y", "map2x", "map2y"):
        assert np.abs(getattr(rig, k) - getattr(jr, k)).max() < 1e-3
    # The constants of the EuRoC stereo-inertial cells (graft).
    m = graft.EUROC_STEREO_INERTIAL.rig.mono
    for mine, const in ((rig.fx, m.fx), (rig.cx, m.cx), (rig.cy, m.cy),
                        (rig.bf, graft.EUROC_STEREO_INERTIAL.rig.bf)):
        assert abs(mine - const) < 1e-4, (mine, const)
    # R1 turns the left camera by 0.62 degrees.
    ang = np.degrees(np.linalg.norm(rectify.rodrigues_to_vector(rig.R1)))
    assert 0.60 < ang < 0.64, ang


def test_identity_rig():
    """test_io.py::TestRectification: a rectified rig maps to itself with
    bf = baseline * fx."""
    cam = settings.CameraSettings(
        model="PinHole",
        params=np.array([400.0, 400.0, 320.0, 240.0], np.float32),
        dist=None, width=640, height=480)
    T = np.eye(4)
    T[0, 3] = 0.2                     # cam2 is 0.2 m to the right
    rig = _check(cam, cam, T)
    assert abs(rig.bf - 0.2 * 400.0) < 1e-3, rig.bf
    gx, gy = np.meshgrid(np.arange(640), np.arange(480))
    assert np.abs(rig.map1x - gx).max() < 1.0
    assert np.abs(rig.map1y - gy).max() < 1.0
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    l_, _ = rig.rectify(img, img)
    assert np.abs(l_ - img).mean() < 2.0


def _random_rig(seed):
    rng = np.random.default_rng(seed)
    w, h = [(752, 480), (640, 480), (512, 384), (1241, 376)][seed % 4]

    def cam():
        f = rng.uniform(0.6, 0.9) * w
        d = np.array([rng.uniform(-0.3, 0.05), rng.uniform(-0.02, 0.08),
                      rng.uniform(-1e-3, 1e-3), rng.uniform(-1e-3, 1e-3),
                      0.0], np.float32)
        return settings.CameraSettings(
            "PinHole", np.array([f, f * rng.uniform(0.995, 1.005),
                                 w / 2 + rng.uniform(-10, 10),
                                 h / 2 + rng.uniform(-10, 10)], np.float32),
            d, w, h)

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = rectify.rodrigues_to_matrix(axis * np.radians(rng.uniform(0.1, 2.0)))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [rng.uniform(0.08, 0.25), rng.uniform(-0.005, 0.005),
                rng.uniform(-0.005, 0.005)]
    return cam(), cam(), T


@pytest.mark.parametrize("seed", range(8))
def test_random_radtan_rigs(seed):
    _check(*_random_rig(seed))


@pytest.mark.parametrize("seed", range(3))
def test_remap_against_cv2(seed):
    """The device remap (torch, here on CPU tensors) and the float64 plain
    remap within 1e-4 of cv2.remap on a float32 image, the zero border
    included."""
    cam1, cam2, T = (_random_rig(seed) if seed else _euroc()[:3])
    rig = rectify.build_rectification(cam1, cam2, T)
    rng = np.random.default_rng(seed)
    h, w = cam1.height, cam1.width
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img2 = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ref1 = cv2.remap(img, rig.map1x, rig.map1y, cv2.INTER_LINEAR)
    ref2 = cv2.remap(img2, rig.map2x, rig.map2y, cv2.INTER_LINEAR)
    l_, r_ = rig.rectify(torch.from_numpy(img), torch.from_numpy(img2))
    assert l_.dtype == torch.float32
    assert np.abs(l_.numpy() - ref1).max() < 1e-4
    assert np.abs(r_.numpy() - ref2).max() < 1e-4
    pl, pr = rig.rectify(img, img2)
    assert np.abs(pl - ref1).max() < 1e-4 and np.abs(pr - ref2).max() < 1e-4
    # Maps that leave the image (a shifted identity) read zeros there, as
    # cv2's constant border.
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    mx, my = gx - 3.3 + 0.2 * seed, gy + 2.7
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    assert np.abs(rectify.remap_plain(img, mx, my) - ref).max() < 1e-4
    dm = rectify.DeviceMaps(mx, my, (h, w), torch.device("cpu"))
    assert np.abs(dm(torch.from_numpy(img)).numpy() - ref).max() < 1e-4
    assert (ref[:, :2] == 0).all() and (ref[-2:] == 0).all()


def _angle_deg(R):
    return float(np.degrees(np.linalg.norm(rectify.rodrigues_to_vector(R))))


def test_tbc_repair_composition():
    """The repaired extrinsic is T_b_c1 [R1^T | 0]: a point in the
    rectified camera goes to the raw camera by R1^T, then to the body."""
    cam1, cam2, T, s = _euroc()
    rig = rectify.build_rectification(cam1, cam2, T)
    T_b_rect = rectify.rectified_body_extrinsic(s.imu.Tbc, rig.R1)
    x_rect = np.array([0.3, -0.2, 2.0])
    x_b = s.imu.Tbc[:3, :3] @ (rig.R1.T @ x_rect) + s.imu.Tbc[:3, 3]
    np.testing.assert_allclose(T_b_rect[:3, :3] @ x_rect + T_b_rect[:3, 3],
                               x_b, atol=1e-12)
    # The JAX runner's T_b_c1 is off by R1: 0.62 degrees on EuRoC.
    err = _angle_deg(T_b_rect[:3, :3].T @ np.asarray(s.imu.Tbc)[:3, :3])
    assert abs(err - _angle_deg(rig.R1)) < 1e-9 and err > 0.6


def test_tbc_repair_removes_the_extrinsic_error():
    """On the fabricated flagship rig, whose truth is known (the body is
    the raw left camera; the rectified camera is the render, turned by
    R_raw1 from it): the repaired extrinsic is the true one, the yaml's
    T_b_c1 = I is 0.41 degrees off."""
    r = graft.euroc_raw_rig()
    rig = graft.raw_rig_rectification(r)
    truth = np.eye(4)
    truth[:3, :3] = r.R_raw1                 # body <- render (rectified)
    repaired = rectify.rectified_body_extrinsic(r.T_b_c1, rig.R1)
    assert np.abs(repaired - truth).max() < 1e-12
    assert 0.40 < _angle_deg(r.T_b_c1[:3, :3].T @ truth[:3, :3]) < 0.42
    # The rectified view lies inside the render.
    assert graft.raw_rig_coverage(r, rig) > 20.0
