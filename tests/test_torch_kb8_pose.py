"""Port parity: native KB8 in the motion-only pose optimization (K3's and
K3s's plain versions with ``model_id=KB8``) and in ``triangulate_pair``,
against the JAX package's XLA path on ``test_kb8_ab.make_scene``.

Tolerances: the pose within ``POSE_TOL`` = 1e-4 of the JAX result, the
pinhole K3 parity test's (``test_torch_pose_opt.py``: float32 LM steps of
two libraries), the inlier masks equal (as that test holds them); a short
A/B study (4 trials of ``test_kb8_ab.run_ab``'s draws) trial by trial
within the same 1e-4 on both arms. ``triangulate_pair`` with ``model_id``
KB8 equals the JAX function's (which, like the port's, does not read
``model_id``: a fault of the reference kept for parity, ROADMAP section 3)
under ``test_torch_mapping.py``'s tolerances: the same matches, positions
within 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import test_kb8_ab
import torch
from scipy.spatial.transform import Rotation
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import camera as jcam
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.solver import pose_opt as jpose
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.ops import camera as tcam
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.solver import pose_opt as tpose

POSE_TOL = 1e-4
KB8 = test_kb8_ab.KB8


def _problem(seed, stereo=False, n_pts=256):
    """make_scene's points with noisy KB8 pixels, levels 0-3, 5 % gross
    outliers, a perturbed start; with ``stereo`` 40 % of the rows carry
    u_r = u - bf / z (TUM-VI's bf)."""
    rng = np.random.default_rng(seed)
    pw, pc, R, tt = test_kb8_ab.make_scene(rng, n_pts=n_pts)
    uv = np.asarray(jcam.kb8_project(jnp.asarray(KB8), jnp.asarray(pc)))
    level = rng.integers(0, 4, n_pts)
    uv = uv + rng.normal(0, 0.5, uv.shape) * (1.2 ** level)[:, None]
    out = rng.random(n_pts) < 0.05
    uv[out] += rng.uniform(20, 40, (int(out.sum()), 2))
    inv_s2 = (1.0 / 1.2 ** (2 * level)).astype(np.float32)
    valid = rng.random(n_pts) >= 0.03
    R0 = (Rotation.from_rotvec(rng.normal(0, 0.02, 3)).as_matrix()
          @ R).astype(np.float32)
    t0 = (tt + rng.normal(0, 0.05, 3)).astype(np.float32)
    args = [R0, t0, pw, uv.astype(np.float32)]
    if stereo:
        bf = graft.TUMVI_512_STEREO_INERTIAL.rig.bf
        ur = np.where(rng.random(n_pts) < 0.4,
                      uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.5, n_pts),
                      -1.0).astype(np.float32)
        args += [ur, np.float32(bf)]
    return args + [inv_s2, valid, KB8], (R, tt)


def _close(out, ref, truth):
    np.testing.assert_allclose(n(out.R), np.asarray(ref.R), atol=POSE_TOL)
    np.testing.assert_allclose(n(out.t), np.asarray(ref.t), atol=POSE_TOL)
    np.testing.assert_array_equal(n(out.inlier), np.asarray(ref.inlier))
    assert int(out.n_inliers) == int(ref.n_inliers)
    # Both solve the pose.
    assert np.linalg.norm(n(out.t) - truth[1]) < 0.02


@pytest.mark.parametrize("seed", [0, 1])
def test_mono_kb8_matches_jax(seed):
    args, truth = _problem(seed)
    ref = jpose.pose_optimization(*(jnp.asarray(a) for a in args),
                                  model_id=jcam.KB8)
    out = tpose.pose_optimization(*(t(a) for a in args),
                                  model_id=tcam.KB8)
    _close(out, ref, truth)


def test_stereo_kb8_matches_jax():
    args, truth = _problem(2, stereo=True)
    ref = jpose.pose_optimization_stereo(*(jnp.asarray(a) for a in args),
                                         model_id=jcam.KB8)
    targs = [t(a) for a in args]
    targs[5] = float(args[5])
    out = tpose.pose_optimization_stereo(*targs, model_id=tcam.KB8)
    _close(out, ref, truth)


def test_kb8_ab_trials_match_jax():
    """``graft.kb8_ab_study`` (the port's A/B) against run_ab's loop on the
    JAX functions, trial by trial from the same seed (the port's camera is
    the JAX test's to 8 digits)."""
    rng = np.random.default_rng(42)
    kb8_j, pin_j = jnp.asarray(KB8), jnp.asarray(KB8[:4])
    ref = []
    for _ in range(4):
        pw, pc, R, tt = test_kb8_ab.make_scene(rng)
        uv = np.asarray(jcam.kb8_project(kb8_j, jnp.asarray(pc)))
        uv = uv + rng.normal(0, 0.5, uv.shape)
        ray = jcam.kb8_unproject(kb8_j, jnp.asarray(uv, jnp.float32))
        uv_rect = jcam.pinhole_project(pin_j, ray)
        R0 = Rotation.from_rotvec(rng.normal(0, 0.02, 3)).as_matrix() @ R
        t0 = tt + rng.normal(0, 0.05, 3)
        valid, w = jnp.ones(pw.shape[0], bool), jnp.ones(pw.shape[0])
        common = (jnp.asarray(R0.astype(np.float32)),
                  jnp.asarray(t0.astype(np.float32)), jnp.asarray(pw))
        a = jpose.pose_optimization(*common, uv_rect, w, valid, pin_j,
                                    model_id=jcam.PINHOLE)
        b = jpose.pose_optimization(*common, jnp.asarray(uv, jnp.float32),
                                    w, valid, kb8_j, model_id=jcam.KB8)
        ref.append((np.asarray(a.t), np.asarray(b.t)))
    out = graft.kb8_ab_study(np.random.default_rng(42), n_trials=4,
                             device="cpu")
    for i, (ta, tb) in enumerate(ref):
        np.testing.assert_allclose(out["t_rect"][i], ta, atol=POSE_TOL,
                                   err_msg=f"trial {i} rectified")
        np.testing.assert_allclose(out["t_native"][i], tb, atol=POSE_TOL,
                                   err_msg=f"trial {i} native")
    # The port's study camera is the yaml's TUM-VI 512 calibration, the
    # test's to 8 digits.
    np.testing.assert_allclose(graft.TUMVI_KB8_PARAMS, KB8, rtol=1e-7)


def test_kb8_ab_gates():
    g = graft.kb8_ab_gates(dict(med_rect=0.004, med_native=0.003),
                           dict(med_rect=0.0021, med_native=0.002))
    assert g["ok"]
    assert not graft.kb8_ab_gates(dict(med_rect=0.004, med_native=0.03),
                                  dict(med_rect=0.002, med_native=0.002))["ok"]


def _pair_scene(seed, n_pts=300):
    """Two keyframes 0.3 m apart seeing the same points within 35 degrees
    of the axis through TUM-VI's KB8 camera; keyframe b's descriptors are
    a's with 0-3 bits flipped; levels 0-2."""
    rng = np.random.default_rng(seed)
    pw, _, _, _ = test_kb8_ab.make_scene(rng, n_pts=n_pts, max_angle_deg=35.0)
    Ra = np.eye(3, dtype=np.float32)
    ta = np.zeros(3, np.float32)
    Rb = Rotation.from_rotvec([0.0, 0.03, 0.0]).as_matrix().astype(np.float32)
    tb = np.array([-0.3, 0.0, 0.02], np.float32)
    xy = []
    for R, tt in ((Ra, ta), (Rb, tb)):
        pc = pw @ R.T + tt
        xy.append(np.asarray(jcam.kb8_project(jnp.asarray(KB8),
                                              jnp.asarray(pc))).astype(
            np.float32) + rng.normal(0, 0.3, (n_pts, 2)).astype(np.float32))
    desc_a = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    desc_b = desc_a.copy()
    for i in range(n_pts):
        for _ in range(rng.integers(0, 4)):
            w, bit = rng.integers(0, 8), rng.integers(0, 32)
            desc_b[i, w] ^= np.uint32(1 << int(bit))
    perm = rng.permutation(n_pts)
    level = rng.integers(0, 3, n_pts).astype(np.int32)
    free = np.ones(n_pts, bool)
    return (Ra, ta, xy[0], level, desc_a, free, Rb, tb, xy[1][perm],
            level[perm], desc_b[perm], free, KB8)


def test_triangulate_pair_kb8_matches_jax():
    args = _pair_scene(0)
    rj = jmap.triangulate_pair(*(jnp.asarray(a) for a in args),
                               model_id=jcam.KB8)
    rt = tmap.triangulate_pair(*(t(a) for a in args), model_id=tcam.KB8)
    np.testing.assert_array_equal(n(rt.kp_b), np.asarray(rj.kp_b))
    np.testing.assert_array_equal(n(rt.good), np.asarray(rj.good))
    good = np.asarray(rj.good)
    assert good.sum() >= 20
    np.testing.assert_allclose(n(rt.pos)[good], np.asarray(rj.pos)[good],
                               rtol=1e-4, atol=1e-6)
    # model_id is not read: the pinhole call is the same computation.
    rp = tmap.triangulate_pair(*(t(a) for a in args), model_id=tcam.PINHOLE)
    for a, b in zip(rp, rt):
        assert torch.equal(a, b)
