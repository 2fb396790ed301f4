"""Port parity: the three stereo-inertial entry points of ``graft`` against
the JAX system's own methods, at a small capacity on the CPU.

* ``vi_frame_step`` against ``StereoInertialSlam._track_inertial``, in the
  three cases of ``graft.euroc_vi_scene`` (no prior, a carried prior, the
  fallback to the IMU prediction);
* ``vi_keyframe_step`` and ``vi_initialize``: tests/test_torch_vi_map_step.py.

Each JAX system's state is set from the same numpy arrays the port gets.
The frame's features, right-image u and depths come from the port's
``stereo_extract`` and are given to both (the JAX stereo match's median
fault stays out of the comparison; ROADMAP section 3).

Tolerances: the frame step's inliers and bindings equal, its pose within
1e-5, velocity and biases within 2e-4, H_marg within 1e-4 of its largest
entry (as tests/test_torch_pose_inertial.py; 1e-3 with the carried prior,
whose Schur complement cancels about three digits of 1.4e7-sized
entries). The gates against the truth are chip_smoke.py phase 12's, but
for the fallback case's inliers (0.6 of the features here: at this size
the 512-row local window leaves out more of the frame's landmarks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.ops import fast_orb as jfo
from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu.pipeline.stereo_inertial import StereoInertialSlam
from orbslam3_byzyh_tpu.pipeline.stereo_system import StereoConfig
from orbslam3_byzyh_tpu_torch import graft

# EuRoC stereo-inertial at half the image: the rectified intrinsics and bf
# halved (the same 6.6 m close-point depth), 256 features, 64 keyframe,
# 2048 landmark and 12 observation slots, a 512-landmark local window; the
# VI-BA windows cut to 12 keyframes (5 free) and 256 landmarks, the full
# VI-BA to 16 keyframes.
SMALL = graft.EUROC_STEREO_INERTIAL._replace(
    rig=graft.RigConfig(
        mono=graft.MonoConfig(width=376, height=240, fx=218.12215,
                              fy=218.12215, cx=182.2206, cy=128.47585,
                              dist=None, n_features=256, max_kf=64,
                              max_lm=2048, n_local_lm=512),
        bf=24.0104, th_depth=60.0),
    viba_window=12, viba_free=5, viba_landmarks=256, full_viba_kf=16)


def _jax_system(cfg=SMALL, mono: bool = False):
    m = cfg.rig.mono
    kw = dict(fx=m.fx, fy=m.fy, cx=m.cx, cy=m.cy, width=m.width,
              height=m.height, n_features=m.n_features, max_kf=m.max_kf,
              max_lm=m.max_lm, max_obs=m.max_obs,
              local_kf_window=m.n_local_kf, local_lm_window=m.n_local_lm,
              recent_kf_window=m.recent_kf, kf_ref_min_obs=m.kf_ref_min_obs,
              fps=20)
    imu_cfg = jvi.ImuConfig(T_bc=cfg.imu.T_bc, gyro_noise=cfg.imu.gyro_noise,
                            acc_noise=cfg.imu.acc_noise,
                            gyro_walk=cfg.imu.gyro_walk,
                            acc_walk=cfg.imu.acc_walk, freq=cfg.imu.freq)
    vw = dict(viba_window=cfg.viba_window, viba_free=cfg.viba_free,
              viba_landmarks=cfg.viba_landmarks,
              full_viba_kf=cfg.full_viba_kf)
    if mono:
        return jvi.MonoInertialSlam(jsys.SlamConfig(**kw), imu_cfg, **vw)
    return StereoInertialSlam(
        StereoConfig(bf=cfg.rig.bf, th_depth=cfg.rig.th_depth, **kw),
        imu_cfg, **vw)


@pytest.fixture(scope="module")
def frame():
    """The small pair's features, u_r and depths (the port's extraction)."""
    ctx = graft.vi_context(SMALL, "cpu")
    left, right = (t(a) for a in graft.euroc_vi_pair(SMALL))
    f, _, m = graft.stereo_extract(left, right, ctx.cam_params, None,
                                   SMALL.rig)
    return f, m, ctx


def _jax_feats(xy, level, desc, angle, valid):
    nf = len(valid)
    return jfo.FrameFeatures(
        xy=jnp.asarray(xy), level=jnp.asarray(level),
        angle=jnp.asarray(angle), response=jnp.zeros(nf),
        desc=jnp.asarray(np.asarray(desc).view(np.uint32)),
        valid=jnp.asarray(valid))


@pytest.mark.parametrize("case", ["keyframe", "prior", "fallback"])
def test_vi_frame_step(frame, case):
    f, m, ctx = frame
    feats = [n(a) for a in (f.xy, f.level, f.desc, f.angle, f.valid)]
    s = graft.euroc_vi_scene(*feats, n(m.depth), case=case, cfg=SMALL)
    res, f2, m2 = graft.vi_frame_step(graft.vi_frame_args(s, "cpu"), ctx,
                                      SMALL)
    assert torch.equal(f2.desc, f.desc) and torch.equal(m2.u_right,
                                                        m.u_right)

    sc = s.scene
    js = _jax_system()
    mc = SMALL.rig.mono
    empty = jms.empty_map(mc.max_kf, mc.max_lm, mc.max_obs, mc.n_features)
    n_obs = sc.obs_valid.sum(-1).astype(np.int32)
    js.state = empty._replace(
        lms=jms.Landmarks(
            pos=jnp.asarray(sc.lm_pos), desc=jnp.asarray(sc.lm_desc),
            normal=jnp.asarray(sc.lm_normal),
            min_dist=jnp.asarray(sc.lm_min_d),
            max_dist=jnp.asarray(sc.lm_max_d), n_obs=jnp.asarray(n_obs),
            n_found=jnp.asarray(sc.n_found),
            n_visible=jnp.asarray(sc.n_visible),
            first_kf=jnp.zeros_like(jnp.asarray(n_obs)),
            valid=jnp.asarray(sc.lm_valid)),
        obs=jms.Observations(kf=jnp.asarray(sc.obs_kf),
                             kp=jnp.zeros_like(jnp.asarray(sc.obs_kf)),
                             valid=jnp.asarray(sc.obs_valid)))
    js.n_kf = int(sc.n_kf)
    js.last_kf_id = int(sc.ref_kf)
    js.status = jsys.OK
    js.imu_ready = True
    js.localization_only = True      # no keyframe decision after the read
    js._last = dict(feats=_jax_feats(feats[0], feats[1], sc.last_desc,
                                     sc.last_angle, feats[4]),
                    bindings=jnp.asarray(sc.last_bind), R=None, t=None,
                    stamp=s.t0)
    js._body = tuple(jnp.asarray(a) for a in s.body)
    js._bias = s.bias.copy()
    js._pose_prior_H = None if s.prior_H is None else jnp.asarray(s.prior_H)
    js._last_stamp = s.t0
    js.buf.append(*s.imu)
    js._depth = jnp.asarray(n(m.depth))
    js._ur = jnp.asarray(n(m.u_right))
    pose = js._track_inertial(_jax_feats(*feats), s.t1)

    info = res.info
    pr = res.pose_inertial
    np.testing.assert_allclose(info[2:11].reshape(3, 3), pose[0], atol=1e-5)
    np.testing.assert_allclose(info[11:14], pose[1], atol=1e-5)
    np.testing.assert_array_equal(n(res.bindings),
                                  np.asarray(js._last["bindings"]))
    assert int(info[0]) == int((np.asarray(js._last["bindings"]) >= 0).sum())
    for a, b, tol in ((pr.R, js._body[0], 1e-5), (pr.p, js._body[1], 1e-5),
                      (pr.v, js._body[2], 2e-4)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=tol)
    np.testing.assert_allclose(info[14:20], js._bias, atol=2e-4)
    Hj = np.asarray(js._pose_prior_H)
    h_tol = 1e-3 if case == "prior" else 1e-4
    assert np.abs(n(pr.H_marg) - Hj).max() <= h_tol * np.abs(Hj).max()
    assert tuple(int(x) for x in info[20:22]) == js._close_counts
    np.testing.assert_array_equal(n(res.n_found),
                                  np.asarray(js.state.lms.n_found))
    # The gates against the truth.
    share = 0.6 if case == "fallback" else 0.75
    assert int(info[0]) >= share * int(f.valid.sum())
    assert np.abs(info[2:11].reshape(3, 3) - np.eye(3)).max() <= 2e-3
    assert np.linalg.norm(info[11:14]) <= 1e-2
    # The velocity nearer the truth than the IMU prediction it starts from,
    # with the prior by most of the way (its last velocity 0.05 m/s off).
    v_err = np.linalg.norm(n(pr.v) - s.v_true)
    vp_err = np.linalg.norm(n(res.v_pred) - s.v_true)
    assert v_err <= 0.015 and v_err < vp_err
    assert case != "prior" or v_err <= 0.25 * vp_err
    assert np.abs(info[14:20] - np.asarray(graft.VI_BIAS)).max() <= 1e-4
    assert bool(res.used_prediction) == (case == "fallback")
