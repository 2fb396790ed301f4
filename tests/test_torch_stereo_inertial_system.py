"""Port parity: the stereo-inertial system
(``pipeline/stereo_inertial.StereoInertialSlam``) against the JAX
package's, frame by frame.

A short ``SynthWorld(seed=11, motion="excited")`` rectified sequence
rendered here at 320x240 (fx = fy = 200, baseline 0.2 m, so bf = 40; 1024
features) with its 200 Hz IMU (the noise from ``default_rng(5)``) goes
through both systems with the same configuration, VI-BA 12 / 6 / 1024 /
32. As in tests/test_torch_stereo_system.py both get the port's features
and the port takes the JAX system's right-image u and depths (the JAX
stereo match's median fault stays out of the comparison). Both systems get
the IMU-init gates lowered to 4 chain keyframes and 0.8 s (the stereo
system's own, 10 keyframes and 1 s, put the init past a run short enough
for the CPU).

Each frame starts from the JAX system's state
(``convert.carry_inertial_state`` over test_torch_system.py's carry); on a
keyframe frame the port takes the JAX map, velocities and biases after the
bundle and the local BA, as tests/test_torch_mono_inertial_system.py
explains. Each frame must agree within that file's tolerances, with the
stereo close-point counts equal.
"""

import copy
import functools

import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_mono_inertial_system import (CAM, INIT_GATES, VIBA,
                                             KeyframeWork, assert_same_vi,
                                             imu_batches, imu_cfgs,
                                             snapshot_vi, sync_vi)
from test_torch_system import _feats_np, _pose
from torch_port_util import jax_feats

from orbslam3_byzyh_tpu.pipeline import stereo_inertial as jsi
from orbslam3_byzyh_tpu.pipeline import stereo_system as jst
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import stereo as tstereo
from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial as tsi
from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tst
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

W, H, F, B = 320, 240, 200.0, 0.2
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=16, max_lm=2048, max_obs=8, fps=10,
           kf_ref_min_obs=3, local_window=2, ba_window=6,
           local_lm_window=512, ba_lm_window=512, bf=B * F, th_depth=35.0,
           min_init_depth_points=100, min_init_landmarks=50)
STAMPS = np.round(np.arange(0.0, 2.0, 0.1), 3)
BLANK = (14,)


def _render(world, t):
    """The left and right images at t (the right camera 0.2 m along x)."""
    R, tt = world.pose(t)
    wr = copy.copy(world)
    wr.pose = lambda _t: (R, tt - np.array([B, 0, 0], np.float32))
    return world.render(t), wr.render(t)


def _pair():
    ji, ti = imu_cfgs()
    js = jsi.StereoInertialSlam(jst.StereoConfig(
        **CFG, use_loop_closing=False, background_gba=False,
        device_mesh=False), ji, **VIBA)
    ts = tsi.StereoInertialSlam(tst.StereoConfig(**CFG), ti, **VIBA,
                                device="cpu")
    for slam in (js, ts):
        for k, v in INIT_GATES.items():
            setattr(slam, k, v)
    return js, ts


@functools.cache
def _run():
    world = SynthWorld(seed=11, w=W, h=H, fx=F, fy=F, motion="excited")
    imus = imu_batches(world, STAMPS, 5)
    js, ts = _pair()
    work = KeyframeWork(js)
    saved = graft.stereo_extract
    records = []
    try:
        work.install()
        for i, stamp in enumerate(STAMPS):
            if i in BLANK:
                left = right = np.full((H, W), 30, np.uint8)
            else:
                left, right = _render(world, float(stamp))
            f = graft.mono_extract(torch.from_numpy(left), ts.cam_params,
                                   None, ts.mcfg)
            fr = graft.mono_extract(torch.from_numpy(right), ts.cam_params,
                                    None, ts.mcfg)
            jf, jfr = jax_feats(_feats_np(f)), jax_feats(_feats_np(fr))
            js._extract = (lambda img, *_, jf=jf, jfr=jfr, left=left, **__:
                           jf if img is left else jfr)
            sync_vi(ts, js)
            rec = {"stamp": stamp, "prior_in": js._pose_prior_H is not None,
                   "ready_in": js.imu_ready}
            n_b = len(work.bundles)
            rec["jax"] = snapshot_vi(js, _pose(js.track(
                left, right, float(stamp), imus[i])), True)
            rec["keyframe"] = len(work.bundles) > n_b
            m = tstereo.StereoMatchResult(
                u_right=convert.to_torch(np.asarray(js._ur), "cpu"),
                depth=convert.to_torch(np.asarray(js._depth), "cpu"),
                valid=convert.to_torch(np.asarray(js._depth) > 0, "cpu"))
            graft.stereo_extract = lambda *_, f=f, m=m: (f, None, m)
            rec["port"] = snapshot_vi(ts, _pose(ts.track(
                left, right, float(stamp), imus[i])), False)
            graft.stereo_extract = saved
            records.append(rec)
        out = {name: slam.trajectory for name, slam in (("jax", js),
                                                        ("port", ts))}
    finally:
        graft.stereo_extract = saved
        work.restore()
    return records, out


def test_sequence_does_its_work():
    """The one-frame init, pre-init visual frames, the IMU-init keyframe,
    inertial frames with and without the carried prior, an inertial
    keyframe, and a RECENTLY_LOST frame, in the JAX run."""
    records = _run()[0]
    kinds = set()
    for r in records:
        if r["ready_in"]:
            kinds.add("prior" if r["prior_in"] else "no prior")
            if r["keyframe"]:
                kinds.add("inertial keyframe")
        elif r["jax"]["imu_ready"]:
            kinds.add("init keyframe")
        elif r["jax"]["status"] == tsys.OK:
            kinds.add("visual")
    assert kinds >= {"visual", "init keyframe", "prior", "no prior",
                     "inertial keyframe"}, kinds
    ref = [r["jax"] for r in records]
    assert ref[0]["n_kf"] == 1
    assert any(r["status"] == tsys.RECENTLY_LOST for r in ref)
    assert ref[-1]["status"] == tsys.OK and ref[-1]["imu_ready"]


@pytest.mark.parametrize("i", range(len(STAMPS)))
def test_frame_matches_jax(i):
    rec = _run()[0][i]
    assert_same_vi(rec["jax"], rec["port"])


def test_trajectory_matches_jax():
    out = _run()[1]
    assert len(out["port"]) == len(out["jax"]) > 0
    for (s1, R1, t1), (s2, R2, t2) in zip(out["jax"], out["port"]):
        assert s2 == s1
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)


def test_default_device_is_the_card(monkeypatch):
    """Both inertial systems select the card without a device and raise
    without one; a vocabulary that is not the port's is refused (loop
    closing itself is ported, ROADMAP item 12b)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ti = imu_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsi.StereoInertialSlam(tst.StereoConfig(**CFG), ti)
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvi.MonoInertialSlam(tsys.SlamConfig(fx=F, fy=F, cx=W / 2,
                                             cy=H / 2, width=W, height=H),
                             ti)
    with pytest.raises(TypeError, match="ops.bow.Vocabulary"):
        tsi.StereoInertialSlam(tst.StereoConfig(**CFG,
                                                vocabulary=np.zeros(4)),
                               ti, device="cpu")
