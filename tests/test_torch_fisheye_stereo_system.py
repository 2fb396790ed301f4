"""Port parity: the non-rectified ("fisheye") stereo systems
(``pipeline/stereo_system.FisheyeStereoSlam``,
``pipeline/stereo_inertial.FisheyeStereoInertialSlam``) against the JAX
package's, frame by frame.

A short ``SynthWorld(seed=11, motion="excited")`` sequence rendered here at
320x240 (fx = fy = 200) through a non-rectified pair, the right camera
0.2 m along the left one's x axis and yawed 3 degrees, as
tests/test_fisheye_stereo_system.py builds its rig, with its 200 Hz IMU
(the noise from ``default_rng(5)``). Both packages get the same
configuration (1024 features, 16 keyframe / 2048 landmark slots, the
one-frame init's gates at that test's 60 / 40) and the port's features;
the port takes the JAX system's depths of the frame (its own fisheye match
on the same features is held to them beside: ``valid`` equal but for at
most 2 % of the rows, the depths within 1e-4 relative; the match alone is
held in test_torch_fisheye_stereo.py). As in
tests/test_torch_stereo_inertial_system.py each frame starts from the JAX
system's state and, on a keyframe frame, the port takes the JAX bundle's
and local BA's outputs after running its own; both inertial systems get
the IMU-init gates lowered to 4 chain keyframes and 0.8 s.

Each frame must agree within tests/test_torch_stereo_system.py's
tolerances (the visual system) or tests/test_torch_mono_inertial_system.py's
(the inertial one). The fisheye
classes keep the JAX quirks: the right-image u stays None, so the frames
take K3 with mono rows and the bundles mono rows over the depth-made
landmarks; ``FisheyeStereoInertialSlam`` starts with no depth. One
intended difference: the port's VI-BA write-back recounts a landmark that
lost an observation to the gate (a repaired fault of the reference,
``inertial_system._scatter_viba``), which ``assert_same_vi`` states.
Also: the device default and the committed fisheye fixture re-rendered bit
for bit.
"""

import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_mono_inertial_system import (INIT_GATES, VIBA, KeyframeWork,
                                             assert_same_vi, imu_batches,
                                             imu_cfgs, snapshot_vi, sync_vi)
from test_torch_stereo_system import _assert_same, _snapshot
from test_torch_system import _feats_np, _np_state, _pose, _sync
from torch_port_util import jax_feats, n

from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import stereo_inertial as jsi
from orbslam3_byzyh_tpu.pipeline import stereo_system as jst
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import stereo as tstereo
from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial as tsi
from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tst
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_fisheye_frames as fixture  # noqa: E402

W, H, F, B = 320, 240, 200.0, 0.2
R_D = fixture.yaw_rotation(fixture.YAW_DEG)
RIG = dict(cam2=np.array([F, F, W / 2, H / 2], np.float32), R_rl=R_D,
           t_rl=(R_D @ np.array([-B, 0, 0], np.float32)).astype(np.float32))
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=16, max_lm=2048, max_obs=8, fps=10,
           kf_ref_min_obs=3, local_window=2, ba_window=6,
           local_lm_window=512, ba_lm_window=512, bf=B * F, th_depth=35.0,
           min_init_depth_points=60, min_init_landmarks=40)
STAMPS = np.round(np.arange(0.0, 1.8, 0.1), 3)
N_VISUAL = 8            # frames of the visual system's run


@functools.cache
def _frames():
    """The rendered pairs and each frame's IMU batch."""
    world = SynthWorld(seed=11, w=W, h=H, fx=F, fy=F, motion="excited")
    pairs = []
    for s in STAMPS:
        R, tt = world.pose(float(s))
        wr = copy.copy(world)
        t_r = R_D @ (tt - np.array([B, 0, 0], np.float32))
        wr.pose = lambda _t, Rr=(R_D @ R), tr=t_r: (Rr, tr)
        pairs.append((world.render(float(s)), wr.render(float(s))))
    return pairs, imu_batches(world, STAMPS, 5)


def _pair(inertial: bool):
    # The visual run keeps TrackedMapPoints(1), as the JAX fisheye test:
    # with 3 its eight frames make no keyframe, and the frame's pose rests
    # on 20-30 landmarks, where the two float32 pose solves part by 2.6e-4.
    cfg = dict(CFG, kf_ref_min_obs=CFG["kf_ref_min_obs"] if inertial else 1)
    jcfg = jst.FisheyeStereoConfig(**cfg, **RIG, use_loop_closing=False,
                                   background_gba=False, device_mesh=False)
    tcfg = tst.FisheyeStereoConfig(**cfg, **RIG)
    if not inertial:
        return jst.FisheyeStereoSlam(jcfg), tst.FisheyeStereoSlam(
            tcfg, device="cpu")
    ji, ti = imu_cfgs()
    js = jsi.FisheyeStereoInertialSlam(jcfg, ji, **VIBA)
    ts = tsi.FisheyeStereoInertialSlam(tcfg, ti, **VIBA, device="cpu")
    for slam in (js, ts):
        for k, v in INIT_GATES.items():
            setattr(slam, k, v)
    return js, ts


@functools.cache
def _run(inertial: bool):
    """Both systems through the sequence, the port from the JAX system's
    state at every frame: per frame a record of each side, the port's own
    match beside the JAX depths, and the trajectories."""
    pairs, imus = _frames()
    js, ts = _pair(inertial)
    work = KeyframeWork(js) if inertial else _BundleWork()
    saved = graft.fisheye_stereo_extract
    records = []
    try:
        work.install()
        for i, stamp in enumerate(STAMPS[:None if inertial else N_VISUAL]):
            left, right = pairs[i]
            fl = graft.mono_extract(torch.from_numpy(left), ts.cam_params,
                                    None, ts.mcfg)
            fr = graft.mono_extract(torch.from_numpy(right),
                                    ts._fish.cam_r, None, ts.mcfg)
            jf, jfr = jax_feats(_feats_np(fl)), jax_feats(_feats_np(fr))
            js._extract = (lambda img, *_, jf=jf, jfr=jfr, left=left, **__:
                           jf if img is left else jfr)
            (sync_vi if inertial else _sync)(ts, js)
            rec = {"stamp": stamp, "ready_in": getattr(js, "imu_ready",
                                                       False),
                   "prior_in": getattr(js, "_pose_prior_H", None)
                   is not None}
            extra = (float(stamp), imus[i]) if inertial else (float(stamp),)
            n_b = len(work.bundles)
            snap = snapshot_vi if inertial else _snapshot
            rec["jax"] = snap(js, _pose(js.track(left, right, *extra)), True)
            rec["keyframe"] = len(work.bundles) > n_b
            jd = np.asarray(js._depth)
            own = tstereo.fisheye_stereo_match(
                fl.xy, fl.level, fl.desc, fl.valid, fr.xy, fr.level,
                fr.desc, fr.valid, ts._fish.cam_l, ts._fish.cam_r,
                ts._fish.R_rl, ts._fish.t_rl)
            rec["match"] = (n(own.depth), jd)
            m = tstereo.FisheyeStereoResult(
                depth=convert.to_torch(jd, "cpu"),
                match_j=torch.full((len(jd),), -1, dtype=torch.int32),
                valid=convert.to_torch(jd > 0, "cpu"))
            graft.fisheye_stereo_extract = lambda *_, f=fl, m=m: (f, None, m)
            rec["port"] = snap(ts, _pose(ts.track(left, right, *extra)),
                               False)
            rec["ur"] = (ts._ur, js._ur)
            graft.fisheye_stereo_extract = saved
            records.append(rec)
        out = {name: slam.trajectory for name, slam in (("jax", js),
                                                        ("port", ts))}
    finally:
        graft.fisheye_stereo_extract = saved
        work.restore()
    return records, out


class _BundleWork:
    """The visual system's keyframe work: the JAX bundle's outputs (its
    windowed BA inside) given to the port after the port's own bundle ran,
    as tests/test_torch_stereo_system.py does."""

    def __init__(self):
        self.bundles = []

    def install(self):
        self.saved = (jmap.keyframe_bundle, graft.mono_keyframe_step)
        bundles, saved = self.bundles, self.saved

        def jax_bundle(*a, **k):
            out = saved[0](*a, **k)
            bundles.append(out)
            return out

        def port_bundle(*a, **k):
            saved[1](*a, **k)
            st, b, info, culled = bundles[-1]
            return (convert.map_state_to_torch(_np_state(st), "cpu"),
                    *(convert.to_torch(np.asarray(x), "cpu")
                      for x in (b, info, culled)))

        jmap.keyframe_bundle = jax_bundle
        graft.mono_keyframe_step = port_bundle

    def restore(self):
        jmap.keyframe_bundle, graft.mono_keyframe_step = self.saved


def _same(rec, inertial):
    if not inertial:
        _assert_same(rec["jax"], rec["port"])
        return
    # The IMU-init keyframe runs each package's own init (the inertial-only
    # solve, the rebase and the full VI-BA) over 4 keyframes and 0.9 s of
    # mono rows: the accelerometer bias is weakly observed there, and the
    # two float32 solves end 7.5e-5 apart in it, some landmarks 6.3e-3 m
    # (each still reprojecting within 0.01 px). Elsewhere the file's
    # tolerances hold.
    init = not rec["ready_in"] and rec["jax"]["imu_ready"]
    assert_same_vi(rec["jax"], rec["port"],
                   **(dict(ba=2e-4, lm=1e-2) if init else {}))


def test_visual_sequence_does_its_work():
    """The one-frame init, then tracked frames and keyframes, in the JAX
    run; the right-image u stays None in both packages."""
    records = _run(False)[0]
    ref = [r["jax"] for r in records]
    assert ref[0]["status"] == tsys.OK and ref[0]["n_kf"] == 1
    assert all(r["status"] == tsys.OK for r in ref)
    assert sum(r["keyframe"] for r in records) >= 2
    assert all(r["ur"] == (None, None) for r in records)


def test_inertial_sequence_does_its_work():
    """The one-frame init, visual frames, the IMU-init keyframe, inertial
    frames with and without the carried prior, in the JAX run."""
    records = _run(True)[0]
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
    assert kinds >= {"visual", "init keyframe", "prior", "no prior"}, kinds
    assert records[-1]["jax"]["status"] == tsys.OK
    assert all(r["ur"] == (None, None) for r in records)


@pytest.mark.parametrize("inertial,i", [(False, i) for i in range(N_VISUAL)]
                         + [(True, i) for i in range(len(STAMPS))])
def test_frame_matches_jax(inertial, i):
    rec = _run(inertial)[0][i]
    _same(rec, inertial)
    # The port's own match on the same features against the JAX depths.
    own, jd = rec["match"]
    ok, ok_j = own > 0, jd > 0
    assert (ok != ok_j).sum() <= 0.02 * max(ok_j.sum(), 1)
    both = ok & ok_j
    np.testing.assert_allclose(own[both], jd[both], rtol=1e-4)


@pytest.mark.parametrize("inertial", [False, True])
def test_trajectory_matches_jax(inertial):
    out = _run(inertial)[1]
    assert len(out["port"]) == len(out["jax"]) > 0
    for (s1, R1, t1), (s2, R2, t2) in zip(out["jax"], out["port"]):
        assert s2 == s1
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)


def test_default_device_is_the_card(monkeypatch):
    """Both fisheye systems and a KB8 ``MonoSlam`` select the card without
    a device and raise without one; on the CPU they construct."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ti = imu_cfgs()
    cfg = tst.FisheyeStereoConfig(**CFG, **RIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.FisheyeStereoSlam(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsi.FisheyeStereoInertialSlam(cfg, ti)
    kb8 = tsys.SlamConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
                          kb8=np.array(graft.TUMVI_KB8_1, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsys.MonoSlam(kb8)
    assert tsys.MonoSlam(kb8, device="cpu").kb8 is not None
    slam = tsi.FisheyeStereoInertialSlam(cfg, ti, device="cpu")
    assert slam._depth is None and slam.ctx.bf is None
    assert slam.ctx.depth_threshold == cfg.depth_threshold


def test_fisheye_fixture_is_the_rendered_pair():
    """tests/golden/frames_fisheye.npz equals a fresh render."""
    fresh = fixture.fisheye_arrays()
    with np.load(graft.FISHEYE_FRAMES) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
