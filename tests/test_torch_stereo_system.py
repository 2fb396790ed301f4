"""Port parity: the stereo and RGB-D systems (``pipeline/stereo_system``
``StereoSlam`` and ``RgbdSlam``) against the JAX package's, frame by frame.

A short ``SynthWorld(seed=11)`` rectified sequence rendered here at 320x240
(fx = fy = 200, baseline 0.2 m, so bf = 40; 1024 features) goes through
both systems with the same configuration (no vocabulary; the JAX system's
loop closing and background GBA off). Both get the port's extracted
features (the JAX system's ``_extract`` is replaced), and, as in
test_torch_system.py, each frame starts from the same state: before it the
port system is given the JAX system's map and host state. The stereo port
also takes the JAX system's ``_depth`` / ``_ur`` of the frame: the JAX
stereo match never runs its median sweep (a reference fault the port
repairs, held in test_torch_stereo.py), so from the same images the two
would disagree on purpose. The RGB-D port computes its own from the depth
image, and they must equal the JAX system's.

On a frame that hosts a keyframe the port runs its own keyframe bundle and
then takes the JAX bundle's outputs, as it takes the JAX state before each
frame. The bundle is held against the JAX package in
test_torch_keyframe_step.py and test_torch_mapping.py (with stereo rows);
here its windowed BA is too sensitive to compare: its early maps fix one
keyframe and hold depth landmarks observed twice by one keyframe, and the
JAX bundle rerun with its input pose moved by 1e-6 m moves its free
keyframes by up to 5e-3 in rotation and some landmarks by metres
(measured on frame 2 of this sequence).

Each frame must agree: the status, the counters, the reference keyframe,
the close-point counts, the frame's pose (1e-4), the spanning tree, the
frame records, the last frame's bindings (equal) and the map
(``torch_port_util.assert_states_close``: integer and bool arrays equal,
poses 1e-4, live landmarks 1e-3 m or 0.01 px).

Also: the stereo keyframe rules (test_kf_policy.py's five stereo cases),
the capacity bail-out (the intended difference: the JAX StereoSlam
back-projects the frame's depths with the previous keyframe's pose when no
keyframe is made; the port makes no landmark), the device default, and the
committed stereo fixture re-rendered bit for bit.
"""

import copy
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_system import _feats_np, _np_state, _pose, _port_feats, _sync
from torch_port_util import assert_states_close, jax_feats, n

from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import stereo_system as jst
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.ops import stereo as tstereo
from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tst

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_stereo_frames as fixture  # noqa: E402

W, H, F, B = 320, 240, 200.0, 0.2
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=8, max_lm=2048, max_obs=8, fps=10,
           kf_ref_min_obs=1, local_window=2, ba_window=6,
           local_lm_window=512, ba_lm_window=512, bf=B * F, th_depth=35.0,
           min_init_depth_points=100, min_init_landmarks=50)
CAM = np.array([F, F, W / 2, H / 2], np.float32)
STAMPS = np.round(np.arange(0.0, 1.0, 0.1), 3)


def _world():
    return SynthWorld(seed=11, w=W, h=H, fx=F, fy=F)


def _frame(world, t):
    """(left, right, depth) at time t: the fixture's renderer at 320x240."""
    R, tt = world.pose(t)
    left = world.render(t)
    wr = copy.copy(world)
    wr.pose = lambda _t: (R, tt - np.array([B, 0, 0], np.float32))
    return left, wr.render(t), fixture.render_depth(world, t)


def _snapshot(slam, pose, jax_side):
    return dict(
        pose=pose, status=slam.status, n_kf=slam.n_kf, n_lm=slam.n_lm,
        last_kf_id=slam.last_kf_id, frames_since_kf=slam.frames_since_kf,
        n_maps=len(slam.atlas.maps), kf_parent=slam.kf_parent.copy(),
        refs=list(slam._traj.refs), close=tuple(slam._close_counts),
        bindings=(None if slam._last is None
                  else n(slam._last["bindings"])),
        state=(_np_state(slam.state) if jax_side
               else convert.map_state_to_numpy(slam.state)))


def _assert_same(ref, got):
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs", "close"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    np.testing.assert_array_equal(got["kf_parent"], ref["kf_parent"])
    assert (got["pose"] is None) == (ref["pose"] is None)
    if ref["pose"] is not None:
        for a, b in zip(got["pose"], ref["pose"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert (got["bindings"] is None) == (ref["bindings"] is None)
    if ref["bindings"] is not None:
        np.testing.assert_array_equal(got["bindings"], ref["bindings"])
    assert_states_close(ref["state"], got["state"], CAM)
    if ref["status"] == jsys.OK:
        assert tms.check_invariants(
            convert.map_state_to_torch(got["state"], "cpu"), got["n_kf"],
            CFG["max_lm"]) == []


def _pair(kind):
    """A JAX system and a port system of ``kind`` on the same config."""
    jcls, tcls = ((jst.StereoSlam, tst.StereoSlam) if kind == "stereo"
                  else (jst.RgbdSlam, tst.RgbdSlam))
    jcfg = (jst.StereoConfig if kind == "stereo" else jst.RgbdConfig)(
        **CFG, use_loop_closing=False, background_gba=False,
        device_mesh=False, **({} if kind == "stereo" else
                              {"depth_scale": fixture.DEPTH_FACTOR}))
    tcfg = (tst.StereoConfig if kind == "stereo" else tst.RgbdConfig)(
        **CFG, **({} if kind == "stereo" else
                  {"depth_scale": fixture.DEPTH_FACTOR}))
    return jcls(jcfg), tcls(tcfg, device="cpu")


def _sync_depth(ts, js):
    _sync(ts, js)
    ts._depth = (None if js._depth is None
                 else convert.to_torch(np.asarray(js._depth), "cpu"))
    ts._ur = (None if js._ur is None
              else convert.to_torch(np.asarray(js._ur), "cpu"))


@functools.cache
def _run(kind):
    """Both systems through the sequence, the port from the JAX system's
    state at every frame: (per frame a record of each side, the
    trajectories, the JAX system after the last frame)."""
    world = _world()
    js, ts = _pair(kind)
    records = []
    bundles = []
    saved = (graft.stereo_extract, graft.mono_keyframe_step,
             jmap.keyframe_bundle)

    def jax_bundle(*a, **k):
        out = saved[2](*a, **k)
        bundles.append(out)
        return out

    def port_bundle(*a, **k):
        """The port's own bundle runs; the frame goes on with the JAX
        bundle's outputs of the same frame."""
        saved[1](*a, **k)
        st, b, info, culled = bundles[-1]
        return (convert.map_state_to_torch(_np_state(st), "cpu"),
                *(convert.to_torch(np.asarray(x), "cpu")
                  for x in (b, info, culled)))

    jmap.keyframe_bundle = jax_bundle
    graft.mono_keyframe_step = port_bundle
    try:
        for stamp in STAMPS:
            left, right, depth = _frame(world, float(stamp))
            f = graft.mono_extract(torch.from_numpy(left), ts.cam_params,
                                   None, ts.mcfg)
            fr = graft.mono_extract(torch.from_numpy(right), ts.cam_params,
                                    None, ts.mcfg)
            jf, jfr = jax_feats(_feats_np(f)), jax_feats(_feats_np(fr))
            js._extract = (lambda img, *_, jf=jf, jfr=jfr, left=left, **__:
                           jf if img is left else jfr)
            ts._extract = lambda _, f=f: f
            _sync_depth(ts, js)
            rec = {"stamp": stamp}
            second = right if kind == "stereo" else depth
            bundles.clear()
            rec["jax"] = _snapshot(js, _pose(js.track(left, second,
                                                      float(stamp))), True)
            if kind == "stereo":
                m = tstereo.StereoMatchResult(
                    u_right=convert.to_torch(np.asarray(js._ur), "cpu"),
                    depth=convert.to_torch(np.asarray(js._depth), "cpu"),
                    valid=convert.to_torch(np.asarray(js._depth) > 0, "cpu"))
                graft.stereo_extract = lambda *_, f=f, m=m: (f, None, m)
            rec["port"] = _snapshot(ts, _pose(ts.track(left, second,
                                                       float(stamp))), False)
            rec["depth"] = (n(ts._depth), np.asarray(js._depth),
                            n(ts._ur), np.asarray(js._ur))
            records.append(rec)
        out = {name: slam.trajectory for name, slam in (("jax", js),
                                                        ("port", ts))}
    finally:
        graft.stereo_extract, graft.mono_keyframe_step, \
            jmap.keyframe_bundle = saved
    return records, out, js


@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_sequence_does_its_work(kind):
    """The one-frame init on the first frame, then tracking with keyframes
    until the 8-slot map is full (its insertion then suspended), in the
    JAX run."""
    records = _run(kind)[0]
    ref = [r["jax"] for r in records]
    assert ref[0]["status"] == jsys.OK and ref[0]["n_kf"] == 1
    assert ref[0]["state"].lms.valid.sum() >= CFG["min_init_landmarks"]
    assert all(r["status"] == jsys.OK for r in ref)
    assert ref[-1]["n_kf"] == CFG["max_kf"] - 1
    assert max(r["close"][0] for r in ref) > 0


@pytest.mark.parametrize("kind,i", [(k, i) for k in ("stereo", "rgbd")
                                    for i in range(len(STAMPS))])
def test_frame_matches_jax(kind, i):
    rec = _run(kind)[0][i]
    _assert_same(rec["jax"], rec["port"])
    if kind == "rgbd":
        # The port samples the depth image itself: the same depth and
        # virtual right-image u as the JAX system.
        d_t, d_j, u_t, u_j = rec["depth"]
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_array_equal(u_t, u_j)


@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_trajectory_matches_jax(kind):
    out = _run(kind)[1]
    assert len(out["port"]) == len(out["jax"]) == len(STAMPS)
    for (s1, R1, t1), (s2, R2, t2) in zip(out["jax"], out["port"]):
        assert s2 == s1
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)


def _policy_pair():
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
              n_features=256, max_kf=32, max_lm=1024, max_obs=4, fps=10,
              bf=80.0, th_depth=35.0)
    return (jst.StereoSlam(jst.StereoConfig(**kw, device_mesh=False)),
            tst.StereoSlam(tst.StereoConfig(**kw), device="cpu"))


# test_kf_policy.py's TestStereoKeyframePolicy: (frames since the last
# keyframe, close counts (tracked, untracked), inliers, reference matches,
# the decision); None frames means the interval max_frames.
STEREO_POLICY = [(1, (40, 120), 180, 200, True),
                 (1, (150, 120), 180, 200, False),
                 (1, (150, 0), 160, 200, False),
                 (1, (40, 10), 190, 200, False),
                 (None, (150, 0), 120, 200, True)]


@pytest.mark.parametrize("frames,close,inliers,ref,want", STEREO_POLICY)
def test_stereo_keyframe_policy_matches_jax(frames, close, inliers, ref,
                                            want):
    js, ts = _policy_pair()
    for slam in (js, ts):
        slam.frames_since_kf = slam.max_frames if frames is None else frames
        slam._close_counts = close
    assert js._need_new_keyframe(inliers, ref_matches=ref) == want
    assert ts._need_new_keyframe(inliers, ref_matches=ref) == want


def test_capacity_bail_out_makes_no_stale_landmark():
    """The intended difference from the JAX package. When the map is full
    the monocular keyframe step makes no keyframe; the JAX StereoSlam then
    still back-projects the frame's close keypoints with the previous
    keyframe's pose and keypoint slab (its stale ``last_kf_id``,
    stereo_system.py:215-224). The port's ``_create_keyframe`` returns None
    and the frame makes no landmark."""
    records, _, js_end = _run("stereo")
    world = _world()
    js, ts = copy.deepcopy(js_end), _pair("stereo")[1]
    # The JAX system after the sequence gets one more frame, then the
    # keyframe step with the map declared full.
    stamp = float(STAMPS[-1] + 0.1)
    left, right, _ = _frame(world, stamp)
    f = graft.mono_extract(torch.from_numpy(left), ts.cam_params, None,
                           ts.mcfg)
    fr = graft.mono_extract(torch.from_numpy(right), ts.cam_params, None,
                            ts.mcfg)
    jf, jfr = jax_feats(_feats_np(f)), jax_feats(_feats_np(fr))
    js._extract = lambda img, *_, **__: jf if img is left else jfr
    js.track(left, right, stamp)          # the frame's depth and pose
    _sync_depth(ts, js)
    for slam in (js, ts):
        slam._kf_slot_available = lambda: False
        slam.n_kf = slam.cfg.max_kf - 1
    R, t = js._last["R"], js._last["t"]
    bind = js._last["bindings"]
    from orbslam3_byzyh_tpu.pipeline.tracking import TrackResult as JTR
    from orbslam3_byzyh_tpu_torch.pipeline.tracking import TrackResult as TTR
    lm_before = int(np.asarray(js.state.lms.valid).sum())
    js._create_keyframe(jf, JTR(R=jnp.asarray(R), t=jnp.asarray(t),
                                bindings=bind, n_inliers=None), stamp)
    jax_made = int(np.asarray(js.state.lms.valid).sum()) - lm_before
    before = convert.map_state_to_numpy(ts.state)
    got = ts._create_keyframe(
        _port_feats(jf), TTR(R=torch.from_numpy(np.array(R)),
                             t=torch.from_numpy(np.array(t)),
                             bindings=convert.to_torch(np.array(bind), "cpu"),
                             n_inliers=None), stamp, np.array(R),
        np.array(t))
    assert got is None
    assert jax_made > 0                    # the reference fault
    after = convert.map_state_to_numpy(ts.state)
    np.testing.assert_array_equal(after.lms.valid, before.lms.valid)
    np.testing.assert_array_equal(after.obs.kf, before.obs.kf)
    assert records[-1]["port"]["n_kf"] == records[-1]["jax"]["n_kf"]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.StereoSlam(tst.StereoConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.RgbdSlam(tst.RgbdConfig(**CFG))


def test_fixture_is_the_renderers():
    """``tests/golden/frames_stereo.npz`` re-rendered: every array bit for
    bit (the pairs, the depth images, the poses)."""
    fresh = fixture.stereo_arrays()
    with np.load(graft.STEREO_FRAMES) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    loaded = graft.stereo_frames()
    assert loaded.left.shape == (30, 480, 640)
    assert loaded.depth.dtype == np.uint16
