"""Port parity: the monocular system (``pipeline/system.MonoSlam``) against
the JAX package's ``MonoSlam``, frame by frame.

A short ``SynthWorld(seed=3)`` sequence rendered here at 320x240 (fx = fy =
200, 1024 features) goes through both systems with the same configuration
(no vocabulary; the JAX system's loop closing and background GBA off).
Both get the port's extracted features (the JAX system's ``_extract`` is
replaced, so no XLA extraction is compiled), and the port's RANSAC takes
the indices the JAX system draws: its ``_ransac_indices`` replays the JAX
system's key splits, one per two-view attempt. The JAX
``two_view_reconstruct`` runs under ``jax.jit`` (the same code, compiled
once instead of op by op).

The sequence runs through the initialisation and the first three
keyframes, which fill the 6-slot map (``max_kf`` 6) to its last slot. A
map that small never culls on its own (the bundle culls from 8 keyframes,
the forced culling spares the 8 newest), so the test then culls keyframe 1
in both systems, as the forced culling does (``drop_keyframe`` and the
trajectory rebase). The next keyframe decision compacts the keyframes
(``map_state.compact_keyframes``) and inserts the keyframe; the one after
finds the map full. A stamp 5 s ahead then resets the young map, and both
systems initialise a new one.

Each frame starts from the same state in both systems: before it, the port
system is given the JAX system's map and host state. Run freely, the two
drift apart at float32 rounding (the BA's accept/reject and the
triangulation gates compare floats), and from the third keyframe on a
triangulation gate decides differently on inputs that differ by 4e-4 m
(measured on this sequence); from then on the maps hold different
landmark rows, and no per-frame comparison could hold them together.
From the same state, each frame must agree: the status, the keyframe and
landmark counters, the reference keyframe, the frame's pose (1e-4), the
spanning tree, the frame records' reference keyframes, the last frame's
bindings (equal) and the map (``torch_port_util.assert_states_close``:
every integer and bool array equal, poses 1e-4, live landmarks 1e-3 m or
0.01 px). The planted cull is compared before the next frame. At the end
(after the last frame, from the same state): the compactions' ``old2new``,
``trajectory`` and ``keyframe_trajectory`` (1e-4, stamps equal).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from torch_port_util import assert_states_close, jax_feats, n

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import atlas as tatlas
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys
from orbslam3_byzyh_tpu_torch.pipeline import trajectory_log as ttl

W, H, F = 320, 240, 200.0
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=6, max_lm=2048, max_obs=8, fps=10,
           min_init_matches=40, kf_ref_min_obs=1, local_window=2,
           ba_window=6, local_lm_window=512, ba_lm_window=512)
CAM = np.array([F, F, W / 2, H / 2], np.float32)
STAMPS = np.round(np.arange(0.4, 1.6, 0.1), 3)
# After this frame the 6-slot map holds 5 keyframes; keyframe 1 is culled.
CULL_AFTER = 9
# The frame 5 s ahead, and the frames that initialise the new map.
JUMP = 6.5
AFTER_JUMP = np.round(JUMP + np.arange(0.1, 0.8, 0.1), 3)


def _np_state(state):
    return type(state)(*(type(g)(*(np.asarray(a) for a in g))
                         for g in state))


def _feats_np(f):
    return [convert.desc_to_uint32(a) if k == "desc" else n(a)
            for k, a in zip(f._fields, f)]


def _pose(p):
    return None if p is None else (np.asarray(p[0]), np.asarray(p[1]))


def _port_feats(f):
    return tfo.FrameFeatures(*convert.tree_to_torch(
        [np.asarray(a) for a in f], "cpu"))


def _port_value(x):
    """A JAX system's host value (numpy) stays numpy; a device value (a JAX
    array) becomes a CPU tensor, as the port keeps it on its device."""
    if isinstance(x, np.ndarray):
        return x.copy()
    return convert.to_torch(np.asarray(x), "cpu")


def _sync(ts, js):
    """Give the port system the JAX system's map and host state."""
    ts.atlas.maps = [convert.map_state_to_torch(_np_state(m), "cpu")
                     for m in js.atlas.maps]
    ts.atlas.meta = [tatlas.MapMeta(m.n_kf, m.n_lm, None if m.kf_parent is None
                                    else m.kf_parent.copy())
                     for m in js.atlas.meta]
    ts.atlas.current = js.atlas.current
    for k in ("status", "lost_frames", "frames_since_kf", "last_kf_id",
              "_ref_cache_gen", "_t0", "_init_stamp"):
        setattr(ts, k, getattr(js, k))
    ts._init_feats = (None if js._init_feats is None
                      else _port_feats(js._init_feats))
    ts._vel = None if js._vel is None else tuple(np.array(v) for v in js._vel)
    ts._last = None if js._last is None else dict(
        feats=_port_feats(js._last["feats"]),
        bindings=_port_value(js._last["bindings"]),
        R=_port_value(js._last["R"]), t=_port_value(js._last["t"]),
        stamp=js._last["stamp"])
    ts._traj = ttl.TrajectoryLog()
    for k in ("stamps", "refs", "tags"):
        setattr(ts._traj, k, list(getattr(js._traj, k)))
    ts._traj.R_cr = [np.array(r) for r in js._traj.R_cr]
    ts._traj.t_cr = [np.array(t) for t in js._traj.t_cr]
    c = js._ref_cache
    ts._ref_cache = None if c is None else (c[0], np.array(c[1]),
                                            np.array(c[2]))
    p = js._pending_kf
    ts._pending_kf = None if p is None else dict(
        kf_id=p["kf_id"], ref_gen=p["ref_gen"], out=torch.cat([
            convert.to_torch(np.asarray(p["info"]), "cpu"),
            convert.to_torch(np.asarray(p["culled"]), "cpu").float(),
            convert.to_torch(np.asarray(js.state.kfs.valid), "cpu").float()]))


def _snapshot(slam, pose, jax_side):
    return dict(
        pose=pose, status=slam.status, n_kf=slam.n_kf, n_lm=slam.n_lm,
        last_kf_id=slam.last_kf_id, frames_since_kf=slam.frames_since_kf,
        n_maps=len(slam.atlas.maps), kf_parent=slam.kf_parent.copy(),
        refs=list(slam._traj.refs),
        bindings=(None if slam._last is None
                  else n(slam._last["bindings"])),
        state=(_np_state(slam.state) if jax_side
               else convert.map_state_to_numpy(slam.state)))


@functools.cache
def _run():
    """Both systems through the sequence, the port from the JAX system's
    state at every frame: (per frame a record of each side, the planted
    cull's record, the compactions' old2new, the trajectories)."""
    world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F)
    js = jsys.MonoSlam(jsys.SlamConfig(**CFG, use_loop_closing=False,
                                       background_gba=False,
                                       device_mesh=False))
    ts = tsys.MonoSlam(tsys.SlamConfig(**CFG), device="cpu")
    key = [jax.random.PRNGKey(0)]

    def jax_indices(matched):
        key[0], sub = jax.random.split(key[0])
        w = jnp.asarray(n(matched).astype(np.float32)) + 1e-9
        return torch.from_numpy(np.array(
            jgeo._sample_indices(sub, 200, 8, w))).long()

    ts._ransac_indices = jax_indices
    compactions = {"jax": [], "port": []}

    def spy(store, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            store.append(np.asarray(out[1]))
            return out
        return wrapped

    t_jump = STAMPS[-1] + 0.1
    frames = ([(t, t) for t in STAMPS] + [(t_jump, JUMP)]
              + [(t_jump + t - JUMP, t) for t in AFTER_JUMP])
    records, culled = [], None
    patches = [(jgeo, "two_view_reconstruct",
                jax.jit(jgeo.two_view_reconstruct)),
               (jms, "compact_keyframes",
                spy(compactions["jax"], jms.compact_keyframes)),
               (tms, "compact_keyframes",
                spy(compactions["port"], tms.compact_keyframes))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    try:
        for m, name, fn in patches:
            setattr(m, name, fn)
        for i, (t_world, stamp) in enumerate(frames):
            img = world.render(float(t_world))
            f = graft.mono_extract(torch.from_numpy(img), ts.cam_params, None,
                                   ts.mcfg)
            jf = jax_feats(_feats_np(f))
            ts._extract = lambda _, f=f: f
            js._extract = lambda *_, jf=jf, **__: jf
            _sync(ts, js)
            rec = {"stamp": stamp}
            for name, slam in (("jax", js), ("port", ts)):
                pose = _pose(slam.track(img, float(stamp)))
                rec[name] = _snapshot(slam, pose, name == "jax")
            records.append(rec)
            if i == CULL_AFTER:
                # The forced culling's step, on keyframe 1.
                before = np.asarray(js.state.kfs.valid)
                js.state = jmap.drop_keyframe(js.state, jnp.asarray(1))
                js._rebase_culled(before)
                before = n(ts.state.kfs.valid)
                ts.state = tmap.drop_keyframe(ts.state, 1)
                after = before.copy()
                after[1] = False
                ts._rebase_culled(before, after)
                culled = {"jax": _snapshot(js, None, True),
                          "port": _snapshot(ts, None, False)}
        out = {name: (slam.trajectory, slam.keyframe_trajectory())
               for name, slam in (("jax", js), ("port", ts))}
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    return records, culled, compactions, out


def _assert_same(ref, got):
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs"):
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
    if ref["status"] == tsys.OK:
        assert tms.check_invariants(
            convert.map_state_to_torch(got["state"], "cpu"), got["n_kf"],
            CFG["max_lm"]) == []


def test_sequence_does_its_work():
    """The reference run initialises, fills the map, compacts it once,
    finds it full, resets on the jump and initialises again."""
    records, _, compactions, _ = _run()
    ref = [r["jax"] for r in records]
    status = [r["status"] for r in ref]
    first_ok = status.index(tsys.OK)
    assert 0 < first_ok < CULL_AFTER - 2
    assert ref[CULL_AFTER]["n_kf"] == CFG["max_kf"] - 1
    assert len(compactions["jax"]) >= 1
    o2n = compactions["jax"][0]
    assert o2n[1] == -1 and (o2n[[0, 2, 3, 4]] == [0, 1, 2, 3]).all()
    # The frame after the compaction hosts a keyframe in slot 4.
    nxt = ref[CULL_AFTER + 1]
    assert nxt["n_kf"] == CFG["max_kf"] - 1 and nxt["last_kf_id"] == 4
    jump = len(STAMPS)
    assert ref[jump]["pose"] is None
    assert ref[jump]["status"] == tsys.NOT_INITIALIZED
    assert ref[jump]["n_kf"] == 0 and ref[jump]["n_maps"] == 1
    assert ref[-1]["status"] == tsys.OK and ref[-1]["n_kf"] >= 2


@pytest.mark.parametrize("i", range(len(STAMPS) + 1 + len(AFTER_JUMP)))
def test_frame_matches_jax(i):
    rec = _run()[0][i]
    _assert_same(rec["jax"], rec["port"])


def test_planted_cull_matches_jax():
    culled = _run()[1]
    _assert_same(culled["jax"], culled["port"])
    assert not culled["jax"]["state"].kfs.valid[1]


def test_compaction_and_trajectories_match_jax():
    _, _, compactions, out = _run()
    assert len(compactions["port"]) == len(compactions["jax"])
    for a, b in zip(compactions["port"], compactions["jax"]):
        np.testing.assert_array_equal(a, b)
    (jt, (jks, jkR, jkt)), (pt, (pks, pkR, pkt)) = out["jax"], out["port"]
    assert len(pt) == len(jt) > 0
    for (s1, R1, t1), (s2, R2, t2) in zip(jt, pt):
        assert s2 == s1
        np.testing.assert_allclose(R2, R1, atol=1e-4)
        np.testing.assert_allclose(t2, t1, atol=1e-4)
    np.testing.assert_array_equal(pks, jks)
    np.testing.assert_allclose(pkR, jkR, atol=1e-4)
    np.testing.assert_allclose(pkt, jkt, atol=1e-4)


def _policy_pair():
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
              n_features=256, max_kf=32, max_lm=1024, max_obs=4, fps=10)
    return (jsys.MonoSlam(jsys.SlamConfig(**kw, device_mesh=False)),
            tsys.MonoSlam(tsys.SlamConfig(**kw), device="cpu"))


# (frames since the last keyframe, inliers, reference matches): the mono
# rules of NeedNewKeyFrame (test_kf_policy.py's mono case first).
POLICY_CASES = [(1, 160, 200), (1, 180, 200), (10, 120, 200), (10, 190, 200),
                (3, 15, 10), (0, 100, 400)]


@pytest.mark.parametrize("frames,inliers,ref", POLICY_CASES)
def test_keyframe_policy_matches_jax(frames, inliers, ref):
    js, ts = _policy_pair()
    for slam in (js, ts):
        slam.frames_since_kf = frames
    want = js._need_new_keyframe(inliers, ref_matches=ref)
    assert ts._need_new_keyframe(inliers, ref_matches=ref) == want
    if (frames, inliers, ref) == (1, 160, 200):
        assert want          # 160 < 0.9 x 200: the mono ratio inserts


def test_default_device_is_the_card(monkeypatch):
    """``MonoSlam``, ``Atlas`` and ``empty_map`` select the card without a
    device and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsys.MonoSlam(tsys.SlamConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tatlas.Atlas(8, 64, 4, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.empty_map(8, 64, 4, 32)
    assert tms.empty_map(8, 64, 4, 32, device="cpu").kfs.R.device.type == \
        "cpu"


@pytest.mark.parametrize("option,item", [("vocabulary", "12"),
                                         ("chessboard", "13"),
                                         ("kb8", "10")])
def test_unported_options_raise(option, item):
    """The chessboard world frame is ported (item 13): the system builds
    and snoops each uninitialised frame for the board. A vocabulary is
    ported (items 12a-12c): one that is not the port's is refused, and
    with a port vocabulary the system closes loops and its merge branch
    mines the other maps (none here). A KB8 camera is ported (item 10b):
    the system builds; the native KB8 pose optimizer, which no system
    calls, is ported too (item 10c): with the camera's 8 parameters it
    solves, with the pinhole's 4 it refuses the call."""
    if option == "chessboard":
        slam = tsys.MonoSlam(tsys.SlamConfig(
            **CFG, chessboard=graft.MYCAMERA_BOARD), device="cpu")
        snooped = []
        snoop = slam._snoop_chessboard
        slam._snoop_chessboard = lambda img: snooped.append(snoop(img))
        world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F)
        slam.track(world.render(float(STAMPS[0])).astype(np.uint8),
                   float(STAMPS[0]))
        assert len(snooped) == 1 and slam._chess_pose is None
        assert not slam._chess_applied
        return
    cfg = tsys.SlamConfig(**CFG, **{option: np.zeros(4)})
    if option == "vocabulary":
        with pytest.raises(TypeError, match="ops.bow.Vocabulary"):
            tsys.MonoSlam(cfg, device="cpu")
        from orbslam3_byzyh_tpu_torch.ops import bow as tbow
        voc = tbow.Vocabulary(torch.zeros((1, 8), dtype=torch.int32),
                              torch.zeros((1, 2), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.ones(1), 2, 1, 1)
        slam = tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=voc),
                             device="cpu")
        assert slam.cfg.use_loop_closing
        assert slam.loop_closer.detect_merge(slam.state, 0,
                                             slam.atlas) is None
        assert slam.loop_closer.info["maps"] == []
        return
    if option != "kb8":
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tsys.MonoSlam(cfg, device="cpu")
        return
    slam = tsys.MonoSlam(cfg, device="cpu")
    assert slam.kb8 is not None
    from orbslam3_byzyh_tpu_torch.ops import camera as tcam
    from orbslam3_byzyh_tpu_torch.solver import pose_opt
    cam8 = torch.cat([slam.cam_params, slam.kb8])
    pts = torch.tensor([[0.3, 0.1, 2.0], [-0.4, 0.2, 3.0], [0.1, -0.3, 2.5],
                        [0.5, 0.4, 4.0], [-0.2, -0.1, 1.5],
                        [0.0, 0.3, 3.5]])
    args = (torch.eye(3), torch.tensor([0.02, 0.0, 0.0]), pts,
            tcam.kb8_project(cam8, pts), torch.ones(6),
            torch.ones(6, dtype=bool))
    res = pose_opt.pose_optimization(*args, cam8, model_id=tcam.KB8)
    assert float(res.t.abs().max()) < 1e-3 and int(res.n_inliers) == 6
    with pytest.raises(ValueError, match="8 parameters"):
        pose_opt.pose_optimization(*args, slam.cam_params,
                                   model_id=tcam.KB8)
