"""Port parity: the monocular-inertial system
(``pipeline/inertial_system.MonoInertialSlam``) against the JAX package's,
frame by frame, and its methods on planted states.

A short ``SynthWorld(seed=3, motion="excited")`` sequence rendered here at
320x240 (fx = fy = 200, 1024 features) with its 200 Hz IMU (the noise of
``ImuConfig``'s defaults from ``default_rng(7)``) goes through both systems
with the same configuration (no vocabulary; the JAX system's loop closing
and background GBA off), VI-BA 12 / 6 / 1024 / 32. Both get the port's
extracted features, and the port's RANSAC takes the indices the JAX system
draws (as tests/test_torch_system.py). Both systems get the IMU-init gates
lowered to 4 chain keyframes and 0.8 s (the defaults, 10 and 2 s, put the
init past a run short enough for the CPU).

Each frame starts from the same state: before it the port system is given
the JAX system's map, host state and inertial state
(``convert.carry_inertial_state``). On a frame that hosts a keyframe the
port runs its own keyframe work and then takes the JAX system's map,
velocities and biases after its bundle and its local BA (the visual
windowed BA before the IMU init, the local VI-BA after): the early map's
windowed BA is chaotic in both packages (tests/test_torch_stereo_system.py
measured it), and the VI-BA is held against the JAX package in
tests/test_torch_inertial_ba.py and test_torch_vi_map_step.py. The IMU
init's refit and full VI-BA are the port's own.

Each frame must agree: the status, ``imu_ready``, ``viba_stage``, the
chain (``kf_prev``) and stamps, the counters, the reference keyframe, the
pose (1e-4), the body state (1e-4; velocity 1e-3 m/s), the frame biases
(1e-5), ``kf_vel`` (1e-3 m/s), ``kf_bg`` / ``kf_ba`` (1e-5), the chain's
preintegrations (1e-5), the carried prior's presence, and the map
(``assert_states_close``). The intended differences: the port fills the
stamp of an init keyframe when the map is made, with the device's float32
value, where the JAX system reads that value back later; the comparison
takes the JAX keyframe's device stamp where its host mirror is empty. And
the port's VI-BA write-back recounts a landmark that lost an observation
to the gate and kills it below 2 live observations, where the JAX one
keeps its stale count and liveness (a repaired fault of the reference):
``recount_repair`` holds the port to the JAX map with that repair.

Planted-state cases against the JAX methods: the inertial keyframe policy,
the dispatched cull with its re-integration, the forced culling valve,
the compaction's remap, the scale refinement, the schedule's VIBA1,
VIBA2 and scale-refinement transitions, the bad-IMU reset, the device
default and the committed fixtures re-rendered bit for bit.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_system import _feats_np, _np_state, _pose, _sync
from torch_port_util import assert_states_close, jax_feats, n

from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_vi_frames as fixture  # noqa: E402

W, H, F = 320, 240, 200.0
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=16, max_lm=2048, max_obs=8, fps=10,
           min_init_matches=40, kf_ref_min_obs=3, local_window=2,
           ba_window=6, local_lm_window=512, ba_lm_window=512)
CAM = np.array([F, F, W / 2, H / 2], np.float32)
VIBA = dict(viba_window=12, viba_free=6, viba_landmarks=1024,
            full_viba_kf=32)
INIT_GATES = dict(imu_init_min_kf=4, imu_init_min_time=0.8)
STAMPS = np.round(np.arange(0.4, 2.6, 0.1), 3)
# A blank frame (no features): RECENTLY_LOST, dead-reckoned on the IMU.
BLANK = (17,)


# --- Shared with tests/test_torch_stereo_inertial_system.py -----------------

def imu_cfgs():
    return (jvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32)),
            tvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32)))


def imu_batches(world, stamps, seed):
    """Each frame's IMU batch, drawn as the JAX tests draw them."""
    cfg = imu_cfgs()[0]
    rng = np.random.default_rng(seed)
    gn = cfg.gyro_noise * np.sqrt(cfg.freq)
    an = cfg.acc_noise * np.sqrt(cfg.freq)
    out, prev = [], None
    for s in stamps:
        out.append(None if prev is None else world.imu(
            prev, float(s), freq=cfg.freq, gyro_noise=gn, acc_noise=an,
            rng=rng))
        prev = float(s)
    return out


def sync_vi(ts, js):
    """Give the port system the JAX system's whole state."""
    _sync(ts, js)
    convert.carry_inertial_state(js, ts)
    ts._cur_stamp = getattr(js, "_cur_stamp", None)


def _np(x):
    return None if x is None else np.asarray(x) if not isinstance(
        x, torch.Tensor) else n(x)


def snapshot_vi(slam, pose, jax_side):
    d = dict(
        pose=pose, status=slam.status, n_kf=slam.n_kf, n_lm=slam.n_lm,
        last_kf_id=slam.last_kf_id, frames_since_kf=slam.frames_since_kf,
        n_maps=len(slam.atlas.maps), kf_parent=slam.kf_parent.copy(),
        refs=list(slam._traj.refs), close=tuple(slam._close_counts),
        bindings=(None if slam._last is None
                  else _np(slam._last["bindings"])),
        state=(_np_state(slam.state) if jax_side
               else convert.map_state_to_numpy(slam.state)),
        imu_ready=slam.imu_ready, viba_stage=slam.viba_stage,
        map_first_kf=slam.map_first_kf, kf_prev=slam.kf_prev.copy(),
        kf_stamp=slam.kf_stamp.copy(),
        body=(None if slam._body is None
              else tuple(_np(x) for x in slam._body)),
        bias=np.array(slam._bias), kf_vel=_np(slam.kf_vel),
        kf_bg=_np(slam.kf_bg), kf_ba=_np(slam.kf_ba),
        prior=slam._pose_prior_H is not None,
        preint=[None if q is None else (_np(q.dR), _np(q.dV), _np(q.dP),
                                        float(_np(q.dT)))
                for q in slam.kf_preint])
    return d


# The per-frame tolerances: keyframe poses and the body's R and p, the
# body's velocity and kf_vel, the gyro and accelerometer biases, landmark
# positions (m).
TOL = dict(pose=1e-4, vel=1e-3, bg=1e-5, ba=1e-5, lm=1e-3)


def recount_repair(ref_state, got_state):
    """The JAX map with the port's repair of the VI-BA write-back applied
    (the intended difference, ROADMAP section 3): the JAX write-back gates
    outlier observations off but keeps the landmarks' ``n_obs`` and
    liveness, so a landmark's count can exceed its live observations; the
    port recounts such a landmark and kills it below 2. Every landmark
    where the two maps' count or liveness differ must be one whose JAX
    count is stale, with the port's count its live observations and the
    port's liveness the JAX liveness gated at 2. Returns the JAX map with
    those rows as the port has them."""
    rl, gl = ref_state.lms, got_state.lms
    obs = ref_state.obs
    live = (obs.valid & (obs.kf >= 0)).sum(-1)
    diff = (rl.n_obs != gl.n_obs) | (rl.valid != gl.valid)
    assert np.all(rl.n_obs[diff] > live[diff]), np.flatnonzero(diff)
    np.testing.assert_array_equal(gl.n_obs[diff], live[diff])
    np.testing.assert_array_equal(gl.valid[diff],
                                  rl.valid[diff] & (live[diff] >= 2))
    return ref_state._replace(lms=rl._replace(
        n_obs=np.where(diff, gl.n_obs, rl.n_obs),
        valid=np.where(diff, gl.valid, rl.valid)))


def assert_same_vi(ref, got, **tol):
    tol = {**TOL, **tol}
    ref = {**ref, "state": recount_repair(ref["state"], got["state"])}
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs", "close", "imu_ready", "viba_stage",
              "map_first_kf", "prior"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    np.testing.assert_array_equal(got["kf_parent"], ref["kf_parent"])
    np.testing.assert_array_equal(got["kf_prev"], ref["kf_prev"])
    # The port fills an init keyframe's stamp at once; the JAX system's
    # host mirror holds it once read: its device stamp.
    want = ref["kf_stamp"].copy()
    live = np.flatnonzero(np.isnan(want) & ref["state"].kfs.valid)
    want[live] = ref["state"].kfs.stamp[live].astype(np.float64)
    np.testing.assert_array_equal(got["kf_stamp"], want)
    assert (got["pose"] is None) == (ref["pose"] is None)
    if ref["pose"] is not None:
        for a, b in zip(got["pose"], ref["pose"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert (got["bindings"] is None) == (ref["bindings"] is None)
    if ref["bindings"] is not None:
        np.testing.assert_array_equal(got["bindings"], ref["bindings"])
    assert (got["body"] is None) == (ref["body"] is None)
    if ref["body"] is not None:
        for a, b, at in zip(got["body"], ref["body"],
                            (tol["pose"], tol["pose"], tol["vel"])):
            np.testing.assert_allclose(a, b, atol=at)
    np.testing.assert_allclose(got["bias"][:3], ref["bias"][:3],
                               atol=tol["bg"])
    np.testing.assert_allclose(got["bias"][3:], ref["bias"][3:],
                               atol=tol["ba"])
    np.testing.assert_allclose(got["kf_vel"], ref["kf_vel"], atol=tol["vel"])
    np.testing.assert_allclose(got["kf_bg"], ref["kf_bg"], atol=tol["bg"])
    np.testing.assert_allclose(got["kf_ba"], ref["kf_ba"], atol=tol["ba"])
    for k, (a, b) in enumerate(zip(got["preint"], ref["preint"])):
        assert (a is None) == (b is None), k
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, atol=1e-5, err_msg=str(k))
    assert_states_close(ref["state"], got["state"], CAM, pos_atol=tol["lm"],
                        pose_atol=tol["pose"])
    # The JAX VI-BA's write-back gates observations off without recounting
    # the landmarks' support (ROADMAP section 3), which the port repairs:
    # the port's map has the findings of the JAX map with the repair
    # applied, no others.
    assert (tms.check_invariants(
        convert.map_state_to_torch(got["state"], "cpu"), got["n_kf"],
        ref["state"].lms.valid.shape[0]) == tms.check_invariants(
            convert.map_state_to_torch(ref["state"], "cpu"), ref["n_kf"],
            ref["state"].lms.valid.shape[0]))


class KeyframeWork:
    """The JAX system's map after its keyframe bundle and its local BA,
    given to the port system after the port's own ran (the module
    docstring says why). ``install()`` patches both packages; ``restore()``
    puts them back."""

    def __init__(self, js):
        self.js = js
        self.bundles, self.refined = [], []

    def install(self):
        js, self_ = self.js, self
        self.saved = (jmap.keyframe_bundle, graft.mono_keyframe_step,
                      tmap.windowed_local_ba, tvi.local_inertial_ba,
                      type(js)._local_refine)

        def jax_bundle(*a, **k):
            out = self_.saved[0](*a, **k)
            self_.bundles.append(out)
            return out

        def port_bundle(*a, **k):
            self_.saved[1](*a, **k)
            st, b, info, culled = self_.bundles[-1]
            return (convert.map_state_to_torch(_np_state(st), "cpu"),
                    *(convert.to_torch(np.asarray(x), "cpu")
                      for x in (b, info, culled)))

        def jax_refine(slam, kf_id, counts, order):
            self_.saved[4](slam, kf_id, counts, order)
            self_.refined.append((_np_state(slam.state),
                                  *(np.asarray(x) for x in (
                                      slam.kf_vel, slam.kf_bg, slam.kf_ba))))

        def adopt(imap=None, state=None):
            st, v, bg, ba = self_.refined[-1]
            s = convert.map_state_to_torch(st, "cpu")
            if imap is None:
                return s
            return imap._replace(state=s, kf_vel=convert.to_torch(v, "cpu"),
                                 kf_bg=convert.to_torch(bg, "cpu"),
                                 kf_ba=convert.to_torch(ba, "cpu"))

        def port_windowed(*a, **k):
            self_.saved[2](*a, **k)
            return adopt()

        def port_viba(imap, *a, **k):
            self_.saved[3](imap, *a, **k)
            return adopt(imap)

        jmap.keyframe_bundle = jax_bundle
        graft.mono_keyframe_step = port_bundle
        tmap.windowed_local_ba = port_windowed
        tvi.local_inertial_ba = port_viba
        type(js)._local_refine = jax_refine

    def restore(self):
        (jmap.keyframe_bundle, graft.mono_keyframe_step,
         tmap.windowed_local_ba, tvi.local_inertial_ba,
         type(self.js)._local_refine) = self.saved


# --- The monocular sequence -------------------------------------------------

def _pair():
    ji, ti = imu_cfgs()
    js = jvi.MonoInertialSlam(jsys.SlamConfig(
        **CFG, use_loop_closing=False, background_gba=False,
        device_mesh=False), ji, **VIBA)
    ts = tvi.MonoInertialSlam(tsys.SlamConfig(**CFG), ti, **VIBA,
                              device="cpu")
    for slam in (js, ts):
        for k, v in INIT_GATES.items():
            setattr(slam, k, v)
    return js, ts


@functools.cache
def _run():
    """Both systems through the sequence, the port from the JAX system's
    state at every frame: per frame a record of each side and what the
    JAX frame was (prior carried in, keyframe); and the trajectories."""
    world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F, motion="excited")
    imus = imu_batches(world, STAMPS, 7)
    js, ts = _pair()
    key = [jax.random.PRNGKey(0)]

    def jax_indices(matched):
        key[0], sub = jax.random.split(key[0])
        w = jnp.asarray(n(matched).astype(np.float32)) + 1e-9
        return torch.from_numpy(np.array(
            jgeo._sample_indices(sub, 200, 8, w))).long()

    ts._ransac_indices = jax_indices
    work = KeyframeWork(js)
    saved = jgeo.two_view_reconstruct
    records = []
    try:
        jgeo.two_view_reconstruct = jax.jit(saved)
        work.install()
        for i, stamp in enumerate(STAMPS):
            img = (np.full((H, W), 30, np.uint8) if i in BLANK
                   else world.render(float(stamp)))
            f = graft.mono_extract(torch.from_numpy(img), ts.cam_params,
                                   None, ts.mcfg)
            jf = jax_feats(_feats_np(f))
            ts._extract = lambda _, f=f: f
            js._extract = lambda *_, jf=jf, **__: jf
            sync_vi(ts, js)
            rec = {"stamp": stamp, "prior_in": js._pose_prior_H is not None,
                   "ready_in": js.imu_ready}
            n_b = len(work.bundles)
            for name, slam in (("jax", js), ("port", ts)):
                pose = _pose(slam.track(img, float(stamp), imus[i]))
                rec[name] = snapshot_vi(slam, pose, name == "jax")
                if name == "jax":
                    rec["keyframe"] = len(work.bundles) > n_b
            records.append(rec)
        out = {name: slam.trajectory for name, slam in (("jax", js),
                                                        ("port", ts))}
    finally:
        jgeo.two_view_reconstruct = saved
        work.restore()
    return records, out, js


def test_sequence_does_its_work():
    """Pre-init visual frames, the IMU-init keyframe, inertial frames with
    and without the carried prior, an inertial keyframe with its local
    VI-BA, and a RECENTLY_LOST frame, in the JAX run."""
    records = _run()[0]
    ref = [r["jax"] for r in records]
    kinds = set()
    for r in records:
        if r["ready_in"]:
            kinds.add("prior" if r["prior_in"] else "no prior")
            if r["keyframe"]:
                kinds.add("inertial keyframe")
        elif r["jax"]["imu_ready"]:
            kinds.add("init keyframe")
        elif r["jax"]["status"] == tsys.OK and r["jax"]["n_kf"] >= 2:
            kinds.add("visual")
    assert kinds >= {"visual", "init keyframe", "prior", "no prior",
                     "inertial keyframe"}, kinds
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


# --- Planted states ---------------------------------------------------------

def _end_pair():
    """A copy of the JAX system after the sequence, and a port system given
    its state."""
    import copy
    js = copy.deepcopy(_run()[2])
    ts = _pair()[1]
    sync_vi(ts, js)
    return js, ts


def _same_now(js, ts, **tol):
    assert_same_vi(snapshot_vi(js, None, True), snapshot_vi(ts, None, False),
                   **tol)


def _policy_pair():
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
              n_features=256, max_kf=32, max_lm=1024, max_obs=4, fps=10)
    ji, ti = imu_cfgs()
    return (jvi.MonoInertialSlam(jsys.SlamConfig(**kw, device_mesh=False),
                                 ji),
            tvi.MonoInertialSlam(tsys.SlamConfig(**kw), ti, device="cpu"))


# (IMU ready, seconds since the last keyframe, status, inliers, reference
# matches, frames since the keyframe, the decision): the pre-init 0.25 s
# cadence alone; after the init the mono rules, c3 (0.5 s) and c4 (15 <
# inliers < 75, or RECENTLY_LOST).
POLICY = [(False, 0.2, tsys.OK, 30, 200, 1, False),
          (False, 0.3, tsys.OK, 190, 200, 1, True),
          (True, 0.1, tsys.OK, 190, 200, 1, False),
          (True, 0.1, tsys.OK, 160, 200, 1, True),
          (True, 0.6, tsys.OK, 190, 200, 1, True),
          (True, 0.1, tsys.OK, 60, 60, 1, True),
          (True, 0.1, tsys.OK, 10, 10, 1, False),
          (True, 0.1, tsys.RECENTLY_LOST, 190, 200, 1, True)]


@pytest.mark.parametrize("ready,dt,status,inliers,ref,frames,want", POLICY)
def test_keyframe_policy_matches_jax(ready, dt, status, inliers, ref,
                                     frames, want):
    js, ts = _policy_pair()
    for slam in (js, ts):
        slam.imu_ready = ready
        slam.n_kf = 3
        slam.last_kf_id = 2
        slam.kf_stamp[:3] = [0.0, 0.3, 0.6]
        slam._cur_stamp = 0.6 + dt
        slam.status = status
        slam.frames_since_kf = frames
    assert js._need_new_keyframe(inliers, ref_matches=ref) == want
    assert ts._need_new_keyframe(inliers, ref_matches=ref) == want


def test_dispatched_cull_matches_jax():
    """``_maybe_cull_keyframes`` dispatches the same candidate; a planted
    decision on a mid-chain keyframe then goes through
    ``_apply_pending_cull`` and ``_cull_chain_keyframe`` in both packages:
    the chain relinked, the successor's preintegration re-integrated
    across the gap, the keyframe dropped, the tree and records reattached."""
    js, ts = _end_pair()
    kf = js.last_kf_id
    assert js.n_kf >= 8
    js._maybe_cull_keyframes(kf)
    ts._maybe_cull_keyframes(kf)
    assert (js._pending_cull is None) == (ts._pending_cull is None)
    if js._pending_cull is not None:
        np.testing.assert_allclose(n(ts._pending_cull),
                                   np.asarray(js._pending_cull), atol=1e-6)
    best = js._chain(kf)[-6]
    nx = int(np.flatnonzero(js.kf_prev == best)[0])
    js._pending_cull = jnp.asarray([best, 0.95], jnp.float32)
    sync_vi(ts, js)
    js._apply_pending_cull()
    ts._apply_pending_cull()
    assert ts.kf_prev[nx] == js.kf_prev[nx] != best
    assert not n(ts.state.kfs.valid)[best]
    dt = float(js.kf_stamp[nx] - js.kf_stamp[js.kf_prev[nx]])
    assert abs(float(n(ts.kf_preint[nx].dT)) - dt) < 1e-5
    _same_now(js, ts)


def test_force_cull_matches_jax():
    """TestForceCullValve on both packages: the same culls (the sequence's
    map has one keyframe outside the 8 newest and keyframe 0), the chain
    still reaches the map's first keyframe, each hop's preintegration
    spans its gap; the same state after."""
    js, ts = _end_pair()
    freed = js._force_cull_keyframes(2)
    assert ts._force_cull_keyframes(2) == freed >= 1
    ids = ts._chain(ts.last_kf_id)
    assert ids[0] == ts.map_first_kf
    valid = n(ts.state.kfs.valid)
    assert valid[ids].all()
    for k in ids[1:]:
        dt = ts.kf_stamp[k] - ts.kf_stamp[ts.kf_prev[k]]
        assert abs(float(n(ts.kf_preint[k].dT)) - dt) < 1e-3
    _same_now(js, ts)


def test_compaction_remap_matches_jax():
    """``_on_keyframes_compacted`` after a chain cull: the velocities,
    biases, stamps, chain and preintegrations follow the new slots."""
    js, ts = _end_pair()
    js._force_cull_keyframes(1)
    sync_vi(ts, js)
    old2new = np.full(js.cfg.max_kf, -1, np.int32)
    live = np.flatnonzero(np.asarray(js.state.kfs.valid))
    old2new[live] = np.arange(len(live))
    js._on_keyframes_compacted(old2new)
    ts._on_keyframes_compacted(old2new)
    j, t_ = snapshot_vi(js, None, True), snapshot_vi(ts, None, False)
    np.testing.assert_array_equal(t_["kf_prev"], j["kf_prev"])
    np.testing.assert_array_equal(t_["kf_stamp"], j["kf_stamp"])
    for k in ("kf_vel", "kf_bg", "kf_ba"):
        np.testing.assert_array_equal(t_[k], j[k])
    assert t_["map_first_kf"] == j["map_first_kf"]
    assert [p is None for p in t_["preint"]] == [p is None
                                                 for p in j["preint"]]


def test_scale_refinement_matches_jax():
    """TestScaleRefinement's 10 % scale error injected into the map and
    the velocities of both packages; ``_scale_refinement`` must undo it the
    same way (the keyframe translations shrink by the same ratio)."""
    js, ts = _end_pair()
    s_err = 1.10
    kfs, lms = js.state.kfs, js.state.lms
    js.state = js.state._replace(
        kfs=kfs._replace(t=s_err * kfs.t),
        lms=lms._replace(pos=s_err * lms.pos, min_dist=s_err * lms.min_dist,
                         max_dist=s_err * lms.max_dist))
    js.kf_vel = s_err * js.kf_vel
    sync_vi(ts, js)
    t_before = np.asarray(js.state.kfs.t)
    kf = js.last_kf_id
    js._scale_refinement(kf)
    ts._scale_refinement(kf)
    sel = np.linalg.norm(t_before, axis=-1) > 0.1

    def ratio(t_after):
        return np.median(np.linalg.norm(t_after[sel], axis=-1)
                         / np.linalg.norm(t_before[sel], axis=-1))
    r_j, r_t = ratio(np.asarray(js.state.kfs.t)), ratio(n(ts.state.kfs.t))
    assert r_t < 1.0 and abs(r_t - r_j) < 1e-3 * r_j, (r_t, r_j)
    # The 2 s chain holds the scale loosely: the two solves end 8e-4 apart
    # (0.9525 and 0.9533 here), which scales the keyframe translations
    # (up to 0.2 m) and the landmarks (up to 5 m) with it.
    _same_now(js, ts, pose=5e-4, lm=5e-3)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_schedule_transition_matches_jax(stage):
    """``_imu_schedule`` at a span past each stage's gate: VIBA1 (the
    refit at (1, 1e5) and the full VI-BA, stage 2), VIBA2 ((0, 0), stage
    3), and the monocular scale refinement (its next check 10 s later)."""
    js, ts = _end_pair()
    span = {1: 5.5, 2: 15.5, 3: 25.5}[stage]
    kf = js.last_kf_id
    for slam in (js, ts):
        slam.viba_stage = stage
    stamp = float(js.kf_stamp[js.map_first_kf]) + span
    js._imu_schedule(kf, stamp)
    ts._imu_schedule(kf, stamp)
    assert ts.viba_stage == js.viba_stage == min(stage + 1, 3)
    assert ts._next_scale_refine == js._next_scale_refine == (
        35.0 if stage == 3 else 25.0)
    # VIBA2 has no bias prior: on the 2 s chain the accelerometer bias is
    # barely observable and the two solves end 5e-3 m/s^2 apart, moving
    # the keyframe rotations by up to 5e-4.
    _same_now(js, ts, **({} if stage != 2 else
                         dict(pose=1e-3, ba=1e-2, lm=5e-3)))


def test_bad_imu_resets_the_map():
    """Five non-finite IMU inits condemn the active map in both packages
    (mbBadImu): the map resets and the inertial machinery restarts."""
    js, ts = _end_pair()
    for slam in (js, ts):
        slam._inertial_refit = lambda *_: float("nan")
        for i in range(5):
            assert slam.status != tsys.NOT_INITIALIZED
            slam._initialize_imu(slam.last_kf_id)
        assert slam.status == tsys.NOT_INITIALIZED
        assert not slam.imu_ready and slam._imu_init_failures == 0
        assert (slam.kf_prev == -1).all() and np.isnan(slam.kf_stamp).all()
    assert ts.n_kf == js.n_kf and len(ts.atlas.maps) == len(js.atlas.maps)


@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_fixture_is_the_renderers(kind):
    """``tests/golden/frames_vi_{stereo,mono}.npz`` re-rendered: every
    array bit for bit (the frames, the IMU samples, the truth)."""
    fresh = fixture.vi_arrays(kind)
    path = graft.VI_STEREO_FRAMES if kind == "stereo" else \
        graft.VI_MONO_FRAMES
    with np.load(path) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    g = graft.vi_stereo_frames() if kind == "stereo" else \
        graft.vi_mono_frames()
    assert g.left.shape == ((40 if kind == "stereo" else 65), 480, 640)
    assert g.imu(0) is None and len(g.imu(1)[0]) == 20
