"""Port parity: loop closing in the monocular system (``MonoSlam`` with a
vocabulary and ``use_loop_closing``, the default) against the JAX
package's ``MonoSlam``, frame by frame, and the systems' loop hooks on
planted states.

One JAX system and one port system, both with the runners' 10k-word
vocabulary, loop closing and the background GBA on, run
``SynthWorld(seed=3)`` (the world of the golden frames) rendered at
320x240 (fx = fy = 200, 1024 features, 16 keyframe and 2048 landmark
slots) from t = 0.4 to 2.4 s: the map fills its slots and is compacted,
and from the twelfth keyframe on every keyframe runs the loop detection
(the database's candidates, each candidate's verification ladder); the
sequence closes no loop. Each frame starts from the same state: the port
system is given the JAX system's maps, host state and loop closer
(``convert.carry_loop_closer``: databases, streaks, loop edges); the port's
Sim3 RANSAC takes the JAX rows (``LoopCloser._sim3_indices``); on a
keyframe frame the port runs its own bundle, then takes the JAX bundle's
outputs (``tests/test_torch_reloc_system.py`` says why). About 150 s in
one process (the JAX system compiles once for the module).

Each frame must agree on the state as ``test_torch_reloc_system.py``
holds it, and each detection on its decision: the keyframe it ran on, the
candidates, each verified candidate's BoW match count and whether it
passed the ladder, the streak and whether a loop fired. A one-map run
never reaches the merge branch (``detect_merge``, ROADMAP item 12c).

The planted closure: both systems' ``detect`` return the same candidate
and Sim3 once; ``_run_loop_closing`` must then leave the same map (poses
1e-4, landmarks 1e-3: the pose graph, the fusion), the same last-frame
pose and reference cache (1e-4), and a background GBA in flight on both;
its ticks (one a tracked frame, 10 in all) and its merge must give the
same map (poses 1e-4, landmarks 1e-3, the one-hot and scatter Schur forms
summing in different orders; a landmark the final stage keeps one inlier
observation of has no depth in the solve, and is held by that
observation's reprojection instead, within 0.01 px). Every system takes a
vocabulary with loop closing on and solves its closures in its DoF. The
inertial hooks (``_loops_allowed``,
``_on_map_corrected`` with the body and the world-frame velocity) are held
against the JAX methods on a carried state (1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_loop_closing import jax_row_hook
from test_torch_system import _feats_np, _np_state, _pose, _snapshot, _sync
from torch_port_util import assert_states_close, jax_feats, n

from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
from orbslam3_byzyh_tpu.pipeline import loop_closing as jlc
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import bow as tbow
from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

W, H, F = 320, 240, 200.0
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=16, max_lm=2048, max_obs=8, fps=10,
           min_init_matches=40, kf_ref_min_obs=1, local_window=2,
           ba_window=6, local_lm_window=512, ba_lm_window=512)
CAM = np.array([F, F, W / 2, H / 2], np.float32)
TIMES = [round(t, 3) for t in np.arange(0.4, 2.45, 0.1)]


@functools.cache
def _vocabularies():
    return (jbow.load_vocabulary(str(graft.RELOC_VOCABULARY)),
            tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu"))


def _record_detect(lc, store, jax_side: bool):
    """Wrap ``lc.detect`` (an instance attribute): per call the keyframe,
    the candidates, each verified candidate's BoW count and outcome, the
    streak and whether a loop fired."""
    detect = lc.detect
    if jax_side:
        verify, query_cls = lc._verify, type(lc.db)

    def wrapped(state, kf_id, n_kf):
        rec = {"query": int(kf_id), "n_kf": int(n_kf), "candidates": None,
               "tried": []}
        if jax_side:
            match = jlc.matching.match
            query = query_cls.query_groups

            def spy_query(self, *a, **kw):
                out = query(self, *a, **kw)
                # The port folds the candidates' liveness into the query
                # (a dead one is -1); the JAX caller skips a dead one.
                live = np.asarray(state.kfs.valid)
                rec["mined"] = [int(c) for c in out[0]]
                rec["candidates"] = [int(c) if c >= 0 and live[c] else -1
                                     for c in out[0]]
                return out

            def spy_match(*a, **kw):
                mj, d = match(*a, **kw)
                rec["tried"][-1]["bow"] = int((np.asarray(mj) >= 0).sum())
                return mj, d

            def spy_verify(sq, q, sc, c, db, words):
                rec["tried"].append({"cand": int(c)})
                jlc.matching.match = spy_match
                try:
                    m = verify(sq, q, sc, c, db, words)
                finally:
                    jlc.matching.match = match
                rec["tried"][-1]["passed"] = m is not None
                return m

            lc._verify = spy_verify
            query_cls.query_groups = spy_query
            try:
                det = detect(state, kf_id, n_kf)
            finally:
                lc._verify = verify
                query_cls.query_groups = query
        else:
            det = detect(state, kf_id, n_kf)
            rec["candidates"] = lc.info.get("candidates")
            rec["tried"] = [{"cand": r["cand"], "bow": r["bow"],
                             "passed": r["failed"] is None}
                            for r in lc.info["tried"]]
        rec["streak"] = None if lc._streak is None else lc._streak["count"]
        rec["fired"] = det is not None
        store.append(rec)
        return det

    lc.detect = wrapped


@functools.cache
def _run():
    """Both systems through the sequence, the port from the JAX system's
    state at every frame. Returns the per-frame records, the JAX system,
    the port system and the merge-branch calls the port made."""
    jv, tv = _vocabularies()
    world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F)
    js = jsys.MonoSlam(jsys.SlamConfig(**CFG, vocabulary=jv,
                                       device_mesh=False))
    ts = tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=tv), device="cpu")
    assert js.cfg.use_loop_closing and js.cfg.background_gba
    key = [None]

    def init_indices(matched):
        key[0], sub = jax.random.split(key[0])
        w = jnp.asarray(n(matched).astype(np.float32)) + 1e-9
        return torch.from_numpy(np.array(
            jgeo._sample_indices(sub, 200, 8, w))).long()

    ts._ransac_indices = init_indices
    ts.loop_closer._sim3_indices = jax_row_hook
    merges = []
    ts.loop_closer.detect_merge = lambda *a, **k: merges.append(a)
    detects = {"jax": [], "port": []}
    _record_detect(js.loop_closer, detects["jax"], True)
    _record_detect(ts.loop_closer, detects["port"], False)
    bundles = []
    jax_bundle, port_bundle = jmap.keyframe_bundle, graft.mono_keyframe_step

    def jax_bundle_kept(*a, **k):
        out = jax_bundle(*a, **k)
        bundles.append(out)
        return out

    def port_bundle_then_jax(*a, **k):
        port_bundle(*a, **k)
        st, b, info, culled = bundles[-1]
        return (convert.map_state_to_torch(_np_state(st), "cpu"),
                *(convert.to_torch(np.asarray(x), "cpu")
                  for x in (b, info, culled)))

    patches = [(jgeo, "two_view_reconstruct", jgeo.two_view_reconstruct,
                jax.jit(jgeo.two_view_reconstruct)),
               (jmap, "keyframe_bundle", jax_bundle, jax_bundle_kept),
               (graft, "mono_keyframe_step", port_bundle,
                port_bundle_then_jax)]
    records = []
    try:
        for mod, name, _, new in patches:
            setattr(mod, name, new)
        for w in TIMES:
            img = world.render(float(w))
            f = graft.mono_extract(torch.from_numpy(img).float(),
                                   ts.cam_params, None, ts.mcfg)
            jf = jax_feats(_feats_np(f))
            ts._extract = lambda _, f=f: f
            js._extract = lambda *_, jf=jf, **__: jf
            _sync(ts, js)
            convert.carry_loop_closer(js.loop_closer, ts.loop_closer)
            rec = {"stamp": w}
            k0 = js.rng_key
            for name, slam in (("jax", js), ("port", ts)):
                key[0] = k0
                n_det = len(detects[name])
                pose = _pose(slam.track(img, float(w)))
                snap = _snapshot(slam, pose, name == "jax")
                snap["detect"] = detects[name][n_det:]
                rec[name] = snap
            records.append(rec)
    finally:
        for mod, name, orig, _ in patches:
            setattr(mod, name, orig)
    return records, js, ts, merges


def test_sequence_runs_detection():
    """The reference run fills and compacts its map and runs the loop
    detection on its keyframes once twelve are live: the database yields
    candidates (culled keyframes here, which neither system verifies), and
    none is a loop."""
    records = _run()[0]
    calls = [d for r in records for d in r["jax"]["detect"]]
    ran = [d for d in calls if d["n_kf"] >= 12]
    assert ran, calls
    assert any(c >= 0 for d in ran for c in d["mined"]), ran
    assert not any(d["fired"] for d in calls)
    assert max(r["jax"]["n_kf"] for r in records) >= 12
    print(f"{len(ran)} detections: "
          + "; ".join(f"kf {d['query']} candidates {d['candidates']} "
                      f"tried {d['tried']}" for d in ran))


@pytest.mark.parametrize("i", range(len(TIMES)))
def test_frame_matches_jax(i):
    rec = _run()[0][i]
    ref, got = rec["jax"], rec["port"]
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    np.testing.assert_array_equal(got["kf_parent"], ref["kf_parent"])
    assert (got["pose"] is None) == (ref["pose"] is None)
    if ref["pose"] is not None:
        for a, b in zip(got["pose"], ref["pose"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert_states_close(ref["state"], got["state"], CAM)
    assert len(got["detect"]) == len(ref["detect"])
    for a, b in zip(ref["detect"], got["detect"]):
        assert (b["query"], b["n_kf"], b["streak"], b["fired"]) == (
            a["query"], a["n_kf"], a["streak"], a["fired"])
        if a["n_kf"] >= 12:
            assert b["candidates"] == a["candidates"]
        assert b["tried"] == a["tried"]


def test_one_map_never_merges():
    """With one map in the atlas the merge branch (ROADMAP item 12c) is
    never reached."""
    records, _, ts, merges = _run()
    assert all(r["port"]["n_maps"] == 1 for r in records)
    assert merges == [] and len(ts.atlas.maps) == 1


def _planted_sim3():
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        np.array([0.01, -0.02, 0.005], np.float32))))
    return R, np.array([0.02, -0.01, 0.03], np.float32), 1.03, 120


def _same_maps(js, ts):
    assert_states_close(_np_state(js.state),
                        convert.map_state_to_numpy(ts.state), CAM,
                        pos_atol=1e-3, pose_atol=1e-4)


def test_planted_closure_and_background_gba():
    """Both systems' detection returns the same loop once; the correction,
    the fusion and the background GBA (its ticks and merge) must leave the
    same map and tracking context."""
    _, js, ts, _ = _run()
    _sync(ts, js)
    convert.carry_loop_closer(js.loop_closer, ts.loop_closer)
    kf = js.last_kf_id
    live = np.flatnonzero(np.asarray(js.state.kfs.valid))
    cand = int(live[0])
    assert kf - cand >= 10
    corr = _planted_sim3()
    for slam in (js, ts):
        slam.loop_closer.detect = lambda *a, **k: (cand, corr)
    js._run_loop_closing(kf)
    ts._run_loop_closing(kf)
    _same_maps(js, ts)
    assert [e[:2] for e in ts.loop_closer.loop_edges[0]] == [
        e[:2] for e in js.loop_closer.loop_edges[0]] == [(kf, cand)]
    np.testing.assert_allclose(n(ts._last["R"]), np.asarray(js._last["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(n(ts._last["t"]), np.asarray(js._last["t"]),
                               atol=1e-4)
    assert ts._ref_cache[0] == js._ref_cache[0]
    for a, b in zip(ts._ref_cache[1:], js._ref_cache[1:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert ts._vel is None and js._vel is None
    assert js._bg_gba.active and ts._bg_gba.active
    ticks, inlier = 0, None
    while js._bg_gba.active:
        if ticks == js._bg_gba.stages[0] + 1:
            # The final stage's inlier observations (gated once, after the
            # robust stage).
            inlier = (np.asarray(js._bg_gba._carry[3]),
                      n(ts._bg_gba._carry[3]))
            np.testing.assert_array_equal(inlier[1], inlier[0])
        js._gba_tick()
        ts._gba_tick()
        ticks += 1
    assert not ts._bg_gba.active and ticks == ts._bg_gba.total_iters
    # A landmark left with one inlier observation has no depth in the
    # solve: the packages' float32 steps move it along its ray apart.
    # Those rows are compared by their one observation's reprojection.
    weak = inlier[0].sum(1) < 2
    ref, got = _np_state(js.state), convert.map_state_to_numpy(ts.state)
    np.testing.assert_allclose(got.kfs.R, ref.kfs.R, atol=1e-4)
    np.testing.assert_allclose(got.kfs.t, ref.kfs.t, atol=1e-4)
    live = ref.lms.valid & ~weak
    np.testing.assert_allclose(got.lms.pos[live], ref.lms.pos[live],
                               atol=1e-3)
    rows = np.flatnonzero(ref.lms.valid & weak)
    okf = np.maximum(ref.obs.kf[rows], 0)
    one = inlier[0][rows] & ref.obs.valid[rows]
    R, t_ = ref.kfs.R[okf], ref.kfs.t[okf]
    uv = []
    for pos in (ref.lms.pos, got.lms.pos):
        pc = np.einsum("loij,lj->loi", R, pos[rows]) + t_
        uv.append(pc[..., :2] / pc[..., 2:] * F)
    gap = np.where(one, np.linalg.norm(uv[1] - uv[0], axis=-1), 0.0)
    print(f"{len(rows)} landmarks with one inlier observation; largest "
          f"reprojection gap there {gap.max() if len(rows) else 0.0:.2e} px")
    assert (gap <= 1e-2).all()
    np.testing.assert_allclose(n(ts._last["R"]), np.asarray(js._last["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(n(ts._last["t"]), np.asarray(js._last["t"]),
                               atol=1e-4)


def test_systems_close_loops_with_their_dof():
    """Every system takes a port vocabulary with loop closing on (the
    default); its closures solve Sim3 (mono), SE3 (stereo, RGB-D, the
    inertial systems before the IMU init) or 4 DoF (after it)."""
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial as tsi
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tst
    from orbslam3_byzyh_tpu_torch.solver import pose_graph as tpg
    _, tv = _vocabularies()
    st = dict(CFG, bf=0.2 * F, th_depth=35.0, vocabulary=tv)
    imu = tvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32))
    systems = {
        "mono": (tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=tv),
                               device="cpu"), tpg.DOF_SIM3),
        "stereo": (tst.StereoSlam(tst.StereoConfig(**st), device="cpu"),
                   tpg.DOF_SE3),
        "rgbd": (tst.RgbdSlam(tst.RgbdConfig(**st), device="cpu"),
                 tpg.DOF_SE3),
        "mono_inertial": (tvi.MonoInertialSlam(
            tsys.SlamConfig(**CFG, vocabulary=tv), imu, device="cpu"),
            tpg.DOF_SE3),
        "stereo_inertial": (tsi.StereoInertialSlam(
            tst.StereoConfig(**st), imu, device="cpu"), tpg.DOF_SE3)}
    for name, (slam, dof) in systems.items():
        assert slam.cfg.use_loop_closing and slam.cfg.background_gba, name
        lc = slam.loop_closer
        np.testing.assert_array_equal(n(lc.cam_params), CAM)
        assert lc._posegraph_dof() == dof, name
        if name.endswith("inertial"):
            lc.inertial_4dof = True
            assert lc._posegraph_dof() == tpg.DOF_4, name


def _inertial_pair():
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
              n_features=64, max_kf=16, max_lm=256, max_obs=4, fps=10)
    T_bc = np.eye(4, dtype=np.float32)
    T_bc[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(
        np.array([0.1, -0.05, 0.2], np.float32))))
    T_bc[:3, 3] = [0.05, -0.02, 0.01]
    return (jvi.MonoInertialSlam(jsys.SlamConfig(**kw, device_mesh=False),
                                 jvi.ImuConfig(T_bc=T_bc)),
            tvi.MonoInertialSlam(tsys.SlamConfig(**kw),
                                 tvi.ImuConfig(T_bc=T_bc), device="cpu"))


@pytest.mark.parametrize("ready,stage", [(False, 0), (True, 1), (True, 2),
                                         (True, 3)])
def test_inertial_loops_allowed(ready, stage):
    js, ts = _inertial_pair()
    for slam in (js, ts):
        slam.imu_ready, slam.viba_stage = ready, stage
    assert ts._loops_allowed() == js._loops_allowed() == (ready
                                                          and stage >= 2)


@pytest.mark.parametrize("same_ref", [True, False])
def test_inertial_on_map_corrected(same_ref):
    """The corrected keyframe's pose moved: the last frame follows it, the
    body is rebuilt from it, the world-frame velocity turns with the
    anchor's correction and the carried prior is dropped."""
    js, ts = _inertial_pair()
    rng = np.random.default_rng(5)
    kf = 3
    R_old = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(
        0, 0.3, 3).astype(np.float32))))
    t_old = rng.normal(0, 1, 3).astype(np.float32)
    R_new = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(
        0, 0.05, 3).astype(np.float32)))) @ R_old
    t_new = (t_old + rng.normal(0, 0.1, 3)).astype(np.float32)
    R_last = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(
        0, 0.02, 3).astype(np.float32)))) @ R_old
    t_last = (t_old + rng.normal(0, 0.05, 3)).astype(np.float32)
    v = rng.normal(0, 1, 3).astype(np.float32)
    for slam, jax_side in ((js, True), (ts, False)):
        st = slam.state
        R = np.asarray(n(st.kfs.R)).copy()
        t_ = np.asarray(n(st.kfs.t)).copy()
        R[kf], t_[kf] = R_new, t_new
        if jax_side:
            slam.state = st._replace(kfs=st.kfs._replace(
                R=jnp.asarray(R), t=jnp.asarray(t_)))
            body = (jnp.eye(3), jnp.zeros(3), jnp.asarray(v))
        else:
            slam.state = st._replace(kfs=st.kfs._replace(
                R=torch.from_numpy(R), t=torch.from_numpy(t_)))
            body = (torch.eye(3), torch.zeros(3), torch.from_numpy(v))
        slam.imu_ready = True
        slam.last_kf_id = kf
        slam._last = dict(feats=None, bindings=None, R=R_last.copy(),
                          t=t_last.copy(), stamp=1.0)
        slam._ref_cache = ((kf if same_ref else kf - 1), R_old.copy(),
                           t_old.copy())
        slam._body = body
        slam._pose_prior_H = "carried"
        slam._vel = "carried"
        slam._on_map_corrected(kf)
    for a, b in ((ts._last["R"], js._last["R"]),
                 (ts._last["t"], js._last["t"])):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    for a, b in zip(ts._body, js._body):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    assert ts._pose_prior_H is None and js._pose_prior_H is None
    assert ts._vel is None and js._vel is None
    assert (ts._corr_Rw is None) == (js._corr_Rw is None)
    if js._corr_Rw is not None:
        np.testing.assert_allclose(ts._corr_Rw, js._corr_Rw, atol=1e-5)
    assert ts._ref_cache[0] == js._ref_cache[0] == kf
