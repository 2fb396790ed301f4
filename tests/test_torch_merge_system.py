"""Port parity: the systems' atlas merge (``MonoSlam._merge_maps`` and the
inertial ``_merge_maps``) against the JAX package's, on carried states.

Monocular: a JAX ``MonoSlam`` and a port one with the runners' 10k-word
vocabulary hold the same two maps (``SIZES``: map B and map A, apart by
the planted Sim3 of scale 0.8), databases, spanning trees, loop edges,
frozen trajectory records and tracking context, and weld map A into map B
at B's newest keyframe through the same Sim3 (the plant's inverse, as
``detect_merge`` returns it). The weld (the state the fusion
receives) must agree exactly in its integers and within 1e-5 in its
floats, the fusion's bindings (observations, liveness, counts) exactly,
the merge BA's poses and landmarks within 1e-3 (a low-parallax landmark
beyond it within 0.02 px of reprojection, as ``assert_states_close``
holds such rows); the databases, loop edges,
spanning tree, frozen records and tracking context as well. (On
``euroc_merge_atlas``'s circuit, whose points each two keyframes see, the
global BA's scale is free link by link and the two packages' LM steps end
centimetres apart at equal cost: its windowed BA is held here, and the
global BA on ``euroc_mono_map``'s multi-view map.)

Inertial: a JAX ``StereoInertialSlam`` and a port one at
``test_torch_vi_step.py``'s small EuRoC stereo-inertial capacity, the IMU
initialised and past VIBA2 (``viba_stage`` 2), map B
``graft.euroc_vi_map`` (24 keyframes with their chain, preintegrations,
velocities and biases) and map A another of its maps moved away; both
weld A into B at B's newest keyframe and run the local VI-BA. Poses,
landmarks, velocities and biases within 1e-3 (biases of the gyroscope
1e-4), the body and the last frame's pose. The JAX system keeps one
velocity and bias array for all keyframe slots, and the weld does not
move them into the transplanted slots; the merge-time VI-BA's window is
the active map's chain, which no transplanted slot joins, so it reads no
transplanted velocity or bias: the port's run with those slots set to NaN
gives the same result bit for bit.

Live: the port's ``MonoSlam`` plays the small merge cell "s" (map A, a
blackout, the revisit at 320x240) and must merge on the keyframe and
candidate of the JAX MonoSlam's run of the same frames, recorded by
``scripts/merge_reference_jax.py s`` (``graft.MERGE_JAX["s"]``): that run
takes about 4.5 minutes on the CPU, past this file's budget, so the JAX
system is not run here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from synth_world import SynthWorld
from test_torch_vi_map_step import _set_map
from test_torch_vi_step import SMALL
from torch_port_util import assert_states_close, jax_map_state, n

from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu.pipeline import trajectory_log as jtl
from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
    StereoInertialSlam as JStereoInertialSlam
from orbslam3_byzyh_tpu.pipeline.stereo_system import \
    StereoConfig as JStereoConfig
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import bow as tbow
from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys
from orbslam3_byzyh_tpu_torch.pipeline import trajectory_log as ttl
from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
    StereoInertialSlam as TStereoInertialSlam
from orbslam3_byzyh_tpu_torch.pipeline.stereo_system import \
    StereoConfig as TStereoConfig

_SMALL = dict(width=376, height=240, fx=229.327, fy=228.648, cx=183.6075,
              cy=124.1875, n_features=256, max_obs=8, n_local_lm=512,
              local_window=4, ba_window=32, ba_lm_window=512)
# "global": graft.euroc_mono_map's 20 keyframes (map B) and the same map
# moved through the plant (map A): 40 keyframes at 64 slots, welded at B's
# newest keyframe, the fusion killing the duplicates it sees, the global
# BA. "windowed": graft.euroc_merge_atlas at 70 keyframes of 60-point
# patches and 96 slots (the windowed BA past 64 keyframes).
SIZES = {"global": graft.MonoConfig(max_kf=64, max_lm=4096, **_SMALL),
         "windowed": graft.MonoConfig(max_kf=96, max_lm=8192, **_SMALL)}


def _mono_case(size):
    """(config, the two maps' states, keyframe counts, landmark rows,
    spanning trees, the plant (R, t, s): x_B = s R x_A + t, map B's
    misplaced keyframe and its true centre or None)."""
    cfg = SIZES[size]
    if size == "windowed":
        m = graft.euroc_merge_atlas(cfg, n_kf=70, n_pts=60)
        return (cfg, m.maps, m.n_kf, m.n_lm, m.kf_parent, m.plant,
                (1, m.c_true_b[1]))
    mb = graft.euroc_mono_map(cfg, n_live_kf=20, view_points=600)
    st = mb.state
    kf_live = np.arange(cfg.max_kf) < mb.kf_id
    # The live landmarks moved to the first rows (the merge appends rows
    # after the counter).
    order = np.argsort(~st.lms.valid, kind="stable")
    st = st._replace(kfs=st.kfs._replace(valid=st.kfs.valid & kf_live),
                     lms=type(st.lms)(*(a[order] for a in st.lms)),
                     obs=type(st.obs)(*(a[order] for a in st.obs)))
    R_p = Rotation.from_rotvec(graft.MERGE_PLANT_ROTVEC).as_matrix()
    t_p, s_p = np.asarray(graft.MERGE_PLANT_T), graft.MERGE_PLANT_S
    # Map A in its own world: x_A = (x_B - t) R / s.
    kfs, lms = st.kfs, st.lms
    R_a = kfs.R.astype(np.float64) @ R_p
    t_a = (kfs.t + np.einsum("kij,j->ki", kfs.R.astype(np.float64),
                             t_p)) / s_p
    st_a = st._replace(
        kfs=kfs._replace(R=R_a.astype(np.float32), t=t_a.astype(np.float32)),
        lms=lms._replace(pos=((lms.pos - t_p) @ R_p / s_p).astype(np.float32),
                         normal=(lms.normal @ R_p).astype(np.float32),
                         min_dist=(lms.min_dist / s_p).astype(np.float32),
                         max_dist=(lms.max_dist / s_p).astype(np.float32)))
    n_lm = int(lms.valid.sum())
    par = np.full(cfg.max_kf, -1, np.int32)
    par[1:mb.kf_id] = np.arange(mb.kf_id - 1)
    return (cfg, (st_a, st), (mb.kf_id, mb.kf_id), (n_lm, n_lm), (par, par),
            (R_p, t_p, s_p), None)


@functools.cache
def _vocabularies():
    return (jbow.load_vocabulary(str(graft.RELOC_VOCABULARY)),
            tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu"))


def _slam_fields(cfg: graft.MonoConfig) -> dict:
    return dict(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                width=cfg.width, height=cfg.height,
                n_features=cfg.n_features, max_kf=cfg.max_kf,
                max_lm=cfg.max_lm, max_obs=cfg.max_obs,
                local_window=cfg.local_window, ba_window=cfg.ba_window,
                ba_lm_window=cfg.ba_lm_window,
                local_lm_window=cfg.n_local_lm, fps=10)


def _fill(js, ts, states, n_kf, n_lm, parents, current):
    """Both systems' atlas, databases and spanning trees from numpy."""
    js.atlas.maps = [jax_map_state(s) for s in states]
    js.atlas.meta = [jsys.atlas_mod.MapMeta(k, lm, p.copy()) for k, lm, p in
                     zip(n_kf, n_lm, parents)]
    js.atlas.current = current
    lc = js.loop_closer
    lc.dbs = {}
    for idx, (st, k) in enumerate(zip(js.atlas.maps, n_kf)):
        lc.switch_map(idx)
        for kf in range(k):
            lc.add_keyframe(st, kf)
    lc.switch_map(current, fresh=False)
    ts.atlas = convert.atlas_to_torch(js.atlas, "cpu")
    convert.carry_loop_closer(lc, ts.loop_closer)


def _context(js, ts, kf_id):
    """The same tracking context: the last frame at keyframe ``kf_id``'s
    pose, the reference cache, frozen records of map 0 and of map 1."""
    R = np.asarray(js.state.kfs.R[kf_id])
    t = np.asarray(js.state.kfs.t[kf_id])
    rng = np.random.default_rng(9)
    for slam, tl in ((js, jtl), (ts, ttl)):
        slam.last_kf_id = kf_id
        slam._last = dict(feats=None, bindings=None, R=R.copy(), t=t.copy(),
                          stamp=1.0)
        slam._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        slam._traj = tl.TrajectoryLog()
    for i in range(6):
        Rf = Rotation.random(random_state=i).as_matrix().astype(np.float32)
        tf = rng.normal(size=3).astype(np.float32)
        for slam in (js, ts):
            slam._traj.log(0.1 * i, Rf, tf, -1)
            slam._traj.tags[-1] = i % 2
    js._refresh_ref_cache()
    ts._refresh_ref_cache()


def _spy_fusion(monkeypatch, module, store):
    fuse = module.fuse_duplicates

    def spy(state, *a, **kw):
        out = fuse(state, *a, **kw)
        store.append((state, out))
        return out

    monkeypatch.setattr(module, "fuse_duplicates", spy)


def _np(state):
    if isinstance(state.kfs.R, torch.Tensor):
        return convert.map_state_to_numpy(state)
    return jax.tree.map(np.asarray, state)


def _assert_weld_equal(ref, got):
    for group in ("kfs", "lms", "obs"):
        for name in getattr(ref, group)._fields:
            x = getattr(getattr(ref, group), name)
            y = getattr(getattr(got, group), name)
            what = f"{group}.{name}"
            if x.dtype.kind == "f":
                np.testing.assert_allclose(y, x, atol=1e-5, rtol=1e-5,
                                           err_msg=what)
            else:
                np.testing.assert_array_equal(y.view(x.dtype), x,
                                              err_msg=what)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_mono_merge_maps(size, monkeypatch):
    cfg, maps, n_kf, n_lm, parents, plant, misplaced = _mono_case(size)
    jv, tv = _vocabularies()
    fields = _slam_fields(cfg)
    js = jsys.MonoSlam(jsys.SlamConfig(**fields, vocabulary=jv,
                                       device_mesh=False))
    ts = tsys.MonoSlam(tsys.SlamConfig(**fields, vocabulary=tv),
                       device="cpu")
    _fill(js, ts, maps, n_kf, n_lm, parents, current=1)
    edge = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0)
    js.loop_closer.loop_edges[0] = [(3, 9, edge)]
    ts.loop_closer.loop_edges[0] = [(3, 9, edge)]
    kf_id = n_kf[1] - 1
    _context(js, ts, kf_id)
    R_p, t_p, s_p = plant
    corr = (R_p.T.astype(np.float32),
            (-(R_p.T @ t_p) / s_p).astype(np.float32), 1.0 / s_p, 180)
    fused = {"jax": [], "port": []}
    _spy_fusion(monkeypatch, jmap, fused["jax"])
    _spy_fusion(monkeypatch, tmap, fused["port"])
    js._merge_maps(kf_id, 0, 2, corr)
    ts._merge_maps(kf_id, 0, 2, corr)
    cam = np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], np.float32)

    assert len(ts.atlas.maps) == len(js.atlas.maps) == 1
    assert ts.atlas.current == js.atlas.current == 0
    assert (ts.n_kf, ts.n_lm) == (js.n_kf, js.n_lm) == (
        sum(n_kf), sum(n_lm))
    np.testing.assert_array_equal(ts.kf_parent, js.kf_parent)
    assert ts.kf_parent[n_kf[1]] == kf_id
    (w_j, f_j), = fused["jax"]
    (w_t, f_t), = fused["port"]
    _assert_weld_equal(_np(w_j), _np(w_t))
    fj, ft = _np(f_j), _np(f_t)
    for x, y in ((fj.obs, ft.obs), ):
        for name in x._fields:
            np.testing.assert_array_equal(getattr(y, name),
                                          getattr(x, name), err_msg=name)
    np.testing.assert_array_equal(ft.lms.valid, fj.lms.valid)
    np.testing.assert_array_equal(ft.lms.n_obs, fj.lms.n_obs)
    wj = _np(w_j)
    n_fused = int((fj.obs.valid != wj.obs.valid).sum()
                  + (fj.lms.valid != wj.lms.valid).sum())
    assert n_fused > 0, "the fusion changed nothing"
    assert_states_close(_np(js.state), _np(ts.state), cam, pos_atol=1e-3,
                        pose_atol=1e-3, px_atol=2e-2)
    # The databases, loop edges, frozen records and tracking context.
    lj, lt = js.loop_closer, ts.loop_closer
    assert sorted(lt.dbs) == sorted(lj.dbs) == [0] and lt.active == 0
    vt, wt, okt = convert.keyframe_db_to_numpy(lt.dbs[0])
    np.testing.assert_array_equal(wt, np.asarray(lj.dbs[0].words))
    np.testing.assert_array_equal(okt, np.asarray(lj.dbs[0].valid))
    np.testing.assert_allclose(vt, np.asarray(lj.dbs[0].vecs), atol=1e-6)
    assert [e[:2] for e in lt.loop_edges[0]] == [
        e[:2] for e in lj.loop_edges[0]] == [(3 + n_kf[1], 9 + n_kf[1])]
    assert ts._traj.tags == js._traj.tags == [0] * 6
    for a, b in zip(ts._traj.R_cr + ts._traj.t_cr,
                    js._traj.R_cr + js._traj.t_cr):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(n(ts._last["R"]), np.asarray(js._last["R"]),
                               atol=1e-3)
    np.testing.assert_allclose(n(ts._last["t"]), np.asarray(js._last["t"]),
                               atol=1e-3)
    assert ts._vel is None and js._vel is None
    assert ts._ref_cache[0] == js._ref_cache[0] == kf_id
    if misplaced is not None:
        # The merge BA moved B's misplaced keyframe towards the truth.
        k, c_true = misplaced

        def err(st):
            R = st.kfs.R[k].astype(np.float64)
            return np.linalg.norm(-R.T @ st.kfs.t[k] - c_true)
        assert err(_np(ts.state)) < err(maps[1])


# --- The inertial merge -----------------------------------------------------

def _vi_fields():
    mc = SMALL.rig.mono
    return dict(fx=mc.fx, fy=mc.fy, cx=mc.cx, cy=mc.cy, width=mc.width,
                height=mc.height, n_features=mc.n_features,
                max_kf=mc.max_kf, max_lm=mc.max_lm, max_obs=mc.max_obs,
                local_kf_window=mc.n_local_kf, local_lm_window=mc.n_local_lm,
                recent_kf_window=mc.recent_kf,
                kf_ref_min_obs=mc.kf_ref_min_obs, fps=20,
                bf=SMALL.rig.bf, th_depth=SMALL.rig.th_depth)


def _vi_systems():
    jv, tv = _vocabularies()
    imu = SMALL.imu
    imu_kw = dict(T_bc=imu.T_bc, gyro_noise=imu.gyro_noise,
                  acc_noise=imu.acc_noise, gyro_walk=imu.gyro_walk,
                  acc_walk=imu.acc_walk, freq=imu.freq)
    vw = dict(viba_window=SMALL.viba_window, viba_free=SMALL.viba_free,
              viba_landmarks=SMALL.viba_landmarks,
              full_viba_kf=SMALL.full_viba_kf)
    js = JStereoInertialSlam(
        JStereoConfig(**_vi_fields(), vocabulary=jv, device_mesh=False),
        jvi.ImuConfig(**imu_kw), **vw)
    ts = TStereoInertialSlam(TStereoConfig(**_vi_fields(), vocabulary=tv),
                             tvi.ImuConfig(**imu_kw), **vw, device="cpu")
    return js, ts


def _vi_merge(poison: bool):
    """Both inertial systems welded; with ``poison`` the port's
    velocities and biases of the slots the weld fills are NaN first."""
    mb = graft.euroc_vi_map(SMALL, n_live_kf=24, view_points=600)
    ma = graft.euroc_vi_map(SMALL, seed=1, n_live_kf=16, view_points=600)
    R_p = Rotation.from_rotvec([0.05, 0.2, -0.1]).as_matrix()
    t_p = np.array([2.0, -0.5, 0.3])
    st_a = ma.state
    R_a = st_a.kfs.R.astype(np.float64) @ R_p.T
    t_a = st_a.kfs.t - np.einsum("kij,j->ki", R_a, t_p)
    st_a = st_a._replace(
        kfs=st_a.kfs._replace(R=R_a.astype(np.float32),
                              t=t_a.astype(np.float32)),
        lms=st_a.lms._replace(
            pos=(st_a.lms.pos @ R_p.T + t_p).astype(np.float32),
            normal=(st_a.lms.normal @ R_p.T).astype(np.float32)))
    js, ts = _vi_systems()
    _set_map(js, mb)
    n_lm = [int(np.flatnonzero(s.lms.valid).max()) + 1
            for s in (st_a, mb.state)]
    _fill(js, ts, (st_a, mb.state), (ma.kf_id + 1, mb.kf_id + 1), n_lm,
          (np.full(SMALL.rig.mono.max_kf, -1, np.int32),) * 2, current=1)
    js.imu_ready, js.viba_stage = True, 2
    js._ur = jnp.zeros(1)
    convert.carry_inertial_state(js, ts)
    ts._ur = torch.zeros(1)
    kf_id = mb.kf_id
    _context(js, ts, kf_id)
    if poison:
        lo, hi = mb.kf_id + 1, mb.kf_id + 1 + ma.kf_id + 1
        for name in ("kf_vel", "kf_bg", "kf_ba"):
            x = getattr(ts, name).clone()
            x[lo:hi] = float("nan")
            setattr(ts, name, x)
    # x_other = R^T (x_active - t): the plant's inverse.
    corr = (R_p.T.astype(np.float32), (-R_p.T @ t_p).astype(np.float32),
            1.0, 200)
    js._merge_maps(kf_id, 0, 0, corr)
    ts._merge_maps(kf_id, 0, 0, corr)
    return js, ts, mb, ma


@functools.cache
def _vi_runs():
    return _vi_merge(False), _vi_merge(True)


def test_inertial_merge_maps():
    (js, ts, mb, ma), _ = _vi_runs()
    K = mb.kf_id + 1 + ma.kf_id + 1
    assert len(ts.atlas.maps) == len(js.atlas.maps) == 1
    assert ts.n_kf == js.n_kf == K
    ref, got = _np(js.state), _np(ts.state)
    np.testing.assert_allclose(got.kfs.R, ref.kfs.R, atol=1e-3)
    np.testing.assert_allclose(got.kfs.t, ref.kfs.t, atol=1e-3)
    assert_states_close(ref, got, SMALL.rig.mono[2:6] if False else
                        np.array([SMALL.rig.mono.fx, SMALL.rig.mono.fy,
                                  SMALL.rig.mono.cx, SMALL.rig.mono.cy],
                                 np.float32), pos_atol=1e-3, pose_atol=1e-3)
    chain = tvi.chain(js.kf_prev, mb.kf_id)
    for name, tol in (("kf_vel", 1e-3), ("kf_bg", 1e-4), ("kf_ba", 1e-3)):
        np.testing.assert_allclose(n(getattr(ts, name))[chain],
                                   np.asarray(getattr(js, name))[chain],
                                   atol=tol, err_msg=name)
    for a, b in zip(ts._body, js._body):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(n(ts._last["R"]), np.asarray(js._last["R"]),
                               atol=1e-3)
    assert ts._ref_cache[0] == js._ref_cache[0] == mb.kf_id
    # The VI-BA moved the chain's free keyframes.
    assert not np.array_equal(got.kfs.t[mb.kf_id], mb.state.kfs.t[mb.kf_id])


def test_inertial_merge_reads_no_transplanted_velocity():
    (_, ts, mb, ma), (_, tp, _, _) = _vi_runs()
    a, b = _np(ts.state), _np(tp.state)
    for group in ("kfs", "lms", "obs"):
        for name in getattr(a, group)._fields:
            np.testing.assert_array_equal(getattr(getattr(b, group), name),
                                          getattr(getattr(a, group), name))
    chain = tvi.chain(ts.kf_prev, mb.kf_id)
    for name in ("kf_vel", "kf_bg", "kf_ba"):
        np.testing.assert_array_equal(n(getattr(tp, name))[chain],
                                      n(getattr(ts, name))[chain])
    lo = mb.kf_id + 1
    assert np.isnan(n(tp.kf_vel)[lo:lo + ma.kf_id + 1]).all()
    assert all(lo > k for k in chain)
    for x, y in zip(tp._body, ts._body):
        assert torch.equal(x, y)


# --- A live merge-back -------------------------------------------------------

def test_live_merge_back():
    """Cell "s" (``graft.MERGE_SMALL_TIMES``: map A, a blackout past the
    RECENTLY_LOST budget, the revisit) through the port's ``MonoSlam``
    with loop closing on: a second map in the blackout, the revisit's map
    initialises and the merge branch welds A back on the keyframe of the
    JAX MonoSlam's run of the same frames (``graft.MERGE_JAX["s"]``,
    ``scripts/merge_reference_jax.py s``) within one, with A's
    candidate; one map of A's and B's keyframes after it, tracking on
    every later frame."""
    cfg = graft.merge_small_config(_vocabularies()[1])
    world = SynthWorld(seed=3, w=cfg.width, h=cfg.height, fx=cfg.fx,
                       fy=cfg.fy)
    rng = np.random.default_rng(graft.RELOC_NOISE_SEED)
    slam = tsys.MonoSlam(cfg, device="cpu")
    merges, at = [], [0]
    inner = slam._merge_maps

    def spy(kf_id, other, cand, corr):
        n_kf = [m.n_kf for m in slam.atlas.meta]
        inner(kf_id, other, cand, corr)
        merges.append(dict(index=at[0], kf_id=kf_id, other=other, cand=cand,
                           n_kf_maps=n_kf))

    slam._merge_maps = spy
    statuses, n_maps = [], []
    for i, t in enumerate(graft.MERGE_SMALL_TIMES):
        at[0] = i
        img = (rng.uniform(0, 30, (cfg.height, cfg.width)).astype(np.float32)
               if t is None else world.render(t))
        slam.track(img, 0.1 * i)
        statuses.append(slam.status)
        n_maps.append(len(slam.atlas.maps))
    ref = graft.MERGE_JAX["s"]
    blackout = n_maps[graft.MERGE_TRACKED:graft.MERGE_TRACKED
                      + graft.MERGE_NOISE]
    print(f"merges {merges}; the JAX run's {ref}")
    assert 2 in blackout
    assert len(merges) == 1
    m = merges[0]
    assert abs(m["kf_id"] - ref["kf_id"]) <= 1 and m["other"] == ref["other"]
    assert abs(m["cand"] - ref["cand"]) <= 2
    assert n_maps[-1] == 1 and slam.n_kf >= sum(m["n_kf_maps"])
    assert all(s_ == tsys.OK for s_ in statuses[m["index"]:])


def test_merge_run_gates():
    """The merge cells' gates (``chip_smoke.py`` phase 17): a run passes
    with one merge on the JAX run's keyframe +- 1, two maps in the
    blackout, one map at the end, status OK from the merge on and the
    ATE within the gate; it fails with no merge, a merge two keyframes
    away, a frame lost after it or an ATE past the gate."""
    seq = graft.merge_sequence()
    g = graft.golden_frames()
    ref = graft.MERGE_JAX["l"]
    n = len(seq)
    statuses = {i: (0 if graft.MERGE_TRACKED <= i < 38 else 1)
                for i in range(n)}
    n_maps = {i: (2 if graft.MERGE_TRACKED <= i < ref["index"] else 1)
              for i in range(n)}
    traj = [(f.stamp, g.R[f.world], g.t[f.world]) for f in seq
            if f.world >= 0]

    def gates(merges, st=statuses):
        return graft.merge_run_gates("l", st, n_maps, merges, 29, 37, traj,
                                     0.0, seq, g)

    merge = dict(index=ref["index"], kf_id=ref["kf_id"])
    ok = gates([merge])
    assert ok["ok"] and ok["second_map_in_blackout"]
    assert ok["ate_m"] < 1e-9 and ok["n_assoc"] == 50
    assert not gates([])["ok"]
    assert not gates([dict(merge, kf_id=ref["kf_id"] + 2)])["ok"]
    assert gates([dict(merge, kf_id=ref["kf_id"] - 1)])["ok"]
    lost = {**statuses, n - 1: 2}
    assert not gates([merge], lost)["ok"]
    far = [(s_, R, t_ + 0.2 * (i % 2)) for i, (s_, R, t_) in enumerate(traj)]
    bad = graft.merge_run_gates("l", statuses, n_maps, [merge], 29, 37, far,
                                0.0, seq, g)
    assert not bad["ok"] and bad["ate_m"] > 0.08
