"""Port parity: the local-mapping stages (``pipeline/mapping.py``,
``ops/geometry.py`` and the epipolar search in ``ops/matching.py``) against
the JAX package's, each fed the same numpy state: the small EuRoC-mono map
(``graft.euroc_mono_map``, full case) taken through the JAX package's own
stages up to the one under test.

Exact: the epipolar matches, the slot allocation, fusion, culling and the
keyframe drop, the BA window's membership and every integer and bool array
the windowed BA writes. Within tolerance: triangulated positions (1e-4
relative), poses (1e-4), landmark positions (1e-3 m, or 0.01 px in their
observers, see ``torch_port_util.assert_states_close``). A triangulation
decision may go the other way only where its gate value lies within float32
rounding of the threshold: such rows are printed with their margin.

One intended difference: ``landmark_overflow_valve`` clears the observation
rows of the landmarks it retires; the JAX package leaves them live (a fault
the port repairs). Its cases mirror test_lm_valve.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (assert_states_close, jax_feats, jax_map_state,
                             n, plant_ur, small_map, small_map_config, t,
                             triangulation_margins)

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.ops import matching as jmat
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.ops import geometry as tgeo
from orbslam3_byzyh_tpu_torch.ops import matching as tmat
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

CFG = small_map_config()
FLIP_MARGIN = 1e-5


def _np(state):
    return jms.MapState(*(type(g)(*(np.asarray(a) for a in g))
                          for g in state))


@pytest.fixture(scope="module")
def stages():
    """The JAX package's bundle, stage by stage, as numpy states: after
    insert and binding ("bound"), after the valve ("valved"), after
    triangulation ("tri"), after fusion ("fused"); with the scene and the
    triangulation neighbours."""
    m = small_map("full")
    kf, nf = m.kf_id, CFG.n_features
    s = jms.add_keyframe(jax_map_state(m.state), kf, jnp.asarray(m.R),
                         jnp.asarray(m.t), m.stamp, jax_feats(m.feats))
    b = jnp.asarray(m.bindings)
    s = jms.add_observations(s, jnp.maximum(b, 0), kf,
                             jnp.arange(nf, dtype=jnp.int32), b >= 0)
    out = {"m": m, "bound": _np(s)}
    counts = jms.covisibility_counts(s, kf, CFG.max_kf)
    counts = np.asarray(jnp.where(s.kfs.valid, counts, 0).at[kf].set(0))
    out["neighbours"] = np.argsort(-counts, kind="stable")[:3]
    s = jmap.landmark_overflow_valve(s, nf)
    out["valved"] = _np(s)
    f = jax_feats(m.feats)
    cam = jnp.asarray(m.cam_params)
    for nb in out["neighbours"]:
        r = jmap.triangulate_pair(
            s.kfs.R[kf], s.kfs.t[kf], f.xy, f.level, f.desc,
            f.valid & (b < 0), s.kfs.R[nb], s.kfs.t[nb], s.kfs.kp_xy[nb],
            s.kfs.kp_level[nb], s.kfs.kp_desc[nb], s.kfs.kp_valid[nb], cam)
        sl, ok = jmap._alloc_landmark_slots(s.lms.valid, r.good)
        s = jms.add_landmarks(s, sl, r.pos, r.desc, kf, r.kp_a, nb, r.kp_b,
                              ok, r.normal, r.min_dist, r.max_dist)
        b = b.at[jnp.where(ok, r.kp_a, nf)].set(jnp.where(ok, sl, -1),
                                                mode="drop")
    out["tri"] = _np(s)
    s = jmap.fuse_duplicates(s, kf, cam, float(CFG.width), float(CFG.height))
    out["fused"] = _np(s)
    return out


def _pair_args(st, m, nb, package):
    """triangulate_pair's arguments: the new keyframe (slot kf_id) against
    keyframe ``nb``, in one package's types."""
    kf = m.kf_id
    free = m.feats.valid & (m.bindings < 0)
    k = st.kfs
    args = (k.R[kf], k.t[kf], m.feats.xy, m.feats.level, m.feats.desc, free,
            k.R[nb], k.t[nb], k.kp_xy[nb], k.kp_level[nb], k.kp_desc[nb],
            k.kp_valid[nb], m.cam_params)
    conv = jnp.asarray if package == "jax" else t
    return tuple(conv(a) for a in args)


def test_fundamental_and_projection_match_jax(stages):
    st, m = stages["bound"], stages["m"]
    nb = int(stages["neighbours"][0])
    ja = _pair_args(st, m, nb, "jax")
    ta = _pair_args(st, m, nb, "torch")
    F_j = jmap.fundamental_from_poses(ja[0], ja[1], ja[6], ja[7], ja[12])
    F_t = tmap.fundamental_from_poses(ta[0], ta[1], ta[6], ta[7], ta[12])
    np.testing.assert_allclose(n(F_t), np.asarray(F_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(F_j)).max())
    K = tmap._intrinsics(ta[12])
    np.testing.assert_array_equal(n(K), [[m.cam_params[0], 0, m.cam_params[2]],
                                         [0, m.cam_params[1], m.cam_params[3]],
                                         [0, 0, 1]])
    from orbslam3_byzyh_tpu.ops import geometry as jgeo
    np.testing.assert_allclose(
        n(tgeo.projection_matrix(K, ta[0], ta[1])),
        np.asarray(jgeo.projection_matrix(jnp.asarray(n(K)), ja[0], ja[1])),
        rtol=1e-6, atol=1e-4)


def test_epipolar_search_and_mask_exact(stages):
    """K2's epipolar mode (plain version on the CPU) against the JAX
    package's masked search: the same matches and distances."""
    st, m = stages["bound"], stages["m"]
    for nb in stages["neighbours"]:
        ja = _pair_args(st, m, int(nb), "jax")
        ta = _pair_args(st, m, int(nb), "torch")
        F = jmap.fundamental_from_poses(ja[0], ja[1], ja[6], ja[7], ja[12])
        lines = jnp.concatenate([ja[2], jnp.ones_like(ja[2][:, :1])], -1) @ F.T
        mj, md = jmat.search_epipolar(lines, ja[4], ja[5], ja[8], ja[9],
                                      ja[10], ja[11], jtr.SIGMA2,
                                      max_dist=jmat.TH_LOW, ratio=0.8)
        tj, td = tmat.search_epipolar(t(np.asarray(lines)), ta[4], ta[5],
                                      ta[8], ta[9], ta[10], ta[11],
                                      ttr.SIGMA2, max_dist=tmat.TH_LOW,
                                      ratio=0.8)
        np.testing.assert_array_equal(n(tj), np.asarray(mj))
        np.testing.assert_array_equal(n(td), np.asarray(md))
        assert (n(tj) >= 0).sum() >= 10
        mask_j = jmat.epipolar_mask(F, ja[2], ja[8], ja[9], jtr.SIGMA2)
        mask_t = tmat.epipolar_mask(t(np.asarray(F)), ta[2], ta[8], ta[9],
                                    ttr.SIGMA2)
        np.testing.assert_array_equal(n(mask_t), np.asarray(mask_j))


def test_triangulate_pair_matches_jax(stages):
    st, m = stages["bound"], stages["m"]
    n_good = 0
    for nb in stages["neighbours"]:
        nb = int(nb)
        rj = jmap.triangulate_pair(*_pair_args(st, m, nb, "jax"))
        rt = tmap.triangulate_pair(*_pair_args(st, m, nb, "torch"))
        gj, gt = np.asarray(rj.good), n(rt.good)
        np.testing.assert_array_equal(n(rt.kp_a), np.asarray(rj.kp_a))
        np.testing.assert_array_equal(n(rt.kp_b), np.asarray(rj.kp_b))
        np.testing.assert_array_equal(n(rt.desc), np.asarray(rj.desc).view(
            np.int32))
        flips = np.flatnonzero(gj != gt)
        if len(flips):
            kb = np.asarray(rj.kp_b)
            marg = triangulation_margins(
                n(rt.pos), st.kfs.R[m.kf_id], st.kfs.t[m.kf_id],
                st.kfs.R[nb], st.kfs.t[nb], m.feats.xy,
                st.kfs.kp_xy[nb][kb], m.feats.level,
                st.kfs.kp_level[nb][kb], m.cam_params)
            for i in flips:
                print(f"keyframe {nb}, row {i}: good {gj[i]} (JAX) vs "
                      f"{gt[i]} (port), gate margin {marg[i]:.3e}")
                assert marg[i] < FLIP_MARGIN
        both = gj & gt
        n_good += both.sum()
        for name, rtol in (("pos", 1e-4), ("normal", 1e-4),
                           ("min_dist", 1e-4), ("max_dist", 1e-4)):
            np.testing.assert_allclose(
                n(getattr(rt, name))[both], np.asarray(getattr(rj, name))[both],
                rtol=rtol, atol=rtol * 1e-2, err_msg=name)
    assert n_good >= 50


def test_alloc_landmark_slots_exact(rng):
    for L, n_good, p_free in ((64, 40, 0.3), (2048, 256, 0.05),
                              (512, 100, 0.0)):
        valid = rng.random(L) >= p_free
        good = rng.random(n_good) < 0.5
        sj, okj = jmap._alloc_landmark_slots(jnp.asarray(valid),
                                             jnp.asarray(good))
        st_, okt = tmap._alloc_landmark_slots(t(valid), t(good))
        np.testing.assert_array_equal(n(okt), np.asarray(okj))
        np.testing.assert_array_equal(n(st_), np.asarray(sj))
        assert not valid[n(st_)[n(okt)]].any()


def _filled_state(max_lm=32, max_obs=4, live=None):
    """test_lm_valve.py's state: landmark i last seen by keyframe i % 8, so
    the valve's sort key has many ties."""
    live = max_lm if live is None else live
    s = jms.empty_map(8, max_lm, max_obs, 16)
    kf = jnp.tile((jnp.arange(max_lm) % 8)[:, None], (1, max_obs))
    first = jnp.arange(max_obs)[None, :] == 0
    s = s._replace(
        lms=s.lms._replace(valid=jnp.arange(max_lm) < live,
                           pos=jnp.ones((max_lm, 3), jnp.float32)),
        obs=s.obs._replace(kf=jnp.where(first, kf, -1),
                           valid=first & (jnp.arange(max_lm)[:, None] < live)))
    return _np(s)


@pytest.mark.parametrize("live, margin", [(16, 8), (32, 8), (32, 20),
                                          (300, 64)])
def test_overflow_valve_matches_jax_but_clears_rows(live, margin):
    state = _filled_state(max_lm=max(live, 32), live=live)
    ref = _np(jmap.landmark_overflow_valve(jax_map_state(state), margin))
    got = convert.map_state_to_numpy(tmap.landmark_overflow_valve(
        convert.map_state_to_torch(state, "cpu"), margin))
    np.testing.assert_array_equal(got.lms.valid, ref.lms.valid)
    killed = state.lms.valid & ~ref.lms.valid
    # The intended difference: the JAX package leaves the retired rows'
    # observations live, the port clears them; nothing else differs.
    assert ref.obs.valid[killed].any() == bool(killed.any())
    assert not got.obs.valid[killed].any()
    np.testing.assert_array_equal(got.obs.valid[~killed],
                                  ref.obs.valid[~killed])
    np.testing.assert_array_equal(got.obs.kf, ref.obs.kf)
    np.testing.assert_array_equal(got.obs.kp, ref.obs.kp)
    for name in ("pos", "n_obs", "first_kf"):
        np.testing.assert_array_equal(getattr(got.lms, name),
                                      getattr(ref.lms, name))


def test_overflow_valve_retires_the_oldest():
    """test_lm_valve.py's checks on the port: a no-op with room; the
    retired rows are the least recently seen (ties by slot); the newest
    keyframes' landmarks survive."""
    roomy = convert.map_state_to_torch(_filled_state(live=16), "cpu")
    assert int(tmap.landmark_overflow_valve(roomy, 8).lms.valid.sum()) == 16
    state = _filled_state(live=32)
    out = tmap.landmark_overflow_valve(
        convert.map_state_to_torch(state, "cpu"), 8)
    valid = n(out.lms.valid)
    last_seen = np.where(state.obs.valid, state.obs.kf, -1).max(1)
    assert valid.sum() == 24
    assert last_seen[~valid].max() <= last_seen[valid].min()
    assert valid[last_seen >= 6].all()
    assert np.flatnonzero(~valid).tolist() == [0, 1, 8, 9, 16, 17, 24, 25]


def test_valve_on_the_scene_matches_jax(stages):
    st = stages["bound"]
    got = convert.map_state_to_numpy(tmap.landmark_overflow_valve(
        convert.map_state_to_torch(st, "cpu"), CFG.n_features))
    ref = stages["valved"]
    np.testing.assert_array_equal(got.lms.valid, ref.lms.valid)
    killed = st.lms.valid & ~ref.lms.valid
    assert killed.sum() > 0 and (~ref.lms.valid).sum() == CFG.n_features
    assert not got.obs.valid[killed].any() and ref.obs.valid[killed].any()


def test_fuse_duplicates_exact(stages):
    """Fusion on the triangulated state (the keyframe's missed keypoints
    re-triangulated give duplicates): every array equal."""
    m, st = stages["m"], stages["tri"]
    got = convert.map_state_to_numpy(tmap.fuse_duplicates(
        convert.map_state_to_torch(st, "cpu"), m.kf_id, t(m.cam_params),
        float(CFG.width), float(CFG.height)))
    ref = stages["fused"]
    for group in ("kfs", "lms", "obs"):
        for name in getattr(ref, group)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(got, group), name),
                getattr(getattr(ref, group), name), err_msg=name)
    died = st.lms.valid & ~ref.lms.valid
    new_obs = ref.lms.n_obs > st.lms.n_obs
    assert died.sum() >= 1 and new_obs.sum() >= 1


def test_windowed_local_ba_matches_jax(stages):
    """The window's free keyframes and landmarks (the rows the BA moved)
    exact; the map within tolerance; the landmark window cut."""
    m, st = stages["m"], stages["fused"]
    kw = dict(n_free=CFG.local_window + 1, n_window=CFG.ba_window,
              n_lm_window=CFG.ba_lm_window)
    ref = _np(jmap.windowed_local_ba(jax_map_state(st), m.kf_id,
                                     jnp.asarray(m.cam_params), **kw))
    got = convert.map_state_to_numpy(tmap.windowed_local_ba(
        convert.map_state_to_torch(st, "cpu"), m.kf_id, t(m.cam_params),
        **kw))
    moved_kf_ref = (ref.kfs.R != st.kfs.R).any((1, 2))
    moved_kf_got = (got.kfs.R != st.kfs.R).any((1, 2))
    np.testing.assert_array_equal(moved_kf_got, moved_kf_ref)
    assert moved_kf_ref.sum() == CFG.local_window + 1
    moved_lm_ref = (ref.lms.pos != st.lms.pos).any(1)
    moved_lm_got = (got.lms.pos != st.lms.pos).any(1)
    np.testing.assert_array_equal(moved_lm_got, moved_lm_ref)
    # The window holds n_lm_window landmarks, fewer than its free keyframes
    # observe.
    free = np.flatnonzero(moved_kf_ref)
    seen = (st.obs.valid & np.isin(st.obs.kf, free)).any(1) & st.lms.valid
    assert moved_lm_ref.sum() <= CFG.ba_lm_window < seen.sum()
    assert_states_close(ref, got, m.cam_params)


def test_redundancy_and_culling_exact(stages):
    m, st = stages["m"], stages["fused"]
    js, ts = jax_map_state(st), convert.map_state_to_torch(st, "cpu")
    fj, cj = jmap.redundancy_stats(js)
    ft, ct = tmap.redundancy_stats(ts)
    np.testing.assert_array_equal(n(ct), np.asarray(cj))
    np.testing.assert_array_equal(n(ft), np.asarray(fj))
    for fn in (jmap.cull_landmarks, jmap.cull_keyframes):
        ref = _np(fn(js, m.kf_id))
        got = convert.map_state_to_numpy(getattr(tmap, fn.__name__)(
            ts, m.kf_id))
        for group in ("kfs", "lms", "obs"):
            for name in getattr(ref, group)._fields:
                np.testing.assert_array_equal(
                    getattr(getattr(got, group), name),
                    getattr(getattr(ref, group), name), err_msg=name)
    assert not _np(jmap.cull_keyframes(js, m.kf_id)).kfs.valid[m.cull_kf]
    assert (~_np(jmap.cull_landmarks(js, m.kf_id)).lms.valid
            & st.lms.valid).sum() > 0


@pytest.mark.parametrize("kf, do", [(5, True), (5, False), (0, True)])
def test_drop_keyframe_exact(stages, kf, do):
    st = stages["fused"]
    ref = _np(jmap.drop_keyframe(jax_map_state(st), kf, do))
    got = convert.map_state_to_numpy(tmap.drop_keyframe(
        convert.map_state_to_torch(st, "cpu"), kf, torch.tensor(do)))
    for group in ("kfs", "lms", "obs"):
        for name in getattr(ref, group)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(got, group), name),
                getattr(getattr(ref, group), name), err_msg=name)
    assert ref.kfs.valid[kf] == (not do)


# --- The stereo rows (use_stereo, bf) ---------------------------------------

BF = 40.0


def test_windowed_local_ba_stereo_matches_jax(stages):
    """The windowed BA with stereo rows (``kp_ur`` planted on the fused
    map): the rows it moves exact, the map within tolerance."""
    m = stages["m"]
    st = plant_ur(stages["fused"], np.random.default_rng(5), BF)
    kw = dict(use_stereo=True, bf=BF, n_free=CFG.local_window + 1,
              n_window=CFG.ba_window, n_lm_window=CFG.ba_lm_window)
    ref = _np(jmap.windowed_local_ba(jax_map_state(st), m.kf_id,
                                     jnp.asarray(m.cam_params), **kw))
    got = convert.map_state_to_numpy(tmap.windowed_local_ba(
        convert.map_state_to_torch(st, "cpu"), m.kf_id, t(m.cam_params),
        **kw))
    np.testing.assert_array_equal((got.kfs.R != st.kfs.R).any((1, 2)),
                                  (ref.kfs.R != st.kfs.R).any((1, 2)))
    np.testing.assert_array_equal((got.lms.pos != st.lms.pos).any(1),
                                  (ref.lms.pos != st.lms.pos).any(1))
    assert_states_close(ref, got, m.cam_params)
