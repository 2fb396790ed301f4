"""Port parity: the merge branch of ``LoopCloser`` (``detect_merge``, its
streak and fixed-scale gate, ``on_maps_merged``) against the JAX package's.

The atlas holds two maps built from ``test_loop_closing.py``'s drifted
circular map (32 keyframe / 2048 landmark slots, 128 features): map 0 is
the circuit without its last three keyframes (13 live, their database
filled), map 1 (active) is the whole circuit moved through a planted Sim3
(scale 0.6), whose last three keyframes re-observe map 0's keyframes 0-2
and whose earlier keyframes carry descriptors of their own (so that they
miss).
Both loop closers mine map 0 from map 1's revisit keyframes with the same
vocabulary; the port's Sim3 RANSAC takes the JAX function's sample rows
(``_sim3_indices``, as ``test_torch_loop_closing.py`` does: the streams of
the two libraries differ). The other map, the candidate, the final count
and the streak must be equal, the Sim3 within 1e-4. After ``Atlas.merge``
with the same Sim3 in both packages, ``on_maps_merged`` must leave the
databases equal (words and liveness exact, vectors within 1e-6) and the
loop edges equal; the port's batched ``add_range`` must equal its own
per-keyframe ``add``.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch_port_util import n

from orbslam3_byzyh_tpu.models import atlas as jatlas
from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.pipeline import loop_closing as jlc
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.models import atlas as tatlas
from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db as tkdb
from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as tlc
from test_loop_closing import CAM, MAX_KF, N_FEAT, build_circular_map
from test_torch_loop_closing import _cfg, jax_row_hook

SIM3_TOL = 1e-4
N_REVISIT = 3
PLANT_S = 0.6
PLANT_R = Rotation.from_rotvec([0.1, -0.3, 0.2]).as_matrix()
PLANT_T = np.array([0.5, -0.2, 1.0])


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.default_rng(0)
    v = jbow.train_vocabulary(rng.integers(0, 2**32, (2000, 8),
                                           dtype=np.uint32), k=6, depth=3)
    return v, convert.vocabulary_to_torch(v, "cpu")


def _moved(st, s, R, t):
    """A numpy map state in the world x' = s R x + t."""
    kfs, lms = st.kfs, st.lms
    R_new = kfs.R @ R.T
    t_new = s * kfs.t - np.einsum("kij,j->ki", R_new, t)
    return st._replace(
        kfs=kfs._replace(R=R_new.astype(np.float32),
                         t=t_new.astype(np.float32)),
        lms=lms._replace(pos=(s * lms.pos @ R.T + t).astype(np.float32),
                         normal=(lms.normal @ R.T).astype(np.float32),
                         min_dist=(lms.min_dist * s).astype(np.float32),
                         max_dist=(lms.max_dist * s).astype(np.float32)))


@pytest.fixture(scope="module")
def two_maps():
    """(map 0, map 1) as numpy states with their keyframe counts."""
    state, n_kf, _, _ = build_circular_map(np.random.default_rng(42),
                                           n_revisit=N_REVISIT)
    full = jax.tree.map(np.asarray, state)
    n_old = n_kf - N_REVISIT
    kf_live = np.arange(MAX_KF) < n_old
    lm_live = full.lms.valid & (full.lms.first_kf < n_old)
    obs_live = full.obs.valid & (full.obs.kf < n_old) & lm_live[:, None]
    old = full._replace(
        kfs=full.kfs._replace(valid=full.kfs.valid & kf_live),
        lms=full.lms._replace(valid=lm_live),
        obs=full.obs._replace(valid=obs_live))
    new = _moved(full, PLANT_S, PLANT_R, PLANT_T)
    # Map 1's keyframes before the revisit get keypoint descriptors of
    # their own: as exact copies of map 0's they would verify with zero
    # residuals, where the JAX OptimizeSim3 returns NaN.
    desc = new.kfs.kp_desc.copy()
    desc[:n_old] = np.random.default_rng(7).integers(
        0, 2**32, desc[:n_old].shape, dtype=np.uint32)
    new = new._replace(kfs=new.kfs._replace(kp_desc=desc))
    return (old, n_old, int(lm_live.sum())), (new, n_kf, int(
        full.lms.valid.sum()))


def atlases(two_maps, extra=False):
    """The JAX and the port atlas: map 0 the old map, map 1 the active
    one (with ``extra`` a third, a copy of the old map, past it)."""
    (old, n_old, l_old), (new, n_new, l_new) = two_maps
    maps = [(old, n_old, l_old), (new, n_new, l_new)]
    if extra:
        maps.append((old, n_old, l_old))
    dims = (MAX_KF, old.lms.pos.shape[0], old.obs.kf.shape[1], N_FEAT)
    ja = jatlas.Atlas(*dims)
    ja.maps = [jax.tree.map(jax.numpy.asarray, s) for s, _, _ in maps]
    ja.meta = [jatlas.MapMeta(k, l, None) for _, k, l in maps]
    ja.current = 1
    ta = convert.atlas_to_torch(ja, "cpu")
    return ja, ta


def closers(vocs, ja, ta, **over):
    """Both loop closers with each map's database filled (map 1 active)."""
    jv, tv = vocs
    cfg = _cfg(**over)
    lj = jlc.LoopCloser(jv, MAX_KF, N_FEAT, cfg=jlc.LoopCloserConfig(**cfg),
                        cam_params=CAM)
    lt = tlc.LoopCloser(tv, MAX_KF, N_FEAT, cfg=tlc.LoopCloserConfig(**cfg),
                        cam_params=CAM)
    lt._sim3_indices = jax_row_hook
    for lc, at in ((lj, ja), (lt, ta)):
        for idx in range(len(at.maps)):
            lc.switch_map(idx)
            for k in range(at.meta[idx].n_kf):
                lc.add_keyframe(at.maps[idx], k)
        lc.switch_map(1, fresh=False)
    return lj, lt


def detect_both(lj, lt, ja, ta, q):
    dj = lj.detect_merge(ja.state, q, ja)
    dt = lt.detect_merge(ta.state, q, ta)
    assert (dj is None) == (dt is None), (dj, dt, lt.info)
    if dj is not None:
        assert dt[:2] == dj[:2]
        (Rj, tj, sj, nj), (Rt, tt, st, nt) = dj[2], dt[2]
        np.testing.assert_allclose(Rt, np.asarray(Rj), atol=SIM3_TOL)
        np.testing.assert_allclose(tt, np.asarray(tj), atol=SIM3_TOL)
        assert abs(st - sj) < SIM3_TOL and nt == nj
    a, b = lj._merge_streak, lt._merge_streak
    assert (a is None) == (b is None)
    if a is not None:
        assert (a["map_idx"], a["cand"], a["count"], a["miss"]) == (
            b["map_idx"], b["cand"], b["count"], b["miss"])
    return dj, dt


def test_detect_merge_fires_on_the_planted_region(vocs, two_maps):
    """``consecutive_needed`` 3: the three revisits confirm in turn and the
    third fires on map 0's keyframe 2 with the planted scale (the drift's
    creep folded in)."""
    ja, ta = atlases(two_maps)
    lj, lt = closers(vocs, ja, ta, consecutive_needed=3)
    n_kf = two_maps[1][1]
    for i, q in enumerate(range(n_kf - N_REVISIT, n_kf)):
        _, dt = detect_both(lj, lt, ja, ta, q)
        if i < N_REVISIT - 1:
            assert dt is None and lt._merge_streak["count"] == i + 1
    other, cand, (_, _, s, n_inl) = dt
    assert (other, cand) == (0, N_REVISIT - 1)
    # x_other = s R x_active + t undoes the plant and the query's creep.
    want = 1.0 / (PLANT_S * 1.015 ** (n_kf - 1))
    assert abs(s - want) / want < 0.05, (s, want)
    assert lt.info["fired"] and lt.info["maps"][0]["map"] == 0
    assert lt.info["maps"][0]["host_reads"] >= 2
    assert n_inl >= 30


def test_detect_merge_streak_resets_after_misses(vocs, two_maps):
    ja, ta = atlases(two_maps)
    lj, lt = closers(vocs, ja, ta, consecutive_needed=3)
    n_kf = two_maps[1][1]
    detect_both(lj, lt, ja, ta, n_kf - 1)
    assert lt._merge_streak["count"] == 1
    for q in (4, 5, 6):
        detect_both(lj, lt, ja, ta, q)
    assert lt._merge_streak is None


def test_detect_merge_skips_small_and_active_maps(vocs, two_maps):
    """A map under 3 keyframes is not mined; the active map never is."""
    ja, ta = atlases(two_maps)
    lj, lt = closers(vocs, ja, ta)
    ja.meta[0].n_kf = ta.meta[0].n_kf = 2
    n_kf = two_maps[1][1]
    _, dt = detect_both(lj, lt, ja, ta, n_kf - 1)
    assert dt is None and lt.info["maps"] == []


@pytest.mark.parametrize("scale,refused", [(0.8, True), (1.05, False)])
def test_fix_scale_gate(vocs, two_maps, monkeypatch, scale, refused):
    """A fixed-scale system refuses a verified Sim3 whose scale lies
    outside 0.9-1.1 (both packages' ``_verify`` return the same planted
    Sim3 here)."""
    ja, ta = atlases(two_maps)
    lj, lt = closers(vocs, ja, ta, fix_scale=True)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    corr = (R, t, scale, 99)

    def fake(self, state_q, q, state_c, c, db_c, words_q):
        if isinstance(self, tlc.LoopCloser):
            self.info["tried"].append({"cand": int(c), "failed": None})
        return corr

    monkeypatch.setattr(jlc.LoopCloser, "_verify", fake)
    monkeypatch.setattr(tlc.LoopCloser, "_verify", fake)
    n_kf = two_maps[1][1]
    dj, dt = detect_both(lj, lt, ja, ta, n_kf - 1)
    assert (dt is None) == refused
    if refused:
        assert all(r["failed"] == "scale" for r in lt.info["tried"])


def test_on_maps_merged(vocs, two_maps):
    """A three-map atlas, map 0 welded into the active map 1: the
    databases of every map (re-indexed past the deleted one) and the loop
    edges (map 0's moved with the shift) equal the JAX closer's."""
    ja, ta = atlases(two_maps, extra=True)
    lj, lt = closers(vocs, ja, ta)
    rng = np.random.default_rng(3)
    edges = []
    for i, j in ((1, 5), (2, 9), (0, 12)):
        m = (Rotation.random(random_state=rng.integers(99)).as_matrix()
             .astype(np.float32), rng.normal(size=3).astype(np.float32),
             float(rng.uniform(0.8, 1.2)))
        edges.append((i, j, m))
    lj.loop_edges[0] = list(edges)
    lt.loop_edges[0] = list(edges)
    lj.loop_edges[2] = lt.loop_edges[2] = [(3, 4, edges[0][2])]
    R_i = Rotation.from_rotvec([0.2, 0.1, -0.1]).as_matrix()
    t_i, s_i = np.array([0.1, 0.2, -0.3]), 1.25
    # Clip the weld so that the edge (0, 12) loses an end.
    for at in (ja, ta):
        at.meta[1].n_kf = MAX_KF - 10
    lo = MAX_KF - 10
    ja.merge(0, R_i, t_i, s_i)
    ta.merge(0, R_i, t_i, s_i)
    hi = ja.counts().n_kf
    assert hi == ta.counts().n_kf == MAX_KF
    lj.on_maps_merged(ja.current, 0, ja.state, lo, hi)
    lt.on_maps_merged(ta.current, 0, ta.state, lo, hi)
    assert lt.active == lj.active == 0
    assert sorted(lt.dbs) == sorted(lj.dbs) == [0, 1]
    for idx in lj.dbs:
        vj, wj, okj = (np.asarray(x) for x in (
            lj.dbs[idx].vecs, lj.dbs[idx].words, lj.dbs[idx].valid))
        vt, wt, okt = convert.keyframe_db_to_numpy(lt.dbs[idx])
        np.testing.assert_array_equal(okt, okj)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_allclose(vt, vj, atol=1e-6)
    assert sorted(lt.loop_edges) == sorted(lj.loop_edges) == [0, 1]
    for idx in lj.loop_edges:
        ej, et = lj.loop_edges[idx], lt.loop_edges[idx]
        assert [e[:2] for e in et] == [e[:2] for e in ej]
        for a, b in zip(ej, et):
            for x, y in zip(a[2], b[2]):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert [e[:2] for e in lt.loop_edges[0]] == [(lo + 1, lo + 5),
                                                 (lo + 2, lo + 9)]


def test_add_range_equals_per_keyframe_adds(vocs, two_maps, monkeypatch):
    """``KeyframeDatabase.add_range`` (one transform and one
    ``index_add_`` per chunk) writes the rows ``add`` writes one by one,
    bit for bit, chunk boundaries included."""
    _, tv = vocs
    state = convert.map_state_to_torch(two_maps[1][0], "cpu")
    a = tkdb.KeyframeDatabase(tv, MAX_KF, N_FEAT)
    b = tkdb.KeyframeDatabase(tv, MAX_KF, N_FEAT)
    lo, hi = 3, 3 + two_maps[1][1] - 4
    for k in range(lo, hi):
        a.add(k, state.kfs.kp_desc[k - lo], state.kfs.kp_valid[k - lo])
    monkeypatch.setattr(tkdb, "ADD_RANGE_CHUNK", 5)
    b.add_range(lo, state.kfs.kp_desc[:hi - lo], state.kfs.kp_valid[:hi - lo])
    for x, y in ((a.vecs, b.vecs), (a.words, b.words), (a.valid, b.valid)):
        assert torch.equal(x, y)
    assert int(n(b.valid).sum()) == hi - lo


def test_scale_runaway_is_held(vocs, two_maps, monkeypatch):
    """OptimizeSim3 is Gauss-Newton; where the query and the candidate see
    the place from nearly one viewpoint its scale is barely observed and
    can run off (the live merge cell welded at 1.45 where the truth is
    1.0; the JAX ladder has no guard, ROADMAP section 3). A refined scale
    a factor 1.2 or more from the Sim3 RANSAC's gives way to the
    refinement at the RANSAC's scale, read with the ladder's third packed
    read; a refinement that stays near it is kept (the parity cases)."""
    ja, ta = atlases(two_maps)
    _, lt = closers(vocs, ja, ta)
    n_kf = two_maps[1][1]
    hit = lt.detect_merge(ta.state, n_kf - 1, ta)
    assert hit is not None and not lt.info["tried"][-1]["scale_held"]
    real = tlc.sim3_solve.optimize_sim3
    calls = []

    def runaway(R0, t0, s0, *rows, fix_scale=False):
        out = real(R0, t0, s0, *rows, fix_scale=fix_scale)
        calls.append((float(s0), fix_scale))
        return out if fix_scale else out._replace(s=out.s * 1.5)

    monkeypatch.setattr(tlc.sim3_solve, "optimize_sim3", runaway)
    _, lt = closers(vocs, ja, ta)
    held = lt.detect_merge(ta.state, n_kf - 1, ta)
    rec = lt.info["tried"][-1]
    assert rec["scale_held"] and rec["failed"] is None
    assert calls[-1][1] and held[:2] == hit[:2]
    np.testing.assert_allclose(held[2][2], 1.0 / calls[-1][0], rtol=1e-6)
    assert abs(held[2][2] - hit[2][2]) / hit[2][2] < 0.2
    assert lt.info["host_reads"].count(f"candidate {held[1]} refine") == 1
