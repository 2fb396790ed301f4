"""Port parity: ``LoopCloser.detect`` and ``close`` against the JAX package
on ``test_loop_closing.py``'s drifted circular maps (its eight cases; the
JAX test is slow, these run at its 32 keyframe / 2048 landmark slots,
128 features).

Both loop closers mine the same map with the same vocabulary; the port's
Sim3 RANSAC takes the JAX function's sample rows (``_sim3_indices``
overridden with the rows of ``PRNGKey(q)``, mapped onto the port's
one-row-per-keypoint pairs). ``detect`` must return the same candidate,
the same final count and the Sim3 within 1e-4 (float32 SVDs and
Gauss-Newton solves of two libraries); the streaks must agree. After
``close`` the keyframe poses must agree within 1e-4 and the live
landmarks within 1e-3 (the port's pose graph solves over the live prefix
and re-projects rotations by Newton polar iterations). Each map is built
once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n

from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.pipeline import loop_closing as jlc
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.models import atlas as tatlas
from orbslam3_byzyh_tpu_torch.ops import lie as tlie
from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as tlc
from orbslam3_byzyh_tpu_torch.pipeline.trajectory_log import TrajectoryLog
from orbslam3_byzyh_tpu_torch.utils import evaluate
from test_loop_closing import CAM, MAX_KF, N_FEAT, build_circular_map

SIM3_TOL, POSE_TOL, POS_TOL = 1e-4, 1e-4, 1e-3


def _cfg(**over):
    """``test_loop_closing._test_cfg``'s gates."""
    kw = dict(min_bow_matches=20, min_ransac_inliers=15, min_sim3_inliers=15,
              min_proj_matches=30, min_proj_opt_matches=30,
              consecutive_needed=1)
    kw.update(over)
    return kw


def jax_rows(q: int, n_rows: int, n_iters: int = 128) -> np.ndarray:
    """``sim3_ransac``'s sample rows in the JAX loop closer's ``_verify``
    (``PRNGKey(q)``, all pairs valid)."""
    keys = jax.random.split(jax.random.PRNGKey(q), n_iters)
    w = jnp.ones(n_rows) + 1e-9
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n_rows, (3,), replace=False, p=w / w.sum()))(keys))


def jax_row_hook(mask: torch.Tensor, q: int) -> torch.Tensor:
    pos = np.flatnonzero(n(mask))
    return torch.from_numpy(pos[jax_rows(q, len(pos))])


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.default_rng(0)
    v = jbow.train_vocabulary(rng.integers(0, 2**32, (2000, 8),
                                           dtype=np.uint32), k=6, depth=3)
    return v, convert.vocabulary_to_torch(v, "cpu")


_MAPS = {}


def circular_map(**kw):
    """``build_circular_map(default_rng(42), **kw)`` (the JAX test's
    rng fixture), built once per module: the JAX state, the port's, the
    truth."""
    key = tuple(sorted(kw.items()))
    if key not in _MAPS:
        state, n_kf, Rs, cs = build_circular_map(np.random.default_rng(42),
                                                 **kw)
        port = convert.map_state_to_torch(jax.tree.map(np.asarray, state),
                                          "cpu")
        _MAPS[key] = (state, port, n_kf, Rs, cs)
    return _MAPS[key]


def closers(vocs, state, port, n_kf, n_add=None, **over):
    jv, tv = vocs
    cfg = _cfg(**over)
    lj = jlc.LoopCloser(jv, MAX_KF, N_FEAT,
                        cfg=jlc.LoopCloserConfig(**cfg), cam_params=CAM)
    lt = tlc.LoopCloser(tv, MAX_KF, N_FEAT,
                        cfg=tlc.LoopCloserConfig(**cfg), cam_params=CAM)
    lt._sim3_indices = jax_row_hook
    for k in range(n_kf if n_add is None else n_add):
        lj.add_keyframe(state, k)
        lt.add_keyframe(port, k)
    return lj, lt


def detect_both(lj, lt, state, port, q, n_kf):
    dj = lj.detect(state, q, n_kf)
    dt = lt.detect(port, q, n_kf)
    assert (dj is None) == (dt is None), (dj, dt, lt.info)
    if dj is not None:
        assert dt[0] == dj[0]
        (Rj, tj, sj, nj), (Rt, tt, st, nt) = dj[1], dt[1]
        np.testing.assert_allclose(Rt, np.asarray(Rj), atol=SIM3_TOL)
        np.testing.assert_allclose(tt, np.asarray(tj), atol=SIM3_TOL)
        assert abs(st - sj) < SIM3_TOL
        assert nt == nj
    for a, b in ((lj._streak, lt._streak),):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a["cand"], a["count"], a["miss"]) == (
                b["cand"], b["count"], b["miss"])
    return dj, dt


def close_both(lj, lt, state, port, q, det_j, det_t, n_kf):
    sj = lj.close(state, q, det_j[0], det_j[1], n_kf)
    st = lt.close(port, q, det_t[0], det_t[1], n_kf)
    np.testing.assert_allclose(n(st.kfs.R), np.asarray(sj.kfs.R),
                               atol=POSE_TOL)
    np.testing.assert_allclose(n(st.kfs.t), np.asarray(sj.kfs.t),
                               atol=POSE_TOL)
    live = np.asarray(sj.lms.valid)
    np.testing.assert_allclose(n(st.lms.pos)[live],
                               np.asarray(sj.lms.pos)[live], atol=POS_TOL)
    assert [e[:2] for e in lt.loop_edges[lt.active]] == [
        e[:2] for e in lj.loop_edges[lj.active]]
    return sj, st


class TestLoopCloser:
    def test_detects_revisit(self, vocs):
        state, port, n_kf, _, _ = circular_map()
        lj, lt = closers(vocs, state, port, n_kf)
        _, dt = detect_both(lj, lt, state, port, n_kf - 1, n_kf)
        assert dt is not None
        cand, (_, _, s_m, n_inl) = dt
        assert cand == 0
        assert n_inl >= 30
        expected = 1.0 / (1.015 ** 15)
        assert abs(s_m - expected) / expected < 0.05, (s_m, expected)
        assert lt.info["host_reads"][0] == "candidates"
        assert lt.info["tried"][-1]["failed"] is None

    def test_no_detection_without_revisit(self, vocs):
        state, port, n_kf, _, _ = circular_map()
        lj, lt = closers(vocs, state, port, n_kf, n_add=n_kf - 1)
        dj, dt = detect_both(lj, lt, state, port, n_kf - 2, n_kf - 1)
        assert dt is None

    def test_rejects_geometrically_wrong_candidate(self, vocs):
        state, port, n_kf, _, _ = circular_map(scramble_revisited=True)
        lj, lt = closers(vocs, state, port, n_kf)
        _, dt = detect_both(lj, lt, state, port, n_kf - 1, n_kf)
        assert dt is None
        assert all(r["failed"] for r in lt.info["tried"])

    def test_temporal_consistency(self, vocs):
        state, port, n_kf, _, _ = circular_map(n_revisit=3)
        lj, lt = closers(vocs, state, port, n_kf, consecutive_needed=3)
        assert detect_both(lj, lt, state, port, n_kf - 3, n_kf)[1] is None
        assert lt._streak is not None and lt._streak["count"] == 1
        assert detect_both(lj, lt, state, port, n_kf - 2, n_kf)[1] is None
        assert lt._streak["count"] == 2
        _, dt = detect_both(lj, lt, state, port, n_kf - 1, n_kf)
        assert dt is not None and dt[0] == 2

    def test_streak_resets_after_misses(self, vocs):
        state, port, n_kf, _, _ = circular_map()
        lj, lt = closers(vocs, state, port, n_kf, consecutive_needed=3)
        assert detect_both(lj, lt, state, port, n_kf - 1, n_kf)[1] is None
        assert lt._streak is not None
        for q in (3, 4, 5):
            detect_both(lj, lt, state, port, q, n_kf)
        assert lt._streak is None

    def test_close_corrects_drift(self, vocs):
        state, port, n_kf, _, cs_gt = circular_map()
        lj, lt = closers(vocs, state, port, n_kf)
        dj, dt = detect_both(lj, lt, state, port, n_kf - 1, n_kf)
        q = n_kf - 1

        def centre(st):
            return -n(st.kfs.R)[q].T @ n(st.kfs.t)[q]

        err_before = np.linalg.norm(centre(port) - cs_gt[q])
        _, st = close_both(lj, lt, state, port, q, dj, dt, n_kf)
        err_after = np.linalg.norm(centre(st) - cs_gt[q])
        assert err_after < 0.5 * err_before, (err_before, err_after)
        assert len(lt.loop_edges[lt.active]) == 1
        assert lt.loop_edges[lt.active][0][:2] == (q, dt[0])

    def test_second_closure_preserves_first_loop(self, vocs):
        state, port, n_kf, _, _ = circular_map(n_revisit=2)
        lj, lt = closers(vocs, state, port, n_kf)
        q1 = n_kf - 2
        dj, dt = detect_both(lj, lt, state, port, q1, n_kf)
        assert dt is not None and dt[0] == 0
        state, port = close_both(lj, lt, state, port, q1, dj, dt, n_kf)

        def rel(st, i, j):
            one = torch.ones(())
            return tlie.sim3_mul(st.kfs.R[i], st.kfs.t[i], one,
                                 *tlie.sim3_inv(st.kfs.R[j], st.kfs.t[j],
                                                one))

        rel1 = rel(port, q1, 0)
        q2 = n_kf - 1
        dj, dt = detect_both(lj, lt, state, port, q2, n_kf)
        assert dt is not None and dt[0] == 1
        _, port2 = close_both(lj, lt, state, port, q2, dj, dt, n_kf)
        assert len(lt.loop_edges[lt.active]) == 2
        rel2 = rel(port2, q1, 0)
        dR = n(tlie.so3_log(rel1[0] @ rel2[0].T))
        assert np.linalg.norm(dR) < 0.05, dR
        assert np.linalg.norm(n(rel1[1] - rel2[1])) < 0.15


def test_replay_improves_preloop_frames(vocs):
    """Frames logged before the closure relative to their keyframes come
    out more accurate when replayed after it (the port's trajectory log on
    the port's corrected map)."""
    state, port, n_kf, _, cs_gt = circular_map()
    lj, lt = closers(vocs, state, port, n_kf)
    log = TrajectoryLog()
    R_np, t_np = n(port.kfs.R), n(port.kfs.t)
    for k in range(n_kf):
        log.log(float(k), R_np[k], t_np[k], k, R_np[k], t_np[k])

    def ate(st):
        out = log.replay(n(st.kfs.R), n(st.kfs.t))
        est = evaluate.camera_centers(np.stack([R for _, R, _ in out]),
                                      np.stack([t_ for _, _, t_ in out]))
        return evaluate.horn_align(est, cs_gt, with_scale=False)[3]

    ate_before = ate(port)
    dj, dt = detect_both(lj, lt, state, port, n_kf - 1, n_kf)
    _, st = close_both(lj, lt, state, port, n_kf - 1, dj, dt, n_kf)
    ate_after = ate(st)
    assert ate_after < 0.6 * ate_before, (ate_before, ate_after)


def test_ladder_reads(vocs):
    """The device ladder's reads: the candidates once, then per verified
    candidate three packed reads in ladder order (the JAX ladder reads the
    match, both keyframes' landmarks, the observation table and each
    stage's count)."""
    state, port, n_kf, _, _ = circular_map()
    _, lt = closers(vocs, state, port, n_kf)
    lt.detect(port, n_kf - 1, n_kf)
    c = lt.info["tried"][0]["cand"]
    assert lt.info["host_reads"] == ["candidates"] + [
        f"candidate {c} {r}" for r in tlc.HOST_READS]


def test_merge_waits_for_12c(vocs):
    """The merge branch is ported (``test_torch_merge_detect.py`` holds it
    against the JAX package): with one map in the atlas ``detect_merge``
    mines nothing, and ``on_maps_merged`` of an empty weld drops the
    removed map's database and loop edges."""
    state, port, n_kf = circular_map()[:3]
    _, lt = closers(vocs, state, port, n_kf)
    at = tatlas.Atlas(MAX_KF, port.lms.pos.shape[0], port.obs.kf.shape[1],
                      N_FEAT, device="cpu")
    at.maps, at.meta = [port], [tatlas.MapMeta(n_kf, n_kf * 60)]
    assert lt.detect_merge(port, n_kf - 1, at) is None
    assert lt.info["maps"] == [] and lt._merge_streak is None
    lt.switch_map(1)
    lt.loop_edges[1] = [(0, 1, None)]
    lt.on_maps_merged(0, 1, port, n_kf, n_kf)
    assert sorted(lt.dbs) == [0] and lt.active == 0
    assert lt.loop_edges == {0: []}
