"""Port parity: the monocular initial map against the JAX package's.

* The scatter Schur assembly (``ba.schur_pieces_scatter``) against the
  one-hot form (``ba.schur_pieces``, itself held against the JAX package in
  test_torch_ba.py): every piece within 1e-5 relative to its largest entry.
* ``mapping._full_ba_problem`` and ``mapping.local_ba`` against the JAX
  package's on a small map (``graft.euroc_mono_map`` at this file's
  configuration): poses 1e-4, every integer and bool array equal, positions
  1e-3 m (``torch_port_util.assert_states_close``, which prints any landmark
  that an LM step with costs equal to float32 rounding moved along its ray).
* ``graft.mono_initialize`` against a JAX ``MonoSlam``'s own
  ``_try_initialize`` on the same two frames (``graft.euroc_mono_two_view``
  of 640 features extracted from the EuRoC-size example image;
  ``min_init_matches`` 60 as in test_golden.py; no vocabulary, loop closing
  and background GBA off). The port takes the indices the JAX system drew:
  ``jax.random.split(PRNGKey(0))`` as the system splits its key, over the
  JAX matches. Both keyframes' poses 1e-4, landmark positions 1e-3 at
  median-depth scale, the tables and bindings equal, ``check_invariants``
  empty. The JAX package's ``two_view_reconstruct`` runs under ``jax.jit``
  here (the same code, compiled once instead of op by op).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_ba
import torch
from torch_port_util import (assert_states_close, jax_feats, jax_map_state,
                             n, t)

from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.ops import fast_orb
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.solver import ba as tba
from orbslam3_byzyh_tpu_torch.solver import lm as tlm

# EuRoC-mono's camera with 640 features, 16 keyframe and 1024 landmark
# slots, 8 observations and the 60-match gate.
CFG = graft.EUROC_MONO._replace(n_features=640, max_kf=16, max_lm=1024,
                                max_obs=8, min_init_matches=60)
CAM = np.array([CFG.fx, CFG.fy, CFG.cx, CFG.cy], np.float32)


@functools.cache
def _ref_feats():
    img = t(graft.example_image(CFG.height, CFG.width))
    f = graft.mono_extract(img, t(CAM), t(np.array(CFG.dist, np.float32)),
                           CFG)
    return fast_orb.FrameFeatures(*(n(a) for a in f))


@functools.cache
def _small_map():
    return graft.euroc_mono_map(CFG, n_live_kf=12, view_points=200)


def _np_state(state):
    return type(state)(*(type(g)(*(np.asarray(a) for a in g))
                         for g in state))


def _torch_feats(f):
    return fast_orb.FrameFeatures(*convert.tree_to_torch(f, "cpu"))


def _rel_close(got, ref, tol, what):
    ref = np.asarray(ref)
    err = np.abs(n(got) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _system(problem, inlier):
    return tba._build_system(problem, problem.R, problem.t, problem.points,
                             inlier, 0, True, tlm.CHI2_MONO)


def _scatter_cases():
    """test_ba.py's refine problem with dead rows, and the small map's
    full-map problem (every slot, most of them empty)."""
    rng = np.random.default_rng(5)
    X, Rs, ts, okf, ouv, oval = test_ba.synth_ba(rng)
    oval[::9, 2] = False
    okf = np.where(oval, okf, -1).astype(np.int32)
    fixed = np.zeros(len(Rs), bool)
    fixed[:2] = True
    p = tba.BAProblem(*(t(np.asarray(a)) if a is not None else None
                        for a in test_ba.make_problem(X, Rs, ts, okf, ouv,
                                                      oval, fixed)))
    lm_valid = np.ones(len(X), bool)
    lm_valid[3] = False
    yield "synth", p._replace(lm_valid=t(lm_valid))
    m = _small_map()
    free = torch.zeros(CFG.max_kf, dtype=torch.bool)
    free[m.kf_id - 3:m.kf_id] = True
    yield "map", tmap._full_ba_problem(convert.map_state_to_torch(
        m.state, "cpu"), free, t(m.cam_params))


@pytest.mark.parametrize("case", ["synth", "map"])
def test_scatter_assembly_matches_one_hot(case):
    p = dict(_scatter_cases())[case]
    inlier = torch.ones_like(p.obs_valid)
    inlier[::5, 0] = False
    sys = _system(p, inlier)
    n_kf = p.R.shape[0]
    lam = torch.tensor(1e-3)
    ref = tba.schur_pieces(p.obs_kf, sys, lam, n_kf)
    got = tba.schur_pieces_scatter(p.obs_kf, sys, lam, n_kf)
    for k in ("Hpp", "bp", "cross", "corr", "Hll_inv"):
        _rel_close(got[k], n(ref[k]), 1e-5, k)
    assert torch.equal(got["has_obs"], ref["has_obs"])
    assert float(ref["cross"].abs().max()) > 0


def test_bundle_adjust_with_either_assembly():
    """The whole BA on the small map with either assembly, written back
    into the map: as ``assert_states_close`` holds two packages, and the
    cost within 1e-4."""
    m = _small_map()
    state = convert.map_state_to_torch(m.state, "cpu")
    p = dict(_scatter_cases())["map"]
    a = tba.bundle_adjust(p)
    b = tba.bundle_adjust(p, assembly=tba.schur_pieces_scatter)
    assert_states_close(
        convert.map_state_to_numpy(tmap._apply_ba_result(state, a)),
        convert.map_state_to_numpy(tmap._apply_ba_result(state, b)),
        m.cam_params)
    np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4)


def _jax_free(m):
    free = np.zeros(CFG.max_kf, bool)
    free[m.kf_id - 3:m.kf_id] = True
    return free


def test_full_ba_problem_matches_jax():
    m = _small_map()
    free = _jax_free(m)
    ref = jmap._full_ba_problem(jax_map_state(m.state), jnp.asarray(free),
                                jnp.asarray(m.cam_params))
    got = tmap._full_ba_problem(convert.map_state_to_torch(m.state, "cpu"),
                                t(free), t(m.cam_params))
    for name in ("R", "t", "points", "obs_kf", "obs_uv", "obs_w",
                 "obs_valid", "fixed", "lm_valid", "cam_params"):
        np.testing.assert_array_equal(n(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.obs_ur is None and got.bf is None


def test_local_ba_matches_jax():
    """Three keyframes free over the whole small map, every other keyframe
    and every landmark slot in the problem."""
    m = _small_map()
    free = _jax_free(m)
    ref = _np_state(jmap.local_ba(jax_map_state(m.state), jnp.asarray(free),
                                  jnp.asarray(m.cam_params)))
    got = tmap.local_ba(convert.map_state_to_torch(m.state, "cpu"), t(free),
                        t(m.cam_params))
    assert_states_close(ref, convert.map_state_to_numpy(got), m.cam_params)
    moved = np.abs(ref.kfs.R - m.state.kfs.R).max((1, 2)) > 0
    np.testing.assert_array_equal(moved, free & m.state.kfs.valid)
    # With use_stereo and no keypoint holding a right-image u (the small
    # map's kp_ur is -1 throughout) the full-map BA gives the mono result;
    # its stereo rows are held against the JAX package in
    # test_torch_mapping.py and test_torch_keyframe_step.py.
    stereo = tmap.local_ba(convert.map_state_to_torch(m.state, "cpu"),
                           t(free), t(m.cam_params), use_stereo=True, bf=40.0)
    assert_states_close(convert.map_state_to_numpy(got),
                        convert.map_state_to_numpy(stereo), m.cam_params)


@functools.cache
def _scene(case):
    return graft.euroc_mono_two_view(_ref_feats(), CFG, case)


@functools.cache
def _jax_init(case):
    """A JAX MonoSlam's own _try_initialize on the scene: (the map as numpy
    or None, the bindings, the RANSAC indices its key drew, the result)."""
    from orbslam3_byzyh_tpu.pipeline import system as jsys

    scene = _scene(case)
    slam = jsys.MonoSlam(jsys.SlamConfig(
        fx=CFG.fx, fy=CFG.fy, cx=CFG.cx, cy=CFG.cy, width=CFG.width,
        height=CFG.height, n_features=CFG.n_features, max_kf=CFG.max_kf,
        max_lm=CFG.max_lm, max_obs=CFG.max_obs,
        min_init_matches=CFG.min_init_matches, use_loop_closing=False,
        background_gba=False, device_mesh=False))
    ref, cur = jax_feats(scene.ref), jax_feats(scene.cur)
    mj = jtr.match_for_initialization(
        ref.xy, ref.desc, ref.valid, ref.level, cur.xy, cur.desc, cur.valid,
        cur.level, ref_angle=ref.angle, cur_angle=cur.angle)
    _, sub = jax.random.split(slam.rng_key)
    idx = np.asarray(jgeo._sample_indices(
        sub, 200, 8, (mj >= 0).astype(jnp.float32) + 1e-9))
    two_view = jgeo.two_view_reconstruct
    jgeo.two_view_reconstruct = jax.jit(two_view)
    try:
        assert slam._try_initialize(ref, 0.0) is None
        pose = slam._try_initialize(cur, 0.05)
    finally:
        jgeo.two_view_reconstruct = two_view
    if pose is None:
        return None, None, idx, int((mj >= 0).sum())
    return (_np_state(slam.state), np.asarray(slam._last["bindings"]), idx,
            int((mj >= 0).sum()))


def _port_init(case, idx, cfg=CFG):
    scene = _scene(case)
    state = tms.empty_map(cfg.max_kf, cfg.max_lm, cfg.max_obs,
                          cfg.n_features, device="cpu")
    return state, graft.mono_initialize(
        state, _torch_feats(scene.ref), _torch_feats(scene.cur), 0.0, 0.05,
        t(CAM), idx=t(idx).long(), cfg=cfg)


@pytest.mark.parametrize("case", ["general", "planar"])
def test_mono_initialize_matches_jax_system(case):
    ref_state, ref_bind, idx, n_matches = _jax_init(case)
    assert ref_state is not None
    _, res = _port_init(case, idx)
    assert res.success and res.info["reason"] is None
    assert res.info["n_matches"] == n_matches >= CFG.min_init_matches
    assert res.info["used_h"] == (case == "planar")
    assert res.info["host_reads"] == list(graft.INIT_HOST_READS)
    got = convert.map_state_to_numpy(res.state)
    assert_states_close(ref_state, got, CAM)
    np.testing.assert_array_equal(n(res.bindings), ref_bind)
    assert tms.check_invariants(res.state, 2, CFG.max_lm) == []
    n_new = int(got.lms.valid.sum())
    assert n_new >= 50 and int((n(res.bindings) >= 0).sum()) == \
        res.info["n_good"]
    # Median-depth scale: the new landmarks' median depth in keyframe 0
    # was 1 before the BA, which holds keyframe 0 fixed.
    z = got.lms.pos[got.lms.valid][:, 2]
    assert abs(np.median(z) - 1.0) < 0.05
    scene = _scene(case)
    cos_t = float(n(res.t) @ scene.t) / (np.linalg.norm(n(res.t))
                                        * np.linalg.norm(scene.t))
    assert cos_t > 0.99


def test_mono_initialize_fails_without_parallax():
    """A pure rotation: both packages fail and the port's map is the one
    it was given."""
    ref_state, _, idx, _ = _jax_init("rotation")
    assert ref_state is None
    state, res = _port_init("rotation", idx)
    assert not res.success and res.info["reason"] == "two_view"
    assert res.state is state and res.bindings is None
    assert res.info["host_reads"] == list(graft.INIT_HOST_READS[:2])


def test_mono_initialize_gate_and_indices():
    """Too few matches fail before the RANSAC; without indices the port
    draws them from the generator it is given, and needs one."""
    idx = _jax_init("general")[2]
    state, res = _port_init("general", idx,
                            CFG._replace(min_init_matches=10 ** 6))
    assert not res.success and res.info["reason"] == "matches"
    assert res.state is state and "idx" not in res.info
    scene = _scene("general")
    args = (tms.empty_map(CFG.max_kf, CFG.max_lm, CFG.max_obs,
                          CFG.n_features, device="cpu"),
            _torch_feats(scene.ref), _torch_feats(scene.cur), 0.0, 0.05,
            t(CAM))
    with pytest.raises(ValueError, match="generator"):
        graft.mono_initialize(*args, cfg=CFG)
    res = graft.mono_initialize(*args, cfg=CFG,
                                generator=torch.Generator().manual_seed(1))
    assert res.success and not res.info["used_h"]
    assert res.info["idx"].shape == (200, 8)


def test_euroc_mono_two_view_cases():
    """The scene's second frame: full, its kept keypoints the reference's
    levels and near-equal descriptors, the truth a rotation with a 0.2 m
    baseline (none in the rotation case)."""
    f = _ref_feats()
    for case in ("general", "planar", "rotation"):
        s = graft.euroc_mono_two_view(f, CFG, case)
        assert s.cur.xy.shape == (CFG.n_features, 2)
        assert s.cur.desc.dtype == np.uint32 and s.cur.valid.all()
        np.testing.assert_allclose(s.R @ s.R.T, np.eye(3), atol=1e-6)
        base = np.linalg.norm(s.t)
        assert (base == 0) == (case == "rotation")
        if case != "rotation":
            assert abs(base - 0.2) < 0.01
    with pytest.raises(ValueError, match="case"):
        graft.euroc_mono_two_view(f, CFG, "sideways")
