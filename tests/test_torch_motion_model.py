"""Port parity: the motion model (both of frame_step's tries) and the local
window selection, against the JAX package.

The motion model runs on the JAX package's own features (extracted and
undistorted by it) of a small cut of the EuRoC-mono scene. The window
selection replays the cases of tests/test_local_window.py and adds one at
4096 landmarks with heavy score ties and truncation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import mono_scene, n, small_mono_config, t

from orbslam3_byzyh_tpu.ops import camera as jcam
from orbslam3_byzyh_tpu.ops import fast_orb as jfo
from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

CFG = small_mono_config()


@pytest.fixture(scope="module")
def jax_feats():
    """The JAX package's features of the scene's frame, undistorted by it
    (numpy: xy, level, desc uint32, angle, valid)."""
    img = graft.example_image(CFG.height, CFG.width)
    f = jfo.extract(jnp.asarray(img), n_features=CFG.n_features)
    cam = jnp.asarray([CFG.fx, CFG.fy, CFG.cx, CFG.cy], jnp.float32)
    xy = jcam.undistort_pixels(cam, jnp.asarray(CFG.dist, jnp.float32), f.xy)
    return tuple(np.asarray(a) for a in (xy, f.level, f.desc, f.angle,
                                         f.valid))


@pytest.mark.parametrize("case,start,radius", [
    ("normal", "pred", 15.0), ("retry", "pred", 15.0),
    ("retry", "last", 30.0)])
def test_track_motion_model_matches_jax(jax_feats, case, start, radius):
    sc = mono_scene(jax_feats, CFG, case)
    xy, level, desc, angle, valid = jax_feats
    R0, t0 = (sc.R_pred, sc.t_pred) if start == "pred" else (sc.R_last,
                                                              sc.t_last)
    args = (R0, t0, sc.lm_pos, sc.lm_valid, sc.last_bind, sc.last_desc, xy,
            level, desc, valid, sc.cam_params)
    ref = jtr.track_motion_model(
        *[jnp.asarray(a) for a in args], radius=radius,
        last_angle=jnp.asarray(sc.last_angle), feats_angle=jnp.asarray(angle))
    out = ttr.track_motion_model(
        *convert.tree_to_torch(args, "cpu"), radius=radius,
        last_angle=t(sc.last_angle), feats_angle=t(angle))
    np.testing.assert_array_equal(n(out.bindings), n(ref.bindings))
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=1e-4)
    # The scene's cases: the predicted pose of the retry scene leaves the
    # 15 px window, so frame_step must take the retry, which tracks the
    # last frame's bound keypoints.
    if (case, start) == ("retry", "pred"):
        assert int(out.n_inliers) < ttr.RETRY_BELOW
    else:
        assert int(out.n_inliers) >= 0.9 * (sc.last_bind >= 0).sum()


def _window(fn, last_bind, obs_kf, obs_valid, lm_valid, n_kf, max_kf=16,
            **kw):
    conv = jnp.asarray if fn is jtr.select_local_window else t
    return fn(conv(np.asarray(last_bind, np.int32)),
              conv(np.asarray(obs_kf, np.int32)), conv(np.asarray(obs_valid)),
              conv(np.asarray(lm_valid)), conv(np.int32(n_kf)),
              max_kf=max_kf, **kw)


def _assert_same_window(*args, **kw):
    ref = _window(jtr.select_local_window, *args, **kw)
    out = _window(ttr.select_local_window, *args, **kw)
    for name in ("lm_ids", "lm_ok", "loc"):
        np.testing.assert_array_equal(n(getattr(out, name)),
                                      n(getattr(ref, name)), err_msg=name)
    return out


def _small_world(extra_bind=None):
    """test_local_window's world: landmarks 0-5 seen by old KFs (0, 1),
    6-11 by recent KFs (8, 9); the last frame binds 6 and 7."""
    L, O = 16, 4
    obs_kf = np.full((L, O), -1, np.int32)
    obs_valid = np.zeros((L, O), bool)
    obs_kf[:6, :2], obs_kf[6:12, :2] = [0, 1], [8, 9]
    obs_valid[:12, :2] = True
    lm_valid = np.zeros(L, bool)
    lm_valid[:12] = True
    last_bind = np.full(8, -1, np.int32)
    last_bind[:2] = [6, 7]
    if extra_bind is not None:
        last_bind[2] = extra_bind
    return last_bind, obs_kf, obs_valid, lm_valid


@pytest.mark.parametrize("name,extra,kw", [
    ("excludes_old_structure", None,
     dict(n_local_kf=2, n_local_lm=8, recent_kf=2)),
    ("includes_old_structure_when_bound", 0,
     dict(n_local_kf=4, n_local_lm=16, recent_kf=2)),
    ("truncation_prefers_bound", None,
     dict(n_local_kf=2, n_local_lm=2, recent_kf=2)),
    ("loc_is_inverse", None, dict(n_local_kf=2, n_local_lm=8, recent_kf=2)),
])
def test_select_local_window_cases(name, extra, kw):
    win = _assert_same_window(*_small_world(extra), n_kf=10, **kw)
    ids = set(n(win.lm_ids)[n(win.lm_ok)])
    expect = {"excludes_old_structure": set(range(6, 12)),
              "includes_old_structure_when_bound": set(range(12)),
              "truncation_prefers_bound": {6, 7},
              "loc_is_inverse": set(range(6, 12))}[name]
    assert ids == expect
    loc = n(win.loc)
    for w, (i, ok) in enumerate(zip(n(win.lm_ids), n(win.lm_ok))):
        if ok:
            assert loc[i] == w


def test_select_local_window_ties_and_truncation(rng):
    """L = 4096 rows whose scores take 4 values (heavy ties), more local
    candidates than the 1024-row window, bound ids scattered, invalid and
    -1 observations mixed in."""
    L, O, max_kf, n_kf = 4096, 12, 64, 50
    obs_kf = rng.integers(0, n_kf, (L, O)).astype(np.int32)
    obs_valid = rng.random((L, O)) < 0.3
    obs_kf[rng.random((L, O)) < 0.1] = -1
    lm_valid = rng.random(L) < 0.9
    last_bind = np.where(rng.random(300) < 0.8,
                         rng.choice(L, 300, replace=False), -1)
    win = _assert_same_window(last_bind, obs_kf, obs_valid, lm_valid, n_kf,
                              max_kf=max_kf, n_local_kf=20, n_local_lm=1024,
                              recent_kf=4)
    assert bool(n(win.lm_ok).all())                     # truncated
    ok_bound = set(last_bind[last_bind >= 0][lm_valid[last_bind[
        last_bind >= 0]]])
    assert ok_bound <= set(n(win.lm_ids))               # bound ranked first


def test_window_gather_is_identity_when_the_map_fits(jax_feats):
    """track_local_map_windowed falls through to track_local_map when the
    landmark capacity fits the window (as in the JAX package)."""
    sc = convert.tree_to_torch(mono_scene(jax_feats, CFG, "normal"), "cpu")
    a = graft.MonoFrameArgs(*sc)
    f = convert.tree_to_torch(jax_feats, "cpu")
    lm = (a.lm_pos, a.lm_desc, a.lm_normal, a.lm_min_d, a.lm_max_d,
          a.lm_valid)
    bind = torch.full((CFG.n_features,), -1, dtype=torch.int32)
    full = ttr.track_local_map(a.R_pred, a.t_pred, bind, *lm, f[0], f[1],
                               f[2], f[4], a.cam_params, CFG.width,
                               CFG.height)
    win = ttr.track_local_map_windowed(
        a.R_pred, a.t_pred, bind, *lm, a.obs_kf, a.obs_valid, a.n_kf, f[0],
        f[1], f[2], f[4], None, None, a.cam_params, CFG.width, CFG.height,
        max_kf=CFG.max_kf, n_local_lm=CFG.max_lm)
    assert torch.equal(full.bindings, win.bindings)
    assert int(full.n_inliers) == int(win.n_inliers) > 0
