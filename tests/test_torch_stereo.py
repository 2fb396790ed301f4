"""Port parity: rectified stereo matching (``ops/stereo.py``) and the stereo
local-map track (``tracking.track_local_map_stereo``,
``track_local_map_windowed(use_stereo=True)``) against the JAX package.

``stereo_match`` runs on test_stereo.py's rendered pair (``SynthWorld(seed=5)``,
baseline 0.2 m) and its row-shift case, both packages on the port's
features. Everything before the median sweep is exact: u_right, depth and
the accepted rows are equal.

The sweep is the intended difference. The JAX package takes
``jnp.median(where(ok, sad, nan))``, which is NaN as soon as one keypoint
lacks a match, so its threshold is 1e9 and its sweep removes nothing; the
port takes Frame.cc's median (the accepted SADs sorted, the element at
count // 2) and removes exactly the rows whose SAD exceeds 1.5 x 1.4 times
it, which a numpy version of that rule checks.

The local-map track with stereo rows: bindings and inlier counts equal,
poses within 1e-4 (the K3s plain version against the JAX XLA path).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from torch_port_util import mono_scene, n, small_mono_config, t

from orbslam3_byzyh_tpu.ops import stereo as jst
from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo
from orbslam3_byzyh_tpu_torch.ops import stereo as tst
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

BASELINE = 0.2
MIN_Z = 0.4


@pytest.fixture(scope="module")
def pair():
    """test_stereo.py's rectified pair: (left, right, bf, the truth's
    depth of each scene point, the world)."""
    world = SynthWorld(seed=5)
    R, tt = world.pose(0.0)
    img_l = world.render(0.0)
    world_r = copy.copy(world)
    t_r = tt - np.array([BASELINE, 0, 0], np.float32)
    world_r.pose = lambda _: (R, t_r)
    img_r = world_r.render(0.0)
    return img_l, img_r, float(np.float32(BASELINE * world.fx)), world


def _features(img, n_features):
    return tfo.extract(torch.from_numpy(img), n_features=n_features)


def _jax(f):
    return [jnp.asarray(convert.desc_to_uint32(a)) if k == "desc"
            else jnp.asarray(n(a)) for k, a in
            zip(("xy", "level", "desc", "valid"),
                (f.xy, f.level, f.desc, f.valid))]


def _both(pair, n_features, shift=0.0):
    img_l, img_r, bf, _ = pair
    fl, fr = _features(img_l, n_features), _features(img_r, n_features)
    fr = fr._replace(xy=fr.xy + torch.tensor([0.0, shift]))
    ref = jst.stereo_match(*_jax(fl), *_jax(fr), jnp.asarray(img_l),
                           jnp.asarray(img_r), jnp.asarray(bf, jnp.float32),
                           MIN_Z)
    args = (fl.xy, fl.level, fl.desc, fl.valid, fr.xy, fr.level, fr.desc,
            fr.valid, torch.from_numpy(img_l), torch.from_numpy(img_r), bf,
            MIN_Z)
    return ref, args, fl


@pytest.mark.parametrize("n_features,shift", [(1024, 0.0), (512, 25.0)])
def test_before_the_sweep_equals_jax(pair, n_features, shift):
    """Exact: the row / disparity / level gates, the Hamming search, the SAD
    and the parabola. In the row-shift case (the right keypoints 25 px
    down) the row constraint leaves under 10 % of the rows matched."""
    ref, args, _ = _both(pair, n_features, shift)
    u_right, disp, ok, _ = (n(a) for a in tst.match_and_refine(*args))
    np.testing.assert_array_equal(ok, np.asarray(ref.valid))
    np.testing.assert_array_equal(np.where(ok, u_right, -1.0),
                                  np.asarray(ref.u_right))
    np.testing.assert_array_equal(
        np.where(ok, np.float32(args[10]) / disp, -1.0),
        np.asarray(ref.depth))
    if shift:
        assert n(tst.stereo_match(*args).valid).mean() < 0.1
    else:
        assert ok.sum() > 150


def test_jax_median_is_nan_so_its_sweep_never_fires(pair):
    """The reference fault: a keypoint without a match puts a NaN into
    ``jnp.median``, so its threshold becomes 1e9 and the JAX output equals
    the port's before the sweep (the test above), the sweep undone."""
    ref, args, _ = _both(pair, 1024)
    ok = np.asarray(ref.valid)
    assert 0 < ok.sum() < len(ok)
    sad = jnp.arange(len(ok), dtype=jnp.float32)     # any finite SADs
    assert np.isnan(float(jnp.median(jnp.where(ok, sad, jnp.nan))))
    assert np.isfinite(float(jnp.nanmedian(jnp.where(ok, sad, jnp.nan))))


def test_sweep_removes_exactly_the_frame_cc_rows(pair):
    """The port's sweep against a numpy Frame::ComputeStereoMatches rule on
    the same SADs: the accepted SADs sorted, the median at index n // 2,
    every row whose SAD exceeds 1.5 x 1.4 x that median removed."""
    _, args, _ = _both(pair, 1024)
    u_right, disp, ok, sad = (n(a) for a in tst.match_and_refine(*args))
    med = np.sort(sad[ok])[ok.sum() // 2]
    keep = ok & (sad <= np.float32(1.5 * 1.4) * med)
    out = tst.stereo_match(*args)
    np.testing.assert_array_equal(n(out.valid), keep)
    assert 0 < (ok & ~keep).sum() < 0.5 * ok.sum()     # the sweep fires
    np.testing.assert_array_equal(n(out.u_right), np.where(keep, u_right,
                                                           -1.0))
    bf = np.float32(args[10])
    np.testing.assert_array_equal(n(out.depth),
                                  np.where(keep, bf / disp, -1.0))


def test_median_of_accepted():
    x = torch.tensor([5.0, 1.0, 3.0, 9.0, 2.0, 7.0])
    for mask, want in (([1, 1, 0, 1, 0, 0], 5.0), ([1, 1, 1, 1, 1, 1], 5.0),
                       ([0, 1, 0, 0, 1, 0], 2.0), ([0] * 6, float("inf"))):
        got = tst.median_of_accepted(x, torch.tensor(mask, dtype=torch.bool))
        assert float(got) == want


def test_depth_recovery(pair):
    """test_stereo.py's depth check on the port's output (sweep included):
    the median relative depth error against the nearest true point under
    5 %."""
    img_l, _, _, world = pair
    _, args, fl = _both(pair, 1024)
    out = tst.stereo_match(*args)
    valid, depth, xy = n(out.valid), n(out.depth), n(fl.xy)
    assert valid.sum() > 150
    R, tt = world.pose(0.0)
    pc = world.pts @ R.T + tt
    uv = np.stack([world.fx * pc[:, 0] / pc[:, 2] + world.cx,
                   world.fy * pc[:, 1] / pc[:, 2] + world.cy], -1)
    errs = []
    for i in np.flatnonzero(valid):
        j = np.linalg.norm(uv - xy[i], axis=-1).argmin()
        if np.linalg.norm(uv[j] - xy[i]) <= 6:
            errs.append(abs(depth[i] - pc[j, 2]) / pc[j, 2])
    assert len(errs) > 50 and np.median(errs) < 0.05


# --- The local-map track with stereo rows -----------------------------------

CFG = small_mono_config()
BF = 40.0


@pytest.fixture(scope="module")
def scene():
    """The small EuRoC-mono scene's frame and map, with a right-image u for
    60 % of the keypoints from their lifted depth (noise 0.3 px)."""
    img = t(graft.example_image(CFG.height, CFG.width))
    cam = t(np.array([CFG.fx, CFG.fy, CFG.cx, CFG.cy], np.float32))
    f = graft.mono_extract(img, cam, t(np.array(CFG.dist, np.float32)), CFG)
    feats = tuple(n(a) for a in (f.xy, f.level, f.desc, f.angle, f.valid))
    sc = mono_scene(feats, CFG, "normal")
    rng = np.random.default_rng(4)
    lm = np.where(sc.last_bind >= 0, sc.last_bind, 0)
    pc = sc.lm_pos[lm]
    ur = feats[0][:, 0] - BF / pc[:, 2] + rng.normal(0, 0.3, len(lm))
    ur = np.where((sc.last_bind >= 0) & (rng.random(len(lm)) < 0.6), ur,
                  -1.0).astype(np.float32)
    return feats, sc, ur


def _jax_windowed(sc, feats, ur, use_window):
    J = jnp.asarray
    xy, level, desc, _, valid = feats
    return jtr.track_local_map_windowed(
        J(sc.R_pred), J(sc.t_pred), J(sc.last_bind), J(sc.lm_pos),
        J(sc.lm_desc), J(sc.lm_normal), J(sc.lm_min_d), J(sc.lm_max_d),
        J(sc.lm_valid), J(sc.obs_kf), J(sc.obs_valid), J(sc.n_kf), J(xy),
        J(level), J(desc.view(np.uint32)), J(valid), J(ur),
        jnp.asarray(BF, jnp.float32), J(sc.cam_params), CFG.width,
        CFG.height, use_stereo=True,
        max_kf=CFG.max_kf if use_window else 0, n_local_kf=CFG.n_local_kf,
        n_local_lm=CFG.n_local_lm, recent_kf=CFG.recent_kf)


@pytest.mark.parametrize("use_window", [True, False])
def test_track_local_map_stereo_matches_jax(scene, use_window):
    """With the window (``select_local_window``) and over the whole map
    (``track_local_map_stereo`` itself)."""
    feats, sc, ur = scene
    ref = _jax_windowed(sc, feats, ur, use_window)
    a = graft.MonoFrameArgs(*convert.tree_to_torch(sc, "cpu"))
    xy, level, desc, _, valid = (t(x) for x in feats)
    out = ttr.track_local_map_windowed(
        a.R_pred, a.t_pred, a.last_bind, a.lm_pos, a.lm_desc, a.lm_normal,
        a.lm_min_d, a.lm_max_d, a.lm_valid, a.obs_kf, a.obs_valid, a.n_kf,
        xy, level, desc, valid, t(ur), BF, a.cam_params, CFG.width,
        CFG.height, use_stereo=True, max_kf=CFG.max_kf if use_window else 0,
        n_local_kf=CFG.n_local_kf, n_local_lm=CFG.n_local_lm,
        recent_kf=CFG.recent_kf)
    np.testing.assert_array_equal(n(out.bindings), np.asarray(ref.bindings))
    assert int(out.n_inliers) == int(ref.n_inliers) > 0.5 * valid.sum()
    np.testing.assert_allclose(n(out.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(out.t), np.asarray(ref.t), atol=1e-4)


def test_keyframe_compaction_carries_kp_ur():
    """``map_state.compact_keyframes`` moves each live keyframe's right-image
    u with it, as the JAX package's does: the small planted map (three
    keyframes culled) with ``kp_ur`` planted, every array equal."""
    from test_torch_atlas_traj import _planted_map, _states_equal
    from torch_port_util import jax_map_state, plant_ur

    from orbslam3_byzyh_tpu.models import map_state as jms
    from orbslam3_byzyh_tpu_torch.models import map_state as tms
    state, m = _planted_map()
    state = plant_ur(state, np.random.default_rng(3), BF)
    ref, ref_o2n, _ = jms.compact_keyframes(jax_map_state(state), m.kf_id)
    got, o2n, n_valid = tms.compact_keyframes(
        convert.map_state_to_torch(state, "cpu"), m.kf_id)
    np.testing.assert_array_equal(o2n, ref_o2n)
    _states_equal(type(ref)(*(type(g)(*(np.asarray(a) for a in g))
                              for g in ref)), convert.map_state_to_numpy(got))
    old = np.flatnonzero(o2n >= 0)
    kp_ur = n(got.kfs.kp_ur)
    np.testing.assert_array_equal(kp_ur[o2n[old]], state.kfs.kp_ur[old])
    assert (kp_ur[:n_valid] >= 0).any()
