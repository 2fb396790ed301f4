"""Port parity: the reference-keyframe fallback and the initialization
matcher against the JAX package at a small cut of the EuRoC-mono scene, and
the port's ``mono_frame_step`` at the full EuRoC-mono configuration
(752x480, 1200 features, 65536 landmark and 1024 keyframe slots) through
the plain versions on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_util import mono_scene, n, small_mono_config, t

from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr
from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

CFG = small_mono_config()
FULL = graft.EUROC_MONO


def _features(cfg):
    img = t(graft.example_image(cfg.height, cfg.width))
    cam = t(np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], np.float32))
    f = graft.mono_extract(img, cam, t(np.array(cfg.dist, np.float32)), cfg)
    return tuple(n(a) for a in (f.xy, f.level, f.desc, f.angle, f.valid))


@pytest.fixture(scope="module")
def feats():
    return _features(CFG)


@pytest.fixture(scope="module")
def full_feats():
    return _features(FULL)


def test_track_reference_keyframe_matches_jax(feats):
    """The fallback from the last pose of the retry scene, against a
    reference keyframe that holds the last frame's keypoints (K2's none
    mode on the card; its plain version here)."""
    sc = mono_scene(feats, CFG, "retry")
    xy, level, desc, angle, valid = feats
    args = (sc.R_last, sc.t_last, sc.last_desc, sc.last_angle,
            sc.last_bind >= 0, sc.last_bind, sc.lm_pos, sc.lm_valid, xy,
            level, desc.view(np.uint32), valid, angle, sc.cam_params)
    ref = jtr.track_reference_keyframe(*[jnp.asarray(a) for a in args])
    out = ttr.track_reference_keyframe(*convert.tree_to_torch(args, "cpu"))
    np.testing.assert_array_equal(n(out.bindings), n(ref.bindings))
    assert int(out.n_inliers) == int(ref.n_inliers)
    assert int(out.n_inliers) >= 0.9 * (sc.last_bind >= 0).sum()
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=1e-4)


@pytest.mark.parametrize("angles", [False, True])
def test_match_for_initialization_matches_jax(feats, rng, angles):
    """The two-view initialization match: the frame against itself moved
    by a few pixels, with some descriptors perturbed and duplicated."""
    xy, level, desc, angle, valid = feats
    desc = desc.view(np.uint32)
    cur_xy = (xy + rng.normal(0, 3, xy.shape)).astype(np.float32)
    cur_desc = desc.copy()
    cur_desc[::7] ^= np.uint32(0x0F0F)
    cur_desc[1::11] = cur_desc[0::11][:len(cur_desc[1::11])]
    cur_angle = (angle + np.where(rng.random(len(angle)) < 0.8, 0.2,
                                  rng.uniform(-3, 3, len(angle)))
                 ).astype(np.float32)
    args = (xy, desc, valid, level, cur_xy, cur_desc, valid, level)
    kw_j = kw_t = {}
    if angles:
        kw_j = dict(ref_angle=jnp.asarray(angle),
                    cur_angle=jnp.asarray(cur_angle))
        kw_t = dict(ref_angle=t(angle), cur_angle=t(cur_angle))
    ref = jtr.match_for_initialization(*[jnp.asarray(a) for a in args],
                                       **kw_j)
    out = ttr.match_for_initialization(*convert.tree_to_torch(args, "cpu"),
                                       **kw_t)
    assert (n(ref) >= 0).sum() > 20
    np.testing.assert_array_equal(n(out), n(ref))


@pytest.mark.parametrize("case", ["normal", "retry"])
def test_mono_frame_step_full_size_cpu(full_feats, case):
    """The entry point at the EuRoC-mono configuration on the CPU (the
    plain versions; no kernel launches): the frame tracks back to the
    identity, and in the retry case the reference-keyframe fallback tracks
    too."""
    sc = convert.tree_to_torch(graft.euroc_mono_scene(*full_feats, case=case),
                               "cpu")
    kernels = (cuda_brief.KERNEL, cuda_match.KERNEL, cuda_pose_opt.KERNEL)
    before = [k.launches for k in kernels]
    res, info, found, _ = graft.mono_frame_step(*sc)
    assert [k.launches for k in kernels] == before
    n_valid = int(full_feats[4].sum())
    assert info.shape == (16,) and int(info[0]) == int(res.n_inliers)
    assert int(res.n_inliers) >= 0.9 * n_valid
    np.testing.assert_allclose(n(res.R), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(n(res.t), 0.0, atol=1e-3)
    assert int((found - sc[18]).sum()) == int((res.bindings >= 0).sum())
    if case == "retry":
        f = graft.mono_extract(sc[0], sc[20], sc[21])
        fb = graft.mono_reference_fallback(f, graft.MonoFrameArgs(*sc))
        assert int(fb.n_inliers) >= 0.9 * n_valid
        np.testing.assert_allclose(n(fb.R), np.eye(3), atol=1e-3)
        np.testing.assert_allclose(n(fb.t), 0.0, atol=1e-3)


def test_euroc_mono_scene_shape(full_feats):
    """The scene at full capacity: 65536 landmark and 1024 keyframe slots,
    about 200 keyframes live, the lifted landmarks at scattered slots, and
    more window candidates than the window holds."""
    big = graft.euroc_mono_scene(*full_feats)
    assert big.lm_pos.shape == (65536, 3) and big.obs_kf.shape == (65536, 12)
    assert big.img.shape == (480, 752)
    assert int(big.n_kf) == 200 and int(big.ref_kf) == 199
    bound = big.last_bind[big.last_bind >= 0]
    assert bound.max() > 4 * len(bound)                 # scattered slots
    win = ttr.select_local_window(
        t(big.last_bind), t(big.obs_kf), t(big.obs_valid), t(big.lm_valid),
        t(big.n_kf), max_kf=FULL.max_kf)
    live_local = (big.obs_valid & (big.obs_kf >= 190)).any(-1) & big.lm_valid
    assert live_local.sum() > FULL.n_local_lm == int(win.lm_ok.sum())
    assert set(bound) <= set(n(win.lm_ids))
    with pytest.raises(ValueError):
        graft.euroc_mono_scene(*full_feats, case="sideways")
