"""Port parity: the monocular frame step (``graft.mono_frame_step``:
extraction, undistortion and ``tracking.frame_step`` with its motion model,
widened retry, local window and counters) against the JAX package's
``frame_step``, in the normal case and in the retry case, at a small cut of
the EuRoC-mono configuration.

Both sides get the same features: the port's own, from the same image, so
that the JAX side's cost in this file is the one compile of its
``frame_step`` (the JAX features' parity is held in
test_torch_motion_model.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import mono_scene, n, small_mono_config, t

from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

CFG = small_mono_config()


@pytest.fixture(scope="module")
def feats():
    """The port's features of the scene's frame (numpy: xy undistorted,
    level, desc, angle, valid)."""
    img = t(graft.example_image(CFG.height, CFG.width))
    cam = t(np.array([CFG.fx, CFG.fy, CFG.cx, CFG.cy], np.float32))
    f = graft.mono_extract(img, cam, t(np.array(CFG.dist, np.float32)), CFG)
    return tuple(n(a) for a in (f.xy, f.level, f.desc, f.angle, f.valid))


def _jax_frame_step(sc, feats):
    J = jnp.asarray
    xy, level, desc, angle, valid = feats
    nf = xy.shape[0]
    return jtr.frame_step(
        J(sc.R_pred), J(sc.t_pred), J(sc.R_last), J(sc.t_last),
        J(sc.lm_pos), J(sc.lm_desc), J(sc.lm_normal), J(sc.lm_min_d),
        J(sc.lm_max_d), J(sc.lm_valid), J(sc.last_bind), J(sc.last_desc),
        J(sc.last_angle), J(xy), J(level), J(desc.view(np.uint32)), J(valid),
        J(angle), jnp.full((nf,), -1.0, jnp.float32),
        jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32),
        J(sc.obs_kf), J(sc.obs_valid), J(sc.ref_kf),
        jnp.asarray(CFG.kf_ref_min_obs, jnp.int32), J(sc.n_kf),
        J(sc.n_found), J(sc.n_visible), J(sc.cam_params), CFG.width,
        CFG.height, max_kf=CFG.max_kf, n_local_kf=CFG.n_local_kf,
        n_local_lm=CFG.n_local_lm, recent_kf=CFG.recent_kf)


@pytest.mark.parametrize("case", ["normal", "retry"])
def test_mono_frame_step_matches_jax(feats, case):
    sc = mono_scene(feats, CFG, case)
    ref, ref_info, ref_found, ref_vis = _jax_frame_step(sc, feats)
    args = convert.tree_to_torch(sc, "cpu")
    res, info, found, vis = graft.mono_frame_step(*args, cfg=CFG)
    np.testing.assert_array_equal(n(res.bindings), n(ref.bindings))
    np.testing.assert_array_equal(n(info)[:4], n(ref_info)[:4])
    np.testing.assert_array_equal(n(found), n(ref_found))
    np.testing.assert_array_equal(n(vis), n(ref_vis))
    # Same matches; the pose differs only by the float32 solver path.
    np.testing.assert_allclose(n(res.R), n(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(res.t), n(ref.t), atol=1e-4)
    np.testing.assert_allclose(n(info)[4:], n(ref_info)[4:], atol=1e-4)
    # The scene tracks back to the identity with most features.
    assert int(res.n_inliers) >= 0.9 * feats[4].sum()
    np.testing.assert_allclose(n(res.R), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(n(res.t), 0.0, atol=1e-3)
    # The counters moved by one for each bound landmark.
    bound = n(res.bindings)[n(res.bindings) >= 0]
    assert (n(found) - sc.n_found).sum() == len(bound) > 0


def test_frame_step_reads_nothing_back(feats, monkeypatch):
    """The retry is selected on the device: frame_step never turns a tensor
    into a Python value (its one synchronisation is the caller's read of
    ``info``). On the card chip_smoke.py runs it under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    sc = convert.tree_to_torch(mono_scene(feats, CFG, "retry"), "cpu")
    a = graft.MonoFrameArgs(*sc)
    f = convert.tree_to_torch(feats, "cpu")
    nf = CFG.n_features

    def refuse(*_, **__):
        raise AssertionError("frame_step read a tensor back to the host")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res, info, _, _ = ttr.frame_step(
        a.R_pred, a.t_pred, a.R_last, a.t_last, a.lm_pos, a.lm_desc,
        a.lm_normal, a.lm_min_d, a.lm_max_d, a.lm_valid, a.last_bind,
        a.last_desc, a.last_angle, f[0], f[1], f[2], f[4], f[3],
        torch.full((nf,), -1.0), torch.zeros(()), torch.zeros(()), a.obs_kf,
        a.obs_valid, a.ref_kf, CFG.kf_ref_min_obs, a.n_kf, a.n_found,
        a.n_visible, a.cam_params, CFG.width, CFG.height,
        max_kf=CFG.max_kf, n_local_lm=CFG.n_local_lm)
    monkeypatch.undo()
    assert info.shape == (16,) and int(res.n_inliers) > 0


def test_stereo_waits_for_its_slice(feats):
    """The stereo branch of frame_step (the stereo slice has come): with no
    keypoint holding a right-image u it gives the mono step's bindings,
    inliers, counters and close-point counts (none), the pose within 1e-5
    (its final pose optimization sums three-row normal equations). The
    stereo rows themselves are held against the JAX package in
    test_torch_stereo.py and test_torch_stereo_system.py."""
    a = graft.MonoFrameArgs(*convert.tree_to_torch(
        mono_scene(feats, CFG, "normal"), "cpu"))
    xy, level, desc, angle, valid = (t(x) for x in feats)
    head = (a.R_pred, a.t_pred, a.R_last, a.t_last, a.lm_pos, a.lm_desc,
            a.lm_normal, a.lm_min_d, a.lm_max_d, a.lm_valid, a.last_bind,
            a.last_desc, a.last_angle, xy, level, desc, valid, angle,
            torch.full((xy.shape[0],), -1.0))
    tail = (a.obs_kf, a.obs_valid, a.ref_kf, CFG.kf_ref_min_obs, a.n_kf,
            a.n_found, a.n_visible, a.cam_params, CFG.width, CFG.height)
    kw = dict(max_kf=CFG.max_kf, n_local_lm=CFG.n_local_lm)
    mono = ttr.frame_step(*head, torch.zeros(()), torch.zeros(()), *tail,
                          **kw)
    st = ttr.frame_step(*head, 40.0, 5.0, *tail, use_stereo=True, **kw)
    np.testing.assert_array_equal(n(st[0].bindings), n(mono[0].bindings))
    np.testing.assert_array_equal(n(st[1])[:4], n(mono[1])[:4])
    np.testing.assert_allclose(n(st[1])[4:], n(mono[1])[4:], atol=1e-5)
    for x, y in zip(st[2:], mono[2:]):
        np.testing.assert_array_equal(n(x), n(y))
    assert int(st[0].n_inliers) > 0 and n(st[1])[2:4].sum() == 0
