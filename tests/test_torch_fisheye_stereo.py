"""Port parity: the non-rectified ("fisheye") stereo match
(``ops/stereo.fisheye_stereo_match``) against the JAX package's, both fed
the port's features.

Cases: the fisheye fixture's first pair (the right camera yawed 3 degrees),
test_stereo.py's rotated rig (``SynthWorld(seed=7)``, yawed 4 degrees), the
stereo-inertial fixture's first pair seen through TUM-VI's Kannala-Brandt
pair at 512x512 (the keypoints rectified at extraction, as phase 14 (a)
runs it), and the zero-baseline rig that the parallax gate must empty.

Tolerance: ``valid`` and ``match_j`` equal, except rows whose decision
flips on a float gate (parallax cos against 0.9998, the depth signs, the
reprojection chi2 against 5.991 sigma^2) within 1e-4 of its threshold,
relative, in float64 from the triangulated point, and the rows that share
such a row's right keypoint (the mutual filter); the depths of the rows
valid in both within 1e-4 relative. Each flip is printed with its margin.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch
from synth_world import SynthWorld
from torch_port_util import n

from orbslam3_byzyh_tpu.ops import stereo as jst
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo
from orbslam3_byzyh_tpu_torch.ops import stereo as tst

FLIP_MARGIN = 1e-4


def _jax(f):
    return [jnp.asarray(convert.desc_to_uint32(a)) if k == "desc"
            else jnp.asarray(n(a)) for k, a in
            zip(("xy", "level", "desc", "valid"),
                (f.xy, f.level, f.desc, f.valid))]


def _yaw(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


def _margins(fl, fr, bj, cam_l, cam_r, R_rl, t_rl):
    """Per row, in float64 from a float64 DLT of the matched keypoints: the
    smallest relative distance of a float gate to its threshold."""
    f = lambda a: np.asarray(n(a), np.float64)
    xl, xr = f(fl.xy), f(fr.xy)[np.clip(n(bj), 0, None)]
    cl, cr, R, tt = f(cam_l), f(cam_r), f(R_rl), f(t_rl)
    r1 = np.stack([(xl[:, 0] - cl[2]) / cl[0], (xl[:, 1] - cl[3]) / cl[1],
                   np.ones(len(xl))], -1)
    r2 = np.stack([(xr[:, 0] - cr[2]) / cr[0], (xr[:, 1] - cr[3]) / cr[1],
                   np.ones(len(xr))], -1)
    r2l = r2 @ R
    cos = (r1 * r2l).sum(-1) / (np.linalg.norm(r1, axis=-1)
                                * np.linalg.norm(r2l, axis=-1))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, tt[:, None]])
    A = np.stack([r1[:, 0, None] * P1[2] - P1[0], r1[:, 1, None] * P1[2]
                  - P1[1], r2[:, 0, None] * P2[2] - P2[0],
                  r2[:, 1, None] * P2[2] - P2[1]], 1)
    Xh = np.linalg.svd(A)[2][:, 3]
    X = Xh[:, :3] / Xh[:, 3:]
    X2 = X @ R.T + tt
    lv_l = n(fl.level).astype(np.float64)
    lv_r = n(fr.level)[np.clip(n(bj), 0, None)].astype(np.float64)
    out = [np.abs(cos - 0.9998) / 0.9998,
           np.abs(X[:, 2]) / np.linalg.norm(X, axis=-1),
           np.abs(X2[:, 2]) / np.linalg.norm(X2, axis=-1)]
    for Xc, xo, c, lv in ((X, xl, cl, lv_l), (X2, xr, cr, lv_r)):
        uv = np.stack([c[0] * Xc[:, 0] / Xc[:, 2] + c[2],
                       c[1] * Xc[:, 1] / Xc[:, 2] + c[3]], -1)
        th = 5.991 * 1.2 ** (2 * lv)
        out.append(np.abs(((uv - xo) ** 2).sum(-1) - th) / th)
    return np.min(out, axis=0)


def _check(fl, fr, cam_l, cam_r, R_rl, t_rl, min_valid):
    args = (fl.xy, fl.level, fl.desc, fl.valid, fr.xy, fr.level, fr.desc,
            fr.valid)
    tens = [torch.as_tensor(np.asarray(a, np.float32))
            for a in (cam_l, cam_r, R_rl, t_rl)]
    got = tst.fisheye_stereo_match(*args, *tens)
    ref = jst.fisheye_stereo_match(*_jax(fl), *_jax(fr),
                                   *(jnp.asarray(np.asarray(a, np.float32))
                                     for a in (cam_l, cam_r, R_rl, t_rl)))
    ok, ok_j = n(got.valid), np.asarray(ref.valid)
    mj, mj_j = n(got.match_j), np.asarray(ref.match_j)
    diff = np.flatnonzero((ok != ok_j) | (mj != mj_j))
    if len(diff):
        from orbslam3_byzyh_tpu_torch.ops import cuda_match
        bj = cuda_match.hamming_best2(fl.desc, fr.desc, fl.valid,
                                      fr.valid)[2]
        margin = _margins(fl, fr, bj, cam_l, cam_r, R_rl, t_rl)
        near = margin < FLIP_MARGIN
        for i in diff:
            print(f"row {i}: port {ok[i]} {mj[i]}, JAX {ok_j[i]} {mj_j[i]}, "
                  f"gate margin {margin[i]:.2e}")
        # A row decided within the margin, or one that shares its right
        # keypoint with such a row (the mutual filter follows it).
        shared = np.isin(n(bj), n(bj)[near])
        assert np.all(near[diff] | shared[diff]), diff
    assert len(diff) <= 0.02 * max(ok_j.sum(), 1)
    both = ok & ok_j
    assert both.sum() >= min_valid, both.sum()
    np.testing.assert_allclose(n(got.depth)[both],
                               np.asarray(ref.depth)[both], rtol=1e-4)
    np.testing.assert_array_equal(n(got.depth)[~ok], -1.0)
    np.testing.assert_array_equal(mj[~ok], -1)
    return got


def test_fixture_pair_matches_jax():
    g = graft.fisheye_frames()
    cam = g.camera[:4]
    fl = tfo.extract(torch.from_numpy(g.left[0]).float(), n_features=1024)
    fr = tfo.extract(torch.from_numpy(g.right[0]).float(), n_features=1024)
    _check(fl, fr, cam, cam, g.R_rl, g.t_rl, min_valid=40)


def test_rotated_rig_matches_jax_and_recovers_depth():
    """test_stereo.py's TestFisheyeStereoMatch case: the right camera 0.2 m
    along x and yawed 4 degrees; the port's depths against the nearest true
    point's (median relative error under 8 %, test_stereo.py:136-138)."""
    world = SynthWorld(seed=7)
    R, tt = world.pose(0.0)
    img_l = world.render(0.0)
    R_d = _yaw(4.0)
    t_r0 = tt - np.array([0.2, 0, 0], np.float32)
    R_r, t_r = (R_d @ R).astype(np.float32), (R_d @ t_r0).astype(np.float32)
    world_r = copy.copy(world)
    world_r.pose = lambda _t: (R_r, t_r)
    img_r = world_r.render(0.0)
    fl = tfo.extract(torch.from_numpy(img_l).float(), n_features=1024)
    fr = tfo.extract(torch.from_numpy(img_r).float(), n_features=1024)
    cam = np.array([world.fx, world.fy, world.cx, world.cy], np.float32)
    got = _check(fl, fr, cam, cam, R_d, (t_r - R_d @ tt).astype(np.float32),
                 min_valid=60)
    pc = world.pts @ R.T + tt
    uv = np.stack([world.fx * pc[:, 0] / pc[:, 2] + world.cx,
                   world.fy * pc[:, 1] / pc[:, 2] + world.cy], -1)
    errs = []
    for i in np.flatnonzero(n(got.valid)):
        j = np.linalg.norm(uv - n(fl.xy)[i], axis=-1).argmin()
        if np.linalg.norm(uv[j] - n(fl.xy)[i]) <= 6:
            errs.append(abs(n(got.depth)[i] - pc[j, 2]) / pc[j, 2])
    assert len(errs) > 15
    assert np.median(errs) < 0.08, np.median(errs)


def test_tumvi_kb8_pair_matches_jax():
    """Phase 14 (a)'s input at 1000 features: the keypoints rectified
    through each camera's Kannala-Brandt model, then the match."""
    g = graft.vi_stereo_frames()
    left, right = graft.tumvi_kb8_pair(g.left[0], g.right[0])
    setup = graft.tumvi_vi_golden_config()
    rig = graft.fisheye_rig_config(setup.config)
    fl, fr, m = graft.fisheye_stereo_extract(
        torch.from_numpy(left).float(), torch.from_numpy(right).float(), rig)
    got = _check(fl, fr, graft.TUMVI_WORLD_CAM, graft.TUMVI_WORLD_CAM,
                 rig.R_rl, rig.t_rl, min_valid=60)
    for a, b in zip(got, m):
        assert torch.equal(a, b)


def test_zero_baseline_parallax_gate():
    """With no baseline every ray pair is parallel: the parallax gate
    leaves under 5 % (test_stereo.py's case), in both packages alike."""
    img = SynthWorld(seed=8).render(0.0)
    f = tfo.extract(torch.from_numpy(img).float(), n_features=512)
    cam = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    got = _check(f, f, cam, cam, np.eye(3), np.zeros(3), min_valid=0)
    assert n(got.valid).mean() < 0.05
