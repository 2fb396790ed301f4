"""Port parity: ``models/atlas.Atlas.merge`` against the JAX package's.

Two- and three-map atlases are filled with the same numpy arrays in both
packages: the JAX test's fill (``tests/test_atlas.py:23-38``: keyframes at
x = 0.1 k, landmarks seen by keyframes 0 and 1) and random fills with every
field drawn (poses, keypoints, descriptors, normals, distance ranges,
counters, observations spread over the live keyframes with dead and empty
slots, a spanning tree). Each is merged through the same Sim3 in both
packages; every field, the counters, the spanning tree and the current
index must be equal, poses, positions, normals and ranges within 1e-5.

One difference is intended (the reference's Low fault, ROADMAP section 3):
when the capacity clip drops some of the other map's keyframes, the JAX
merge kills their observations but leaves the landmarks live with their
old ``n_obs``. The port recounts such a landmark's ``n_obs`` from its
surviving observations and kills it below 2; the expected arrays here are
the JAX output with that repair applied.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation
from torch_port_util import jax_map_state, n

from orbslam3_byzyh_tpu.models import atlas as jatlas
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.models import atlas as tatlas

N_FEAT, MAX_OBS = 64, 4
CLOSE = ("R", "t", "pos", "normal", "min_dist", "max_dist")


def random_map(rng, dims, n_kf, n_lm, tree=True):
    """A numpy map state (the JAX package's dtypes) with ``n_kf`` live
    keyframes and ``n_lm`` landmark rows, every field random, and its
    spanning tree (a random earlier parent, the root -1)."""
    max_kf, max_lm, max_obs, nf = dims
    f32 = np.float32
    R = np.tile(np.eye(3, dtype=f32), (max_kf, 1, 1))
    R[:n_kf] = Rotation.random(n_kf, random_state=rng.integers(1 << 30)
                               ).as_matrix()
    t = np.zeros((max_kf, 3), f32)
    t[:n_kf] = rng.normal(size=(n_kf, 3))
    live_kf = np.arange(max_kf) < n_kf
    obs_kf = np.where(rng.random((max_lm, max_obs)) < 0.7,
                      rng.integers(0, max(n_kf, 1), (max_lm, max_obs)), -1)
    obs_kf[n_lm:] = -1
    obs_valid = (obs_kf >= 0) & (rng.random((max_lm, max_obs)) < 0.85)
    n_obs = obs_valid.sum(-1)
    lm_live = (np.arange(max_lm) < n_lm) & (n_obs >= 1)
    normal = rng.normal(size=(max_lm, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    state = jatlas.ms.MapState(
        kfs=jatlas.ms.KeyFrames(
            R=R, t=t,
            stamp=(rng.random(max_kf) * live_kf).astype(f32),
            kp_xy=rng.uniform(0, 100, (max_kf, nf, 2)).astype(f32),
            kp_level=rng.integers(0, 8, (max_kf, nf)).astype(np.int32),
            kp_angle=rng.uniform(-3, 3, (max_kf, nf)).astype(f32),
            kp_desc=rng.integers(0, 2 ** 32, (max_kf, nf, 8),
                                 dtype=np.uint32),
            kp_valid=rng.random((max_kf, nf)) < 0.9,
            kp_ur=rng.uniform(-1, 100, (max_kf, nf)).astype(f32),
            valid=live_kf & (rng.random(max_kf) < 0.9)),
        lms=jatlas.ms.Landmarks(
            pos=rng.normal(size=(max_lm, 3)).astype(f32),
            desc=rng.integers(0, 2 ** 32, (max_lm, 8), dtype=np.uint32),
            normal=normal.astype(f32),
            min_dist=rng.uniform(0.1, 1, max_lm).astype(f32),
            max_dist=rng.uniform(2, 9, max_lm).astype(f32),
            n_obs=n_obs.astype(np.int32),
            n_found=rng.integers(0, 20, max_lm).astype(np.int32),
            n_visible=rng.integers(0, 30, max_lm).astype(np.int32),
            first_kf=np.where(np.arange(max_lm) < n_lm,
                              rng.integers(0, max(n_kf, 1), max_lm),
                              0).astype(np.int32),
            valid=lm_live),
        obs=jatlas.ms.Observations(
            kf=obs_kf.astype(np.int32),
            kp=np.where(obs_kf >= 0, rng.integers(0, nf, obs_kf.shape),
                        -1).astype(np.int32),
            valid=obs_valid))
    parent = None
    if tree:
        parent = np.full(max_kf, -1, np.int32)
        for k in range(1, n_kf):
            parent[k] = rng.integers(0, k)
    return state, jatlas.MapMeta(n_kf=n_kf, n_lm=n_lm, kf_parent=parent)


def fill_map(rng, dims, n_kf, n_lm):
    """``tests/test_atlas.py``'s fill, in numpy: keyframe k at x = 0.1 k
    with random keypoints, landmarks 0..n_lm-1 observed by keyframes 0 and
    1 at keypoint = row, no spanning tree."""
    max_kf, max_lm, max_obs, nf = dims
    state, _ = random_map(rng, dims, 0, 0, tree=False)
    kfs, lms, obs = state
    live = np.arange(max_kf) < n_kf
    R = np.tile(np.eye(3, dtype=np.float32), (max_kf, 1, 1))
    t = np.zeros((max_kf, 3), np.float32)
    t[:n_kf, 0] = 0.1 * np.arange(n_kf)
    rows = np.arange(max_lm) < n_lm
    okf = np.full((max_lm, max_obs), -1, np.int32)
    okf[rows, 0], okf[rows, 1] = 0, 1
    okp = np.full((max_lm, max_obs), -1, np.int32)
    okp[rows, 0] = okp[rows, 1] = np.arange(n_lm)
    state = jatlas.ms.MapState(
        kfs=kfs._replace(R=R, t=t, valid=live,
                         stamp=np.where(live, np.arange(max_kf),
                                        0).astype(np.float32),
                         kp_level=np.zeros_like(kfs.kp_level),
                         kp_valid=np.repeat(live[:, None], nf, 1)),
        lms=lms._replace(n_obs=np.where(rows, 2, 0).astype(np.int32),
                         first_kf=np.zeros(max_lm, np.int32),
                         n_found=rows.astype(np.int32),
                         n_visible=rows.astype(np.int32), valid=rows),
        obs=obs._replace(kf=okf, kp=okp, valid=okf >= 0))
    return state, jatlas.MapMeta(n_kf=n_kf, n_lm=n_lm)


def both_atlases(dims, maps, current):
    """The same maps in a JAX and a port atlas."""
    ja = jatlas.Atlas(*dims)
    ta = tatlas.Atlas(*dims, device="cpu")
    ja.maps = [jax_map_state(s) for s, _ in maps]
    ta.maps = [convert.map_state_to_torch(s, "cpu") for s, _ in maps]
    ja.meta = [jatlas.MapMeta(m.n_kf, m.n_lm, m.kf_parent) for _, m in maps]
    ta.meta = [tatlas.MapMeta(m.n_kf, m.n_lm, m.kf_parent) for _, m in maps]
    ja.current = ta.current = current
    return ja, ta


def low_repair(want, other, lm_off, lm_take, kf_take):
    """The JAX merge's landmark arrays with the port's repair: a
    transplanted landmark that lost an observation to the capacity clip
    gets ``n_obs`` recounted from its surviving observations and dies
    below 2. Returns (n_obs, valid) and the rows it changed."""
    okf = np.asarray(other.obs.kf)[:lm_take]
    oval = np.asarray(other.obs.valid)[:lm_take]
    kept = (okf >= 0) & (okf < kf_take)
    lost = (oval & ~kept).any(-1)
    recount = (oval & kept).sum(-1)
    n_obs = np.asarray(want.lms.n_obs).copy()
    valid = np.asarray(want.lms.valid).copy()
    sl = slice(lm_off, lm_off + lm_take)
    n_obs[sl] = np.where(lost, recount, n_obs[sl])
    valid[sl] &= ~(lost & (recount < 2))
    return n_obs, valid, lm_off + np.flatnonzero(lost)


def sim3(rng):
    R = Rotation.random(random_state=rng.integers(1 << 30)).as_matrix()
    return (R.astype(np.float32), rng.normal(size=3).astype(np.float32),
            float(rng.uniform(0.5, 2.0)))


def merge_and_compare(dims, maps, current, other, R_m, t_m, s_m):
    ja, ta = both_atlases(dims, maps, current)
    oth = ja.maps[other]
    mc, mo = ja.meta[current], ja.meta[other]
    kf_take = min(mo.n_kf, dims[0] - mc.n_kf)
    lm_take = min(mo.n_lm, dims[1] - mc.n_lm)
    lm_off = mc.n_lm
    got_idx = ta.merge(other, R_m, t_m, s_m)
    want_idx = ja.merge(other, R_m, t_m, s_m)
    assert got_idx == want_idx == ta.current == ja.current
    assert len(ta.maps) == len(ja.maps) == len(maps) - 1
    for i, (wm, gm) in enumerate(zip(ja.meta, ta.meta)):
        assert (gm.n_kf, gm.n_lm) == (wm.n_kf, wm.n_lm), i
        if wm.kf_parent is None:
            assert gm.kf_parent is None, i
        else:
            np.testing.assert_array_equal(gm.kf_parent, wm.kf_parent)
    want = ja.maps[want_idx]
    n_obs, valid, changed = low_repair(want, oth, lm_off, lm_take, kf_take)
    for i, (ws, gs) in enumerate(zip(ja.maps, ta.maps)):
        g = convert.map_state_to_numpy(gs)
        for group in ("kfs", "lms", "obs"):
            for name in getattr(ws, group)._fields:
                x = np.asarray(getattr(getattr(ws, group), name))
                y = getattr(getattr(g, group), name)
                if i == want_idx and group == "lms" and name == "n_obs":
                    x = n_obs
                elif i == want_idx and group == "lms" and name == "valid":
                    x = valid
                what = f"map {i} {group}.{name}"
                assert y.dtype == x.dtype and y.shape == x.shape, what
                if name in CLOSE:
                    np.testing.assert_allclose(y, x, atol=1e-5, rtol=1e-5,
                                               err_msg=what)
                else:
                    np.testing.assert_array_equal(y, x, err_msg=what)
    return ja, ta, changed, (kf_take, lm_take)


def test_merge_test_atlas_fill(rng):
    """``tests/test_atlas.py::test_merge_welds_geometry``: map 1 (2
    keyframes, 10 landmarks) welded into map 0 (3, 20) through a Sim3 of
    scale 2; the welded positions are the transform of the old ones and
    ``obs.kf`` is shifted."""
    dims = (16, 256, MAX_OBS, N_FEAT)
    maps = [fill_map(rng, dims, 3, 20), fill_map(rng, dims, 2, 10)]
    R_m = Rotation.from_rotvec([1.0, 0.5, -0.2]).as_matrix().astype(
        np.float32)
    t_m = np.array([0.3, -0.1, 0.2], np.float32)
    before = maps[1][0].lms.pos[:10].copy()
    _, ta, changed, _ = merge_and_compare(dims, maps, 0, 1, R_m, t_m, 2.0)
    assert len(changed) == 0
    assert (ta.meta[0].n_kf, ta.meta[0].n_lm) == (5, 30)
    np.testing.assert_allclose(n(ta.state.lms.pos[20:30]),
                               2.0 * before @ R_m.T + t_m, atol=1e-5)
    assert int(ta.state.obs.kf[20, 0]) == 3


@pytest.mark.parametrize("seed,current,other", [(0, 0, 1), (1, 1, 0),
                                                (2, 2, 0), (3, 0, 2)])
def test_merge_random_fills(seed, current, other):
    """Three random maps, the merged-away one before or after the current
    one (the current index re-indexed past the deletion), no clip."""
    rng = np.random.default_rng(seed)
    dims = (32, 512, MAX_OBS, N_FEAT)
    maps = [random_map(rng, dims, 7, 90), random_map(rng, dims, 9, 120),
            random_map(rng, dims, 5, 60, tree=False)]
    _, ta, changed, take = merge_and_compare(dims, maps, current, other,
                                             *sim3(rng))
    assert len(changed) == 0 and take == (maps[other][1].n_kf,
                                          maps[other][1].n_lm)


@pytest.mark.parametrize("seed", [4, 5])
def test_merge_capacity_clip(seed):
    """The clip drops the other map's last keyframes and landmarks: their
    ids become -1, their observations die, children of a dropped parent
    become roots, and the landmarks that lost observations are recounted
    (the one intended difference)."""
    rng = np.random.default_rng(seed)
    dims = (12, 300, MAX_OBS, N_FEAT)
    maps = [random_map(rng, dims, 8, 200), random_map(rng, dims, 10, 150)]
    ja, ta, changed, (kf_take, lm_take) = merge_and_compare(
        dims, maps, 0, 1, *sim3(rng))
    assert (kf_take, lm_take) == (4, 100)
    assert len(changed) > 10
    lms = convert.map_state_to_numpy(ta.state)
    rows = slice(200, 300)
    okf = lms.obs.kf[rows]
    assert ((okf == -1) | ((okf >= 8) & (okf < 12))).all()
    assert (lms.lms.first_kf[rows] < 12).all()
    # After the repair no transplanted landmark is live with fewer than 2
    # live observations where the clip took one (the JAX merge leaves
    # some).
    live_obs = (lms.obs.valid & (lms.obs.kf >= 0)).sum(-1)
    assert (lms.lms.n_obs[changed] == live_obs[changed]).all()
    assert not (lms.lms.valid[changed] & (live_obs[changed] < 2)).any()
    want = ja.maps[ja.current]
    jv, jo = np.asarray(want.lms.valid), np.asarray(want.obs.valid)
    jkf = np.asarray(want.obs.kf)
    assert (jv[changed] & ((jo & (jkf >= 0)).sum(-1)[changed] < 2)).any()


def test_merge_into_empty_current(rng):
    """A loaded map welded into a fresh (empty) active map: offsets 0,
    the spanning tree allocated from the other map's."""
    dims = (16, 256, MAX_OBS, N_FEAT)
    empty = random_map(rng, dims, 0, 0, tree=False)
    maps = [random_map(rng, dims, 6, 100), empty]
    merge_and_compare(dims, maps, 1, 0, *sim3(rng))
