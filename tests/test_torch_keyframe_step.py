"""Port parity: the monocular keyframe step (``graft.mono_keyframe_step``,
``mapping.keyframe_bundle`` with triangulation against 3 neighbours,
duplicate fusion, the windowed local BA and culling) against the JAX
package's ``keyframe_bundle``, on a small cut of the EuRoC-mono map
(``graft.euroc_mono_map``) in its normal and its full case.

Discrete outputs are compared exactly: the bindings, the culled keyframes,
the new landmarks' slots, ``info[:3]`` and every integer and bool array of
the map; poses within 1e-4, live landmark positions within 1e-3 (or their
reprojections within 0.01 px, see ``torch_port_util.assert_states_close``).
Two differences are allowed, and each is stated where it is checked:

  * the port's capacity valve also clears the observation rows of the
    landmarks it retires (the JAX package leaves them live, a fault the port
    repairs): on those rows the JAX state keeps live observations and their
    count;
  * a triangulation whose gate value lies within float32 rounding of its
    threshold may go the other way. The test replays the triangulation of
    both packages side by side, prints every such row with its margin and
    requires the margin below 1e-5; the outcome must then agree within 1 %.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (assert_states_close, jax_feats, jax_map_state,
                             n, plant_ur, small_map, small_map_config,
                             triangulation_margins)

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap

CFG = small_map_config()
CASES = ("normal", "full")
FLIP_MARGIN = 1e-5
BF = 40.0


def _jax_bundle(m):
    nf = CFG.n_features
    return jmap.keyframe_bundle(
        jax_map_state(m.state), m.kf_id, jnp.asarray(m.R), jnp.asarray(m.t),
        m.stamp, jax_feats(m.feats), jnp.full((nf,), -1.0, jnp.float32),
        jnp.asarray(m.bindings), jnp.asarray(m.cam_params), m.n_lm_hwm,
        float(CFG.width), float(CFG.height),
        n_neighbors=CFG.triangulation_neighbors,
        n_free=CFG.local_window + 1, n_window=CFG.ba_window,
        n_lm_window=CFG.ba_lm_window, do_kf_cull=True, do_local_ba=True)


@pytest.fixture(scope="module")
def maps():
    return {case: small_map(case) for case in CASES}


@pytest.fixture(scope="module")
def jax_out(maps):
    """The JAX package's bundle on each case (one compile for both)."""
    out = {}
    for case, m in maps.items():
        st, b, info, culled = _jax_bundle(m)
        out[case] = (jms.MapState(*(type(g)(*(np.asarray(a) for a in g))
                                    for g in st)),
                     np.asarray(b), np.asarray(info), np.asarray(culled))
    return out


def _valve_killed(m):
    """Rows the capacity valve retires in the bundle (the same in both
    packages: held in test_torch_mapping.py)."""
    s = jax_map_state(m.state)
    s = jms.add_keyframe(s, m.kf_id, jnp.asarray(m.R), jnp.asarray(m.t),
                         m.stamp, jax_feats(m.feats))
    b = jnp.asarray(m.bindings)
    s = jms.add_observations(s, jnp.maximum(b, 0), m.kf_id,
                             jnp.arange(b.shape[0], dtype=jnp.int32), b >= 0)
    after = jmap.landmark_overflow_valve(s, CFG.n_features)
    return np.asarray(s.lms.valid & ~after.lms.valid)


def _triangulation_flips(m):
    """Replay the bundle's insert, valve and triangulation in both packages
    side by side; return (neighbour, row, margin) for every row whose
    ``good`` differs on the same input. Each package goes on with its own
    result."""
    kf, nf = m.kf_id, CFG.n_features
    cam = jnp.asarray(m.cam_params)
    a = graft.mono_map_args(m, "cpu")
    js = jax_map_state(m.state)
    js = jms.add_keyframe(js, kf, jnp.asarray(m.R), jnp.asarray(m.t),
                          m.stamp, jax_feats(m.feats))
    jb = jnp.asarray(m.bindings)
    js = jms.add_observations(js, jnp.maximum(jb, 0), kf,
                              jnp.arange(nf, dtype=jnp.int32), jb >= 0)
    ts = tms.add_keyframe(a[0], kf, a[2], a[3], a[4], a[5])
    tb = a[6]
    ts = tms.add_observations(ts, tb.clamp_min(0), kf,
                              torch.arange(nf, dtype=torch.int32), tb >= 0)
    counts = jms.covisibility_counts(js, kf, CFG.max_kf)
    counts = jnp.where(js.kfs.valid, counts, 0).at[kf].set(0)
    order = np.argsort(-np.asarray(counts), kind="stable")[:3]
    js = jmap.landmark_overflow_valve(js, nf)
    ts = tmap.landmark_overflow_valve(ts, nf)
    f = jax_feats(m.feats)
    flips = []
    for nb in order:
        nb = int(nb)
        ok_nb = bool(counts[nb] >= 15)
        jr = jmap.triangulate_pair(
            js.kfs.R[kf], js.kfs.t[kf], f.xy, f.level, f.desc,
            f.valid & (jb < 0) & ok_nb, js.kfs.R[nb], js.kfs.t[nb],
            js.kfs.kp_xy[nb], js.kfs.kp_level[nb], js.kfs.kp_desc[nb],
            js.kfs.kp_valid[nb] & ok_nb, cam)
        tr = tmap.triangulate_pair(
            ts.kfs.R[kf], ts.kfs.t[kf], a[5].xy, a[5].level, a[5].desc,
            a[5].valid & (tb < 0) & ok_nb, ts.kfs.R[nb], ts.kfs.t[nb],
            ts.kfs.kp_xy[nb], ts.kfs.kp_level[nb], ts.kfs.kp_desc[nb],
            ts.kfs.kp_valid[nb] & ok_nb, a[7])
        # Rows free in one package only follow from an earlier flip.
        same_input = np.asarray(jb < 0) == n(tb < 0)
        diff = np.flatnonzero((np.asarray(jr.good) != n(tr.good))
                              & same_input)
        if len(diff):
            kb = n(tr.kp_b)
            marg = triangulation_margins(
                n(tr.pos), n(ts.kfs.R[kf]), n(ts.kfs.t[kf]), n(ts.kfs.R[nb]),
                n(ts.kfs.t[nb]), n(a[5].xy), n(ts.kfs.kp_xy[nb])[kb],
                n(a[5].level), n(ts.kfs.kp_level[nb])[kb], m.cam_params)
            flips += [(nb, int(i), float(marg[i])) for i in diff]
        sl, ok = jmap._alloc_landmark_slots(js.lms.valid, jr.good)
        js = jms.add_landmarks(js, sl, jr.pos, jr.desc, kf, jr.kp_a, nb,
                               jr.kp_b, ok, jr.normal, jr.min_dist,
                               jr.max_dist)
        jb = jb.at[jnp.where(ok, jr.kp_a, nf)].set(jnp.where(ok, sl, -1),
                                                   mode="drop")
        sl2, ok2 = tmap._alloc_landmark_slots(ts.lms.valid, tr.good)
        ts = tms.add_landmarks(ts, sl2, tr.pos, tr.desc, kf, tr.kp_a,
                               nb, tr.kp_b, ok2, tr.normal, tr.min_dist,
                               tr.max_dist)
        tb = tms.scatter_rows(tb, torch.where(ok2, tr.kp_a, nf),
                              torch.where(ok2, sl2, -1))
    return flips


def _new_slots(state, kf_id):
    lms = state.lms
    return np.flatnonzero((np.asarray(lms.first_kf) == kf_id)
                          & np.asarray(lms.valid))


@pytest.mark.parametrize("case", CASES)
def test_keyframe_step_matches_jax(maps, jax_out, case):
    m = maps[case]
    ref, ref_b, ref_info, ref_culled = jax_out[case]
    st, b, info, culled = graft.mono_keyframe_step(
        *graft.mono_map_args(m, "cpu"), cfg=CFG)
    got = convert.map_state_to_numpy(st)
    b, info, culled = n(b), n(info), n(culled)

    # The scene's stages fired in the reference.
    killed = _valve_killed(m)
    assert killed.any() == (case == "full")
    assert ref_culled[m.cull_kf] and ref_culled.sum() == 1
    assert len(_new_slots(ref, m.kf_id)) >= 50

    flips = _triangulation_flips(m)
    for nb, row, margin in flips:
        print(f"{case}: triangulation against keyframe {nb}, row {row}: "
              f"decision differs, gate margin {margin:.3e}")
        assert margin < FLIP_MARGIN, (nb, row, margin)
    np.testing.assert_array_equal(culled, ref_culled)
    np.testing.assert_array_equal(info[:2], ref_info[:2])
    np.testing.assert_allclose(info[3:], ref_info[3:], atol=1e-4)
    if flips:
        # The outcome within 1 %: one flipped row shifts the later slots.
        n_ref, n_got = len(_new_slots(ref, m.kf_id)), len(_new_slots(got, m.kf_id))
        assert abs(n_got - n_ref) <= max(1, 0.01 * n_ref), (n_got, n_ref)
        nb_ref, nb_got = (ref_b >= 0).sum(), (b >= 0).sum()
        assert abs(nb_got - nb_ref) <= max(1, 0.01 * nb_ref), (nb_got, nb_ref)
        return

    np.testing.assert_array_equal(b, ref_b)
    np.testing.assert_array_equal(info[:3], ref_info[:3])
    np.testing.assert_array_equal(_new_slots(got, m.kf_id),
                                  _new_slots(ref, m.kf_id))
    # The repaired valve: on the rows it retired (and triangulation did not
    # recycle) the JAX package keeps live observations and counts them.
    stale = killed & (ref.lms.first_kf != m.kf_id)
    if case == "full":
        assert ref.obs.valid[stale].any()
        assert not got.obs.valid[stale].any() and (got.lms.n_obs[stale] == 0).all()
    fixed = ref._replace(
        obs=ref.obs._replace(valid=ref.obs.valid & ~stale[:, None]),
        lms=ref.lms._replace(n_obs=np.where(stale, 0, ref.lms.n_obs)))
    assert_states_close(fixed, got, m.cam_params)


def test_keyframe_step_does_its_work(maps, jax_out):
    """Every planted stage fires at the small size, in the port."""
    for case in CASES:
        m = maps[case]
        a = graft.mono_map_args(m, "cpu")
        st, b, info, culled = graft.mono_keyframe_step(*a, cfg=CFG)
        assert tms.check_invariants(st, m.kf_id + 1, CFG.max_lm) == []
        assert n(culled)[m.cull_kf] and int(culled.sum()) == 1
        assert len(_new_slots(st, m.kf_id)) >= 50
        assert int((b >= 0).sum()) > int((a[6] >= 0).sum())
        err0 = np.abs(m.R - m.R_true).max()
        err1 = np.abs(n(st.kfs.R[m.kf_id]) - m.R_true).max()
        assert err1 < err0, (err0, err1)
        # The caller's map is not written.
        np.testing.assert_array_equal(n(a[0].lms.valid), m.state.lms.valid)
        np.testing.assert_array_equal(n(a[0].kfs.R), m.state.kfs.R)


def test_cpu_keyframe_step_launches_no_kernel(maps):
    """On CPU tensors K2's four calls take its plain version."""
    from orbslam3_byzyh_tpu_torch.ops import cuda_match

    cuda_match.KERNEL.launches = 0
    graft.mono_keyframe_step(*graft.mono_map_args(maps["normal"], "cpu"),
                             cfg=CFG)
    assert cuda_match.KERNEL.launches == 0


def test_keyframe_step_reads_nothing_back(maps, monkeypatch):
    """No tensor becomes a Python value inside the bundle: the JAX package's
    caller reads ``info`` lazily, and so can the port's (on the card the one
    synchronisation left is inside ``torch.linalg.svd``)."""
    a = graft.mono_map_args(maps["full"], "cpu")

    def refuse(*_, **__):
        raise AssertionError("keyframe_bundle read a tensor back to the host")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    _, _, info, _ = graft.mono_keyframe_step(*a, cfg=CFG)
    monkeypatch.undo()
    assert info.shape == (15,) and np.isfinite(n(info)).all()


def test_stereo_bundle_waits_for_its_slice(maps):
    """The stereo bundle (the stereo slice has come) against the JAX
    package's, on the normal case with ``kp_ur`` planted and the new
    keyframe's ``ur`` from its bound landmarks' depths: bindings, culled
    keyframes and ``info[:3]`` exact, the map within tolerance. The valve's
    margin is two frames' worth (512 slots); the map keeps 1459 free, so it
    retires nothing."""
    rng = np.random.default_rng(6)
    m = maps["normal"]
    st = plant_ur(m.state, rng, BF)
    b = m.bindings
    z = (m.state.lms.pos[np.maximum(b, 0)] @ m.R.T + m.t)[:, 2]
    ur = np.where((b >= 0) & (rng.random(len(b)) < 0.6),
                  m.feats.xy[:, 0] - BF / z, -1.0).astype(np.float32)
    kw = dict(use_stereo=True, bf=BF, n_neighbors=CFG.triangulation_neighbors,
              n_free=CFG.local_window + 1, n_window=CFG.ba_window,
              n_lm_window=CFG.ba_lm_window, do_kf_cull=True,
              do_local_ba=True)
    js, jb, jinfo, jculled = jmap.keyframe_bundle(
        jax_map_state(st), m.kf_id, jnp.asarray(m.R), jnp.asarray(m.t),
        m.stamp, jax_feats(m.feats), jnp.asarray(ur), jnp.asarray(b),
        jnp.asarray(m.cam_params), m.n_lm_hwm, float(CFG.width),
        float(CFG.height), **kw)
    a = graft.mono_map_args(m._replace(state=st), "cpu")
    ts, tb, tinfo, tculled = tmap.keyframe_bundle(
        *a[:6], torch.from_numpy(ur), *a[6:], float(CFG.width),
        float(CFG.height), **kw)
    np.testing.assert_array_equal(n(tb), np.asarray(jb))
    np.testing.assert_array_equal(n(tinfo)[:3], np.asarray(jinfo)[:3])
    np.testing.assert_array_equal(n(tculled), np.asarray(jculled))
    ref = jms.MapState(*(type(g)(*(np.asarray(x) for x in g)) for g in js))
    np.testing.assert_array_equal(ref.kfs.kp_ur[m.kf_id], ur)
    assert_states_close(ref, convert.map_state_to_numpy(ts), m.cam_params)
