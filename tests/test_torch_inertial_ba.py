"""Port parity: the joint visual-inertial BA (``solver/inertial_ba.py``) and
the VI-BA window's device gather and write-back
(``pipeline/inertial_system._gather_viba_visual`` / ``_scatter_viba``)
against the JAX package.

The BA runs tests/test_inertial_ba.py's 6-keyframe, 200-landmark problem
(mono, and with stereo rows on half the observations). Tolerances: poses,
velocities and biases within 2e-5, points within 2e-4 m (the last LM steps
of a float32 Schur solve), the same inlier gating, the cost within 1e-4
relative. The gather and write-back are exact (the same indices; values
copied): on a planted map where more landmarks qualify than there are
slots, so the slots go to the lowest landmark ids, as ``lax.top_k`` picks
them. One intended difference in the write-back: a landmark that lost an
observation to the gate is recounted and dies below 2 live observations
(the JAX write-back leaves it live, possibly with none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inertial_ba import CAM, make_vi_problem
from torch_port_util import jax_map_state, n, small_map, t

from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
from orbslam3_byzyh_tpu.solver import inertial_ba as jba
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
from orbslam3_byzyh_tpu_torch.solver import inertial_ba as tba


def _problem(stereo: bool):
    """test_inertial_ba's refine case: keyframes 2-5 perturbed, 0-1
    fixed."""
    rng = np.random.default_rng(42)
    n_kf = 6
    Rs, ps, vs, preints, X, d = make_vi_problem(rng, n_kf=n_kf)
    Rp, pp, vp = Rs.copy(), ps.copy(), vs.copy()
    for k in range(2, n_kf):
        dR = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.uniform(-0.02, 0.02, 3).astype(np.float32))))
        Rp[k] = Rs[k] @ dR
        pp[k] = ps[k] + rng.uniform(-0.05, 0.05, 3)
        vp[k] = vs[k] + rng.uniform(-0.2, 0.2, 3)
    Xp = X + rng.uniform(-0.05, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    f = np.float32
    kw = dict(
        R_wb=Rp.astype(f), p_w=pp.astype(f), v_w=vp.astype(f),
        bg=np.zeros((n_kf, 3), f), ba=np.zeros((n_kf, 3), f), points=Xp,
        obs_kf=d["obs_kf"], obs_uv=d["obs_uv"],
        obs_w=np.ones(d["obs_kf"].shape, f), obs_valid=d["obs_valid"],
        lm_valid=np.ones(len(X), bool), edges_i=d["edges_i"],
        edges_j=d["edges_j"], edge_valid=np.ones(n_kf - 1, bool),
        walk_info=np.full((6,), 1e4, f), R_cb=d["R_cb"], t_cb=d["t_cb"],
        cam_params=CAM, fixed=fixed,
        prior_bias_w=np.array([1e2, 1e4], f))
    if stereo:
        # u_r of the true point (noise 0.5 px) on every other observation.
        bf = 80.0
        kf = np.maximum(d["obs_kf"], 0)
        xb = np.einsum("loji,loj->loi", Rs[kf], X[:, None, :] - ps[kf])
        ur = d["obs_uv"][..., 0] - bf / xb[..., 2] + rng.normal(
            0, 0.5, kf.shape)
        keep = d["obs_valid"] & (np.arange(kf.shape[1])[None, :] % 2 == 0)
        kw.update(obs_ur=np.where(keep, ur, -1.0).astype(f),
                  bf=np.float32(bf))
    return kw, preints, Rs, ps, vs


@pytest.mark.parametrize("stereo", [False, True])
def test_vi_bundle_adjust(stereo):
    kw, preints, Rs, ps, vs = _problem(stereo)
    ref = jba.vi_bundle_adjust(jba.VIBAProblem(
        preints=preints, **{k: jnp.asarray(v) for k, v in kw.items()}))
    p = convert.viba_problem_to_torch(jba.VIBAProblem(preints=preints, **kw),
                                      "cpu")
    back = convert.viba_problem_to_numpy(p)        # both ways, unchanged
    for k, v in kw.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for a, b in zip(back["preints"], preints):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (back["obs_ur"] is None) == (not stereo)
    out = tba.vi_bundle_adjust(p)
    for f in ("R_wb", "p_w", "v_w", "bg", "ba"):
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=2e-5, err_msg=f)
    np.testing.assert_allclose(n(out.points), n(ref.points), atol=2e-4)
    np.testing.assert_array_equal(n(out.obs_inlier), n(ref.obs_inlier))
    assert abs(float(out.cost) - float(ref.cost)) <= 1e-4 * float(ref.cost)
    # test_inertial_ba's gates on the port's result.
    for k in range(2, 6):
        dR = n(out.R_wb[k]).T @ Rs[k]
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.3, (k, ang)
        assert np.linalg.norm(n(out.p_w[k]) - ps[k]) < 0.03, k
        assert np.linalg.norm(n(out.v_w[k]) - vs[k]) < 0.1, k


def test_problem_cost_falls():
    """The objective at the solved states is below the starting one."""
    kw, preints, *_ = _problem(stereo=True)
    p = convert.viba_problem_to_torch(jba.VIBAProblem(preints=preints, **kw),
                                      "cpu")
    res = tba.vi_bundle_adjust(p)
    solved = p._replace(R_wb=res.R_wb, p_w=res.p_w, v_w=res.v_w, bg=res.bg,
                        ba=res.ba, points=res.points)
    assert float(tba.problem_cost(solved)) < 0.1 * float(tba.problem_cost(p))


L_SLOTS = 128


def _window(m):
    """A 12-keyframe window ending at the newest live keyframe, the last
    5 free; the free keyframes see far more than L_SLOTS landmarks."""
    K = m.kf_id
    ids = np.arange(K - 12, K, dtype=np.int32)
    free = ids[-5:]
    max_kf = m.state.kfs.valid.shape[0]
    loc = np.full(max_kf, -1, np.int32)
    loc[ids] = np.arange(12)
    free_mask = np.zeros(max_kf, bool)
    free_mask[free] = True
    rng = np.random.default_rng(1)
    side = [rng.normal(0, 0.1, (max_kf, 3)).astype(np.float32)
            for _ in range(3)]
    R_bc = np.asarray(jlie.so3_exp(jnp.asarray(
        np.array([0.1, -0.2, 0.05], np.float32))))
    t_bc = np.array([0.02, -0.06, 0.01], np.float32)
    return ids, free, loc, free_mask, side, R_bc, t_bc


@pytest.mark.parametrize("use_stereo", [False, True])
def test_gather_and_scatter_viba(use_stereo):
    m = small_map()
    st = m.state
    if use_stereo:
        ur = np.where(st.kfs.kp_valid, st.kfs.kp_xy[..., 0] - 5.0, -1.0)
        st = st._replace(kfs=st.kfs._replace(kp_ur=ur.astype(np.float32)))
    ids, free, loc, free_mask, side, R_bc, t_bc = _window(m)
    jst = jax_map_state(st)
    jout = jvi._gather_viba_visual(
        jst, jnp.asarray(ids), jnp.asarray(loc), jnp.asarray(free_mask),
        *(jnp.asarray(a) for a in side), jnp.asarray(R_bc),
        jnp.asarray(t_bc), l_slots=L_SLOTS, use_stereo=use_stereo)
    tst = convert.map_state_to_torch(st, "cpu")
    tout = tvi._gather_viba_visual(
        tst, t(ids), t(loc), t(free_mask), *(t(a) for a in side), t(R_bc),
        t(t_bc), L_SLOTS, use_stereo)
    # More landmarks qualify than there are slots: the tie order decides.
    obs_kf, obs_valid = st.obs.kf, st.obs.valid
    seen = (obs_valid & (obs_kf >= 0)
            & free_mask[np.maximum(obs_kf, 0)]).any(-1) & st.lms.valid
    assert seen.sum() > 2 * L_SLOTS
    np.testing.assert_array_equal(n(tout[11]), np.flatnonzero(seen)[:L_SLOTS])
    names = ("R_wb", "p_w", "v", "bg", "ba", "points", "obs_kf", "obs_uv",
             "obs_w", "o_valid", "lm_valid", "lsel", "obs_ur")
    for name, a, b in zip(names, jout, tout):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(n(b), n(a), atol=1e-6, err_msg=name)

    # The write-back of a result: perturbed states and points, some
    # observations gated out.
    rng = np.random.default_rng(2)
    K = len(ids)
    R_cb, t_cb = R_bc.T, -R_bc.T @ t_bc
    res = dict(
        R_wb=n(jout[0]) @ np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, (K, 3)).astype(np.float32)))),
        p_w=n(jout[1]) + rng.normal(0, 0.01, (K, 3)),
        v_w=rng.normal(0, 1, (K, 3)), bg=rng.normal(0, 1e-3, (K, 3)),
        ba=rng.normal(0, 1e-2, (K, 3)),
        points=n(jout[5]) + rng.normal(0, 0.01, (L_SLOTS, 3)),
        obs_inlier=n(jout[9]) & (rng.random(n(jout[9]).shape) > 0.2),
        cost=np.float32(1.0))
    res = {k: np.asarray(v, np.float32 if k != "obs_inlier" else bool)
           for k, v in res.items()}
    free_rows = np.isin(ids, free)
    jres = jba.VIBAResult(**{k: jnp.asarray(v) for k, v in res.items()})
    jnew = jvi._scatter_viba(
        jst, jres, jnp.asarray(ids), jnp.asarray(free_rows), jout[11],
        jout[10], jout[9], jnp.asarray(R_cb), jnp.asarray(t_cb),
        *(jnp.asarray(a) for a in side))
    tres = tba.VIBAResult(**{k: t(v) for k, v in res.items()})
    tnew = tvi._scatter_viba(
        tst, tres, t(ids), t(free_rows), tout[11], tout[10], tout[9],
        t(R_cb), t(t_cb), *(t(a) for a in side))
    jstate = jax.tree.map(np.asarray, jnew[0])
    tstate = convert.map_state_to_numpy(tnew[0])
    # The intended difference (a repaired fault of the reference): a window
    # landmark that lost an observation to the gate is recounted and dies
    # below 2 live observations; the JAX write-back leaves its count and
    # liveness as they were.
    live_obs = (jstate.obs.valid & (jstate.obs.kf >= 0)).sum(-1)
    lsel = n(tout[11])[n(tout[10])]
    lost = np.zeros(len(live_obs), bool)
    lost[lsel] = (st.obs.valid[lsel] & ~jstate.obs.valid[lsel]).any(-1)
    want_n_obs = np.where(lost, live_obs, jstate.lms.n_obs)
    want_valid = jstate.lms.valid & ~(lost & (want_n_obs < 2))
    np.testing.assert_array_equal(tstate.lms.n_obs, want_n_obs)
    np.testing.assert_array_equal(tstate.lms.valid, want_valid)
    assert lost.sum() > 0 and (want_valid != jstate.lms.valid).sum() > 0
    assert not (tstate.lms.valid & (live_obs == 0)).any()
    assert (jstate.lms.valid & (live_obs == 0)).any()
    for grp in ("kfs", "lms", "obs"):
        for name, a, b in zip(getattr(jstate, grp)._fields,
                              getattr(jstate, grp), getattr(tstate, grp)):
            if grp == "lms" and name in ("n_obs", "valid"):
                continue
            np.testing.assert_allclose(b, a, atol=1e-6,
                                       err_msg=f"{grp}.{name}")
    for a, b in zip(jnew[1:], tnew[1:]):
        np.testing.assert_allclose(n(b), n(a), atol=1e-7)
    # Only the free keyframes' slots were written.
    others = np.setdiff1d(np.arange(len(side[0])), free)
    for a, b in zip(side, tnew[1:]):
        assert torch.equal(b[others], t(a)[others])
