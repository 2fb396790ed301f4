"""Port parity: the global BA and the time-sliced background global BA
against the JAX package (``test_background_gba.py``'s four cases, on its
corridor map: 12 live of 16 keyframe slots, 512 landmark slots, 6
observations).

The JAX package assembles the Schur complement by its one-hot form, the
port by scatter-add (``ba.schur_pieces_scatter``), so sums differ in
order. Tolerances: the global BA's and each tick's poses within 1e-4 and
points within 1e-3 (float32 LM over 10-15 iterations, the accept test on
costs that agree to float32 rounding), the merged states within the same;
the JAX test's own gates on the port's results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_util import n, t

from orbslam3_byzyh_tpu.pipeline import mapping as jmapping
from orbslam3_byzyh_tpu.pipeline.background_gba import BackgroundGBA as JGBA
from orbslam3_byzyh_tpu_torch import convert
from orbslam3_byzyh_tpu_torch.parallel import dist_ba
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmapping
from orbslam3_byzyh_tpu_torch.pipeline.background_gba import (
    BackgroundGBA as TGBA)
from test_background_gba import K_PARAMS, _rmse_t, build_map

POSE_TOL, POS_TOL = 1e-4, 1e-3
PARENT = np.arange(-1, 15, dtype=np.int32)


def _port(state):
    import jax
    return convert.map_state_to_torch(jax.tree.map(np.asarray, state), "cpu")


def _close_states(got, ref, n_kf):
    np.testing.assert_allclose(n(got.kfs.R)[:n_kf],
                               np.asarray(ref.kfs.R)[:n_kf], atol=POSE_TOL)
    np.testing.assert_allclose(n(got.kfs.t)[:n_kf],
                               np.asarray(ref.kfs.t)[:n_kf], atol=POSE_TOL)
    live = np.asarray(ref.lms.valid)
    np.testing.assert_allclose(n(got.lms.pos)[live],
                               np.asarray(ref.lms.pos)[live], atol=POS_TOL)


def _rmse(state, ts_gt, n_kf):
    tt = n(state.kfs.t)[:n_kf]
    return float(np.sqrt(((tt - ts_gt[:n_kf]) ** 2).sum(-1).mean()))


@pytest.fixture(scope="module")
def noisy_map():
    state, ts_gt, n_kf = build_map(np.random.default_rng(42), pose_noise=0.05)
    return state, ts_gt, n_kf


def test_global_ba(noisy_map):
    """``mapping.global_ba``: every live keyframe free but keyframe 0."""
    state, ts_gt, n_kf = noisy_map
    ref = jmapping.global_ba(state, jnp.asarray(K_PARAMS))
    got = tmapping.global_ba(_port(state), t(K_PARAMS))
    _close_states(got, ref, n_kf)
    np.testing.assert_array_equal(n(got.obs.valid), np.asarray(ref.obs.valid))
    np.testing.assert_array_equal(n(got.lms.valid), np.asarray(ref.lms.valid))
    np.testing.assert_array_equal(n(got.kfs.t)[0], np.asarray(state.kfs.t)[0])
    # Over a device mesh (4 CPU shards of the 512 landmark slots): the
    # same result within the same tolerances.
    mesh = dist_ba.make_mesh(devices=["cpu"] * 4)
    _close_states(tmapping.global_ba(_port(state), t(K_PARAMS), mesh=mesh),
                  ref, n_kf)


class TestBackgroundGBA:
    def test_converges_like_inline(self, noisy_map):
        state, ts_gt, n_kf = noisy_map
        err0 = _rmse_t(state, ts_gt, n_kf)
        gj, g = JGBA(), TGBA()
        gj.start(state, n_kf, jnp.asarray(K_PARAMS))
        g.start(_port(state), n_kf, t(K_PARAMS))
        ticks = 0
        while True:
            done_j, done = gj.tick(), g.tick()
            assert done == done_j
            # Each tick's iterate against the JAX one.
            for a, b, tol in zip(g._carry[:3], gj._carry[:3],
                                 (POSE_TOL, POSE_TOL, POS_TOL)):
                np.testing.assert_allclose(n(a), np.asarray(b), atol=tol)
            if done:
                break
            ticks += 1
        assert ticks + 1 == g.total_iters
        merged_j = gj.merge(state, PARENT)
        merged = g.merge(_port(state), PARENT)
        assert not g.active
        _close_states(merged, merged_j, n_kf)
        err_bg = _rmse(merged, ts_gt, n_kf)
        err_in = _rmse(tmapping.global_ba(_port(state), t(K_PARAMS)), ts_gt,
                       n_kf)
        assert err_bg < 0.25 * err0, (err0, err_bg)
        assert err_bg < err_in * 1.5 + 1e-4, (err_bg, err_in)

    def test_propagates_to_new_keyframe(self, noisy_map):
        state, ts_gt, n_kf = noisy_map
        gj, g = JGBA(), TGBA()
        gj.start(state, n_kf, jnp.asarray(K_PARAMS))
        g.start(_port(state), n_kf, t(K_PARAMS))
        # A new keyframe lands mid-solve, with a landmark it made.
        dR = np.eye(3, dtype=np.float32)
        dt = np.array([-0.4, 0.02, 0.01], np.float32)
        R_par = np.asarray(state.kfs.R[n_kf - 1])
        t_par = np.asarray(state.kfs.t[n_kf - 1])
        R_new, t_new = dR @ R_par, dR @ t_par + dt
        lm_new = state.lms.pos.shape[0] - 1
        x_new = np.array([0.4 * n_kf, 0.5, 4.0], np.float32)
        state2 = state._replace(
            kfs=state.kfs._replace(
                R=state.kfs.R.at[n_kf].set(jnp.asarray(R_new)),
                t=state.kfs.t.at[n_kf].set(jnp.asarray(t_new)),
                valid=state.kfs.valid.at[n_kf].set(True)),
            lms=state.lms._replace(
                pos=state.lms.pos.at[lm_new].set(jnp.asarray(x_new)),
                valid=state.lms.valid.at[lm_new].set(True),
                first_kf=state.lms.first_kf.at[lm_new].set(n_kf)))
        while not gj.tick():
            pass
        while not g.tick():
            pass
        merged_j = gj.merge(state2, PARENT)
        merged = g.merge(_port(state2), PARENT)
        _close_states(merged, merged_j, n_kf + 1)
        Rp2, tp2 = n(merged.kfs.R)[n_kf - 1], n(merged.kfs.t)[n_kf - 1]
        Rn2, tn2 = n(merged.kfs.R)[n_kf], n(merged.kfs.t)[n_kf]
        rel_R = Rn2 @ Rp2.T
        np.testing.assert_allclose(rel_R, dR, atol=1e-5)
        np.testing.assert_allclose(tn2 - rel_R @ tp2, dt, atol=1e-5)
        xc_after = Rn2 @ n(merged.lms.pos)[lm_new] + tn2
        np.testing.assert_allclose(xc_after, R_new @ x_new + t_new, atol=1e-5)
        np.testing.assert_allclose(n(merged.lms.pos)[lm_new],
                                   np.asarray(merged_j.lms.pos)[lm_new],
                                   atol=POS_TOL)

    def test_abort_leaves_state_untouched(self, noisy_map):
        state, _, n_kf = noisy_map
        g = TGBA()
        g.start(_port(state), n_kf, t(K_PARAMS))
        g.tick()
        g.abort()
        assert not g.active
        assert not g.tick()
        assert not g.flush()

    def test_flush_completes(self, noisy_map):
        state, ts_gt, n_kf = noisy_map
        gj, g = JGBA(), TGBA()
        gj.start(state, n_kf, jnp.asarray(K_PARAMS))
        g.start(_port(state), n_kf, t(K_PARAMS))
        gj.tick()
        g.tick()
        assert g.flush() and gj.flush()
        merged = g.merge(_port(state), PARENT)
        _close_states(merged, gj.merge(state, PARENT), n_kf)
        assert _rmse(merged, ts_gt, n_kf) < 0.02


def test_anchor_walk():
    """The merge's host walk: the nearest snapshot ancestor on the spanning
    tree, and the nearest earlier snapshot slot for a root made since."""
    snap = np.array([True, True, True, False, False, False])
    parent = np.array([-1, 0, 1, 2, -1, 3])
    np.testing.assert_array_equal(TGBA.anchors(snap, parent, 3),
                                  [0, 1, 2, 2, 2, 2])
