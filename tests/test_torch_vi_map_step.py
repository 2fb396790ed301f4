"""Port parity: ``graft.vi_keyframe_step`` against the JAX system's
``MonoInertialSlam._local_inertial_ba`` on ``graft.euroc_vi_map``, and
``graft.vi_initialize`` against ``_initialize_imu`` on
``graft.euroc_vi_init`` with the stereo gates (a ``StereoInertialSlam``: the
(1e2, 1e5) prior, the scale fixed) and the mono gates (a
``MonoInertialSlam``: (1e2, 1e10), the scale free, on a map scaled down by
2), at tests/test_torch_vi_step.py's small capacity on the CPU. Each JAX
system's state is set from the same numpy arrays the port gets.

Tolerances: keyframe poses within 1e-4, landmarks within 1e-3 m, velocities
within 1e-3 m/s and biases within 1e-4 (float32 LM over 10-15 Schur
solves; the same inlier gating). The init is looser where its solve is
ill-conditioned, and both packages are then held to the truth as well:
with the stereo gates the accelerometer bias under the 1e5 prior (1 s of
chain; the two solves 3.7e-4 m/s^2 apart) within 1e-3, and landmarks
within 5e-3 m (a few far ones of the mono map scaled by 2); both packages'
keyframe spacings equally far from the truth's, within 1 mm. The gates
against the truth are chip_smoke.py phase 12's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_vi_step import SMALL, _jax_system
from torch_port_util import jax_map_state, n

from orbslam3_byzyh_tpu.ops import imu as jimu
from orbslam3_byzyh_tpu_torch import convert, graft


def _set_map(js, m: graft.ViMap):
    js.state = jax_map_state(m.state)
    js.n_kf = m.kf_id + 1
    js.last_kf_id = m.kf_id
    js.kf_prev = m.kf_prev.copy()
    js.kf_preint = [None if q is None else jimu.PreintState(
        *(jnp.asarray(a) for a in q)) for q in m.kf_preint]
    js.kf_vel = jnp.asarray(m.kf_vel)
    js.kf_bg = jnp.asarray(m.kf_bg)
    js.kf_ba = jnp.asarray(m.kf_ba)
    js.kf_stamp = m.kf_stamp.copy()
    js.map_first_kf = m.map_first_kf


def _assert_maps_close(js, imap, m: graft.ViMap, pose_tol=1e-4,
                       lm_tol=1e-3, ba_tol=1e-4):
    got = convert.inertial_map_to_numpy(imap)
    ref = jax.tree.map(np.asarray, js.state)
    K = m.kf_id + 1
    np.testing.assert_allclose(got["state"].kfs.R[:K], ref.kfs.R[:K],
                               atol=pose_tol)
    np.testing.assert_allclose(got["state"].kfs.t[:K], ref.kfs.t[:K],
                               atol=pose_tol)
    live = ref.lms.valid
    np.testing.assert_allclose(got["state"].lms.pos[live],
                               ref.lms.pos[live], atol=lm_tol)
    np.testing.assert_array_equal(got["state"].obs.valid, ref.obs.valid)
    np.testing.assert_allclose(got["kf_vel"], np.asarray(js.kf_vel),
                               atol=1e-3)
    np.testing.assert_allclose(got["kf_bg"], np.asarray(js.kf_bg), atol=1e-4)
    np.testing.assert_allclose(got["kf_ba"], np.asarray(js.kf_ba),
                               atol=ba_tol)
    return got


def test_vi_keyframe_step():
    m = graft.euroc_vi_map(SMALL, n_live_kf=24, view_points=600)
    ctx = graft.vi_context(SMALL, "cpu")
    out = graft.vi_keyframe_step(graft.vi_map_args(m, "cpu"), m.kf_id,
                                 m.map_first_kf, ctx)
    js = _jax_system()
    _set_map(js, m)
    js._ur = jnp.zeros(1)                # the stereo rows on
    js._local_inertial_ba(m.kf_id)
    got = _assert_maps_close(js, out, m)
    # The free keyframes moved towards the truth; the rest stayed.
    K = m.kf_id + 1
    free = np.arange(K - SMALL.viba_free, K)

    def centres(R, t_):
        return -np.einsum("kji,kj->ki", R[:K].astype(np.float64),
                          t_[:K].astype(np.float64))
    c_true = centres(m.R_true, m.t_true)
    e0 = np.linalg.norm(centres(m.state.kfs.R, m.state.kfs.t) - c_true,
                        axis=-1)[free]
    e1 = np.linalg.norm(centres(got["state"].kfs.R, got["state"].kfs.t)
                        - c_true, axis=-1)[free]
    assert e1.mean() < 0.5 * e0.mean(), (e0, e1)
    fixed = np.setdiff1d(np.arange(SMALL.rig.mono.max_kf), free)
    assert (got["state"].kfs.R[fixed] == m.state.kfs.R[fixed]).all()
    assert (got["kf_vel"][fixed] == m.kf_vel[fixed]).all()


@pytest.mark.parametrize("case", ["stereo", "mono"])
def test_vi_initialize(case):
    cfg = SMALL if case == "stereo" else graft.mono_inertial_gates(SMALL)
    m = graft.euroc_vi_init(cfg, case=case, view_points=600)
    ctx = graft.vi_context(cfg, "cpu", stereo=case == "stereo")
    out, fit, ok = graft.vi_initialize(graft.vi_map_args(m, "cpu"), m.kf_id,
                                       ctx, cfg)
    js = _jax_system(cfg, mono=case == "mono")
    _set_map(js, m)
    js._last = None
    if case == "stereo":
        js._ur = jnp.zeros(1)            # the stereo rows on
    js._initialize_imu(m.kf_id)
    assert ok and js.imu_ready
    got = _assert_maps_close(js, out, m, lm_tol=5e-3, ba_tol=1e-3)
    np.testing.assert_allclose(fit.bias[:3], js._bias[:3], atol=1e-5)
    np.testing.assert_allclose(fit.bias[3:], js._bias[3:], atol=1e-3)
    # Both packages' keyframe spacings against the truth's (metric).
    K = m.kf_id + 1

    def spacing(R, t_):
        c = -np.einsum("kji,kj->ki", R[:K].astype(np.float64),
                       t_[:K].astype(np.float64))
        return np.linalg.norm(c[1:] - c[:1], axis=-1)
    truth = spacing(m.R_true, m.t_true) * m.scale
    err_t = np.abs(spacing(got["state"].kfs.R, got["state"].kfs.t) - truth)
    ref = jax.tree.map(np.asarray, js.state)
    err_j = np.abs(spacing(ref.kfs.R, ref.kfs.t) - truth)
    assert abs(err_t.max() - err_j.max()) < 1e-3
    assert err_t.max() < (0.01 if case == "stereo" else 0.03 * truth.max())
    # The gates against the truth.
    g_est = n(fit.solve.R_wg).astype(np.float64) @ [0, 0, -1.0]
    g_true = m.R_vw.astype(np.float64) @ [0, 0, -1.0]
    assert np.degrees(np.arccos(np.clip(g_est @ g_true, -1, 1))) < 1.0
    s_true = 1.0 if case == "stereo" else m.scale
    assert abs(fit.scale - s_true) / s_true < 0.02
    assert np.abs(fit.bias[:3] - m.bias_true[:3]).max() < 2.5e-3
