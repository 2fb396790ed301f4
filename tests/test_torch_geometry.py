"""Port parity: the two-view geometry (``ops/geometry.py``) against the JAX
package's, on test_geometry.py's synthetic scenes.

The RANSAC's sample indices are drawn once with the JAX package's
``geometry._sample_indices(key, 200, 8, mask + 1e-9)`` and handed to the
port; the JAX package gets the same key, so both score the same hypotheses.
The JAX functions run under ``jax.jit`` (the same code, compiled once).

Tolerances: poses and unit translations 1e-4; points 1e-4 relative to their
distance; the good mask equal or within 1 %; the decomposition candidates
compared as sets, matched one to one within 1e-4, never by position: the
two packages' SVD factors can differ in sign and order, and a pair of sign
flips turns R1 into R2. On the planar scene the F family's 8-point null
space is near-degenerate, so there only the H family and the final choice
are compared (rh is printed).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_geometry import K, synth_two_view
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu_torch.ops import geometry as tgeo

SCENES = {"general": dict(noise=0.5),
          "planar": dict(planar=True, noise=0.5),
          "no_parallax": dict(baseline=0.0, noise=0.3)}


@functools.cache
def _jit(name):
    return jax.jit(getattr(jgeo, name))


def _scene(name):
    """test_geometry.py's scene (the rng fixture's seed), the JAX package's
    sample indices for PRNGKey(0) and the key."""
    x1, x2, X, R, tt, ok = synth_two_view(np.random.default_rng(42),
                                          **SCENES[name])
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jgeo._sample_indices(
        key, 200, 8, jnp.asarray(ok).astype(jnp.float32) + 1e-9))
    return x1, x2, X, R, tt, ok, key, idx


def _jnp(*a):
    return tuple(jnp.asarray(x) for x in a)


def _match_sets(Rs_ref, ts_ref, Rs_got, ts_got, atol=1e-4):
    """Each reference candidate matched to a distinct port candidate
    within ``atol`` in R and t."""
    Rs_ref, ts_ref = np.asarray(Rs_ref), np.asarray(ts_ref)
    Rs_got, ts_got = n(Rs_got), n(ts_got)
    free = list(range(len(Rs_got)))
    for i in range(len(Rs_ref)):
        gap = [max(np.abs(Rs_got[j] - Rs_ref[i]).max(),
                   np.abs(ts_got[j] - ts_ref[i]).max()) for j in free]
        j = int(np.argmin(gap))
        assert gap[j] <= atol, (i, gap)
        free.pop(j)


def test_normalize_points_matches_jax(rng):
    x = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    m = (rng.random(300) < 0.7).astype(np.float32)
    xn_j, T_j = jgeo.normalize_points(jnp.asarray(x), jnp.asarray(m))
    xn_t, T_t = tgeo.normalize_points(t(x), t(m))
    np.testing.assert_allclose(n(xn_t), np.asarray(xn_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(n(T_t), np.asarray(T_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_dlt_matches_jax_and_recovers_points(rng, noise):
    """TestTriangulate: the DLT against the truth and the JAX package."""
    x1, x2, X, R, tt, ok = synth_two_view(rng, noise=noise)
    Kj = jnp.asarray(K)
    P1 = jgeo.projection_matrix(Kj, jnp.eye(3), jnp.zeros(3))
    P2 = jgeo.projection_matrix(Kj, jnp.asarray(R), jnp.asarray(tt))
    ref = np.asarray(jgeo.triangulate_dlt(P1, P2, *_jnp(x1, x2)))
    got = n(tgeo.triangulate_dlt(t(np.asarray(P1)), t(np.asarray(P2)),
                                 t(x1), t(x2)))
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4, atol=1e-4)
    err = np.linalg.norm(got[ok] - X[ok], axis=-1)
    if noise == 0.0:
        assert err.max() < 2e-2
    else:
        assert np.median(err) < 0.15


def _normalized(x1, x2, ok):
    m = ok.astype(np.float32)
    x1n, T1 = jgeo.normalize_points(jnp.asarray(x1), jnp.asarray(m))
    x2n, T2 = jgeo.normalize_points(jnp.asarray(x2), jnp.asarray(m))
    return np.asarray(x1n), np.asarray(T1), np.asarray(x2n), np.asarray(T2)


def _same_up_to_sign(got, ref, tol):
    """(..., 3, 3) matrices equal up to sign within ``tol`` of the largest
    entry of each."""
    ref = np.asarray(ref)
    got = n(got) * np.sign((n(got) * ref).sum((-1, -2)))[..., None, None]
    scale = np.abs(ref).max((-1, -2), keepdims=True)
    assert (np.abs(got - ref) <= tol * scale).all(), \
        np.abs(got - ref).max() / scale.min()


def test_fundamental_matches_jax_and_epipolar_constraint(rng):
    """TestMinimalSolvers: the 8-point F on exact points."""
    x1, x2, X, R, tt, ok = synth_two_view(rng, noise=0.0)
    x1n, T1, x2n, T2 = _normalized(x1, x2, ok)
    sel = np.where(ok)[0][:8]
    Fn_j = jgeo.fundamental_8pt(*_jnp(x1n[sel], x2n[sel]))
    Fn_t = tgeo.fundamental_8pt(t(x1n[sel]), t(x2n[sel]))
    _same_up_to_sign(Fn_t, Fn_j, 1e-4)
    F = T2.T @ n(Fn_t) @ T1
    x1h = np.concatenate([x1, np.ones((len(x1), 1))], -1)
    x2h = np.concatenate([x2, np.ones((len(x2), 1))], -1)
    lines = x1h @ F.T
    d = np.abs(np.sum(x2h * lines, -1)) / np.linalg.norm(lines[:, :2], axis=-1)
    assert np.median(d[ok]) < 1.0


def test_homography_matches_jax_on_planar_points(rng):
    x1, x2, X, R, tt, ok = synth_two_view(rng, planar=True, noise=0.0)
    x1n, T1, x2n, T2 = _normalized(x1, x2, ok)
    sel = np.where(ok)[0][:8]
    Hn_j = np.asarray(jgeo.homography_dlt(*_jnp(x1n[sel], x2n[sel])))
    Hn_t = tgeo.homography_dlt(t(x1n[sel]), t(x2n[sel]))
    _same_up_to_sign(Hn_t, Hn_j, 1e-4)
    H = np.linalg.inv(T2) @ n(Hn_t) @ T1
    p = np.concatenate([x1, np.ones((len(x1), 1))], -1) @ H.T
    err = np.linalg.norm(p[:, :2] / p[:, 2:3] - x2, axis=-1)
    assert np.median(err[ok]) < 0.5


def test_batched_and_weighted_solvers_match_jax():
    """The hypotheses' batch (one SVD per model over the 200 samples) and
    the inlier refit's weighted solve, against the JAX package's vmap."""
    x1, x2, X, R, tt, ok, key, idx = _scene("general")
    x1n, T1, x2n, T2 = _normalized(x1, x2, ok)
    Hn_j = jax.vmap(jgeo.homography_dlt)(*_jnp(x1n[idx], x2n[idx]))
    Fn_j = jax.vmap(jgeo.fundamental_8pt)(*_jnp(x1n[idx], x2n[idx]))
    Hn_t = tgeo.homography_dlt(t(x1n[idx]), t(x2n[idx]))
    Fn_t = tgeo.fundamental_8pt(t(x1n[idx]), t(x2n[idx]))
    assert Hn_t.shape == Fn_t.shape == (200, 3, 3)
    _same_up_to_sign(Hn_t, Hn_j, 2e-3)
    _same_up_to_sign(Fn_t, Fn_j, 2e-3)
    w = ok.astype(np.float32)
    _same_up_to_sign(tgeo.homography_dlt(t(x1n), t(x2n), t(w)),
                     jgeo.homography_dlt(*_jnp(x1n, x2n, w)), 1e-4)
    _same_up_to_sign(tgeo.fundamental_8pt(t(x1n), t(x2n), t(w)),
                     jgeo.fundamental_8pt(*_jnp(x1n, x2n, w)), 1e-4)


def test_scores_match_jax():
    """Both scores of the JAX package's 200 hypotheses: scores within 1e-4
    relative, inlier masks equal."""
    x1, x2, X, R, tt, ok, key, idx = _scene("general")
    x1n, T1, x2n, T2 = _normalized(x1, x2, ok)
    Hs = np.linalg.inv(T2) @ np.asarray(jax.vmap(jgeo.homography_dlt)(
        *_jnp(x1n[idx], x2n[idx]))) @ T1
    Fs = T2.T @ np.asarray(jax.vmap(jgeo.fundamental_8pt)(
        *_jnp(x1n[idx], x2n[idx]))) @ T1
    Hs, Fs = Hs.astype(np.float32), Fs.astype(np.float32)
    args = _jnp(x1, x2, ok)
    for fn, M in (("score_homography", Hs), ("score_fundamental", Fs)):
        s_j, i_j = jax.vmap(lambda m: getattr(jgeo, fn)(m, *args))(
            jnp.asarray(M))
        s_t, i_t = getattr(tgeo, fn)(t(M), t(x1), t(x2), t(ok))
        np.testing.assert_allclose(n(s_t), np.asarray(s_j), rtol=1e-4,
                                   atol=1e-3, err_msg=fn)
        np.testing.assert_array_equal(n(i_t), np.asarray(i_j), err_msg=fn)


def test_check_rt_matches_jax():
    """All four F candidates of the true pose in one batch."""
    x1, x2, X, R, tt, ok, key, idx = _scene("general")
    E = np.cross(np.eye(3), tt) @ R           # [t]_x R
    F = (np.linalg.inv(K).T @ E @ np.linalg.inv(K)).astype(np.float32)
    Rs, ts = jgeo.decompose_fundamental(jnp.asarray(F), jnp.asarray(K))
    masks = np.stack([ok, ok, ok & (np.arange(len(ok)) % 3 > 0), ok])
    ref = [jgeo.check_rt(Rs[i], ts[i], *_jnp(x1, x2, K, masks[i]))
           for i in range(4)]
    got = tgeo.check_rt(t(np.asarray(Rs)), t(np.asarray(ts)), t(x1), t(x2),
                        t(K), t(masks))
    np.testing.assert_array_equal(n(got[0]), [int(r[0]) for r in ref])
    np.testing.assert_allclose(n(got[1]), [float(r[1]) for r in ref],
                               atol=1e-3)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(n(got[3][i]), np.asarray(r[3]))
        g = np.asarray(r[3])
        if g.any():
            Xr = np.asarray(r[2])[g]
            np.testing.assert_allclose(n(got[2][i])[g], Xr,
                                       atol=1e-4 * np.abs(Xr).max())
    assert int(n(got[0]).max()) > 150


@pytest.mark.parametrize("name", ["general", "planar"])
def test_decompositions_match_jax_as_sets(name):
    """The candidates of the JAX package's own H (and F) as sets."""
    x1, x2, X, R, tt, ok, key, idx = _scene(name)
    models = _jit("ransac_two_models")(key, *_jnp(x1, x2, ok))
    Kj = jnp.asarray(K)
    _match_sets(*jgeo.decompose_homography(models["H"], Kj),
                *tgeo.decompose_homography(t(np.asarray(models["H"])), t(K)))
    if name == "general":
        _match_sets(*jgeo.decompose_fundamental(models["F"], Kj),
                    *tgeo.decompose_fundamental(t(np.asarray(models["F"])),
                                                t(K)))


@pytest.mark.parametrize("name", list(SCENES))
def test_two_view_reconstruct_matches_jax(name):
    """TestTwoViewReconstruct's three scenes: F on the general scene, H on
    the planar one, a failure without parallax; the port chooses as the
    JAX package does on the same indices."""
    x1, x2, X, R, tt, ok, key, idx = _scene(name)
    ref = _jit("two_view_reconstruct")(key, *_jnp(x1, x2, K, ok))
    got = tgeo.two_view_reconstruct(t(idx).long(), t(x1), t(x2), t(K), t(ok))
    m_j = _jit("ransac_two_models")(key, *_jnp(x1, x2, ok))
    m_t = tgeo.ransac_two_models(t(idx).long(), t(x1), t(x2), t(ok))
    rh = float(m_t["SH"] / (m_t["SH"] + m_t["SF"]))
    print(f"{name}: rh {rh:.4f} (JAX {float(m_j['SH'] / (m_j['SH'] + m_j['SF'])):.4f})")
    np.testing.assert_allclose(float(m_t["SH"]), float(m_j["SH"]), rtol=1e-4)
    _same_up_to_sign(m_t["H"], m_j["H"], 1e-4)
    np.testing.assert_array_equal(n(m_t["h_inliers"]),
                                  np.asarray(m_j["h_inliers"]))
    if name != "planar":
        np.testing.assert_allclose(float(m_t["SF"]), float(m_j["SF"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(n(m_t["f_inliers"]),
                                      np.asarray(m_j["f_inliers"]))
    expect = {"general": (True, False), "planar": (True, True),
              "no_parallax": (False, False)}[name]
    assert (bool(ref.success), bool(ref.used_h)) == expect
    assert (bool(got.success), bool(got.used_h)) == expect
    if not expect[0]:
        assert not n(got.good).any()
        return
    np.testing.assert_allclose(n(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(got.t), np.asarray(ref.t), atol=1e-4)
    g_j, g_t = np.asarray(ref.good), n(got.good)
    assert (g_j != g_t).sum() <= 0.01 * g_j.sum()
    both = g_j & g_t
    Xj, Xt = np.asarray(ref.points)[both], n(got.points)[both]
    gap = np.linalg.norm(Xt - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert gap.max() <= 1e-4, gap.max()
    dR = n(got.R).T @ R
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.5


def test_sample_indices_draw_without_replacement_by_weight():
    """Gumbel top-k: distinct indices a row, only rows of positive weight
    while there are enough, the first index of a row distributed as the
    weights, the same draw from the same seed."""
    w = torch.zeros(64)
    w[:16] = torch.tensor([1.0, 2.0, 3.0, 4.0]).repeat(4)
    w = w + 1e-9
    gen = torch.Generator().manual_seed(0)
    idx = tgeo.sample_indices(gen, 4000, 8, w)
    assert idx.shape == (4000, 8) and idx.dtype == torch.int64
    srt = idx.sort(-1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    assert bool((idx < 16).all())
    first = torch.bincount(idx[:, 0], minlength=16)[:16].reshape(4, 4).sum(0)
    share = (first / first.sum()).numpy()
    np.testing.assert_allclose(share, [0.1, 0.2, 0.3, 0.4], atol=0.03)
    again = tgeo.sample_indices(torch.Generator().manual_seed(0), 4000, 8, w)
    assert torch.equal(again, idx)
