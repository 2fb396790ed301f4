"""Port parity: the RANSAC PnP (``ops/pnp.py``) against the JAX package's.

``tests/test_pnp.py``'s cases (200 points, 30 % outliers, 0.5 px noise;
keys 0 and 1) are replayed with the JAX function's own sample indices,
recomputed here from the same key (``jax.random.choice`` without
replacement, weights valid + 1e-9): the port takes its indices from the
caller.

The RANSAC's scoring, its choice of hypothesis and the refine are held to
the JAX function on the JAX function's own hypotheses (its ``_dlt_pose``
over the same samples, compiled as the function compiles it, handed to
the port in place of its own): the refined pose within 1e-4, the inlier
masks and counts equal. The hypotheses themselves cannot agree to that
level, for two reasons stated here:

  * float32 ``eigh`` of the DLT's 12 x 12 normal matrix is ill-conditioned
    on a 6-point sample: torch's and JAX's null vectors differ in the
    fourth digit, enough to move chi2 values across the 5.991 gate. The
    refine only drops inliers from the winning hypothesis's set, so a
    different set refines to a different pose (up to 5e-3 apart here,
    both within test_pnp.py's gates of the truth).
  * The null vector comes back with either sign, and the JAX function
    takes the sign as it comes: a hypothesis whose 3 x 3 block has a
    negative determinant is turned by pi about an axis (68 and 67 of the
    128 here), and scores near zero. The port turns the vector to a
    positive determinant first, so each of its hypotheses is the DLT's
    pose; it can then pick a hypothesis that the JAX function lost.

So the port's own run is held to test_pnp.py's gates of the truth, and
its hypotheses to the JAX function's: the same pose for the winning
samples, and the same pose or that pose turned by pi for all but a few
ill-conditioned samples.

Relocalisation runs the PnP over one row per keypoint (its matched
landmark), not over every landmark slot as the JAX system does, so that
K3's refine fits in its shared memory at 65536 slots. The rows and the
arithmetic are the same; the sums run in another order.
``test_keypoint_rows_match_landmark_slots`` holds the two forms to each
other, with the JAX indices mapped from landmark slots to keypoint rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pnp import _make_problem
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import pnp as jpnp
from orbslam3_byzyh_tpu_torch.ops import pnp as tpnp

CAM = np.array([400.0, 400.0, 320.0, 240.0], np.float32)


def _jax_indices(key, valid, n_iters=128, sample_size=6):
    """The JAX function's (n_iters, sample_size) draws for ``key``."""
    n_rows = len(valid)
    w = jnp.asarray(valid, jnp.float32) + 1e-9
    keys = jax.random.split(key, n_iters)
    return np.array(jax.vmap(lambda k: jax.random.choice(
        k, n_rows, shape=(sample_size,), replace=False, p=w / w.sum()))(keys))


@jax.jit
def _jax_hypotheses(idx, pts_w, uv, cam_params):
    """The JAX function's hypotheses (R (I, 3, 3), t (I, 3)) for the
    samples ``idx``, computed as ``pnp_ransac`` computes them."""
    x = jnp.stack([(uv[:, 0] - cam_params[2]) / cam_params[0],
                   (uv[:, 1] - cam_params[3]) / cam_params[1]], -1)
    return jax.vmap(lambda s: jpnp._dlt_pose(pts_w[s], x[s]))(idx)


def _on_jax_hypotheses(monkeypatch, idx, pts, uv, cam, *args):
    """The port's ``pnp_ransac`` with the JAX function's hypotheses."""
    H = tuple(torch.from_numpy(np.array(a)) for a in _jax_hypotheses(
        jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(cam)))
    with monkeypatch.context() as m:
        m.setattr(tpnp, "_dlt_pose", lambda X, x: H)
        return tpnp.pnp_ransac(torch.from_numpy(idx), t(pts), t(uv),
                               *args)


def _angle(Ra, Rb):
    """Rotation angles (rad) of Ra Rb^T, batched, in float64."""
    M = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64),
                                                 -1, -2)
    c = (np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def _same(got, want):
    np.testing.assert_allclose(n(got.R), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(n(got.t), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(n(got.inlier), np.asarray(want.inlier))
    assert int(got.n_inliers) == int(want.n_inliers)
    assert bool(got.ok) == bool(want.ok)


@pytest.mark.parametrize("seed", [0, 1])
def test_replays_test_pnp(seed, rng, monkeypatch):
    pts, uv, R, tt, cam, out_idx = _make_problem(rng)
    pts, uv = pts.astype(np.float32), uv.astype(np.float32)
    nn = len(pts)
    ones, valid = np.ones(nn, np.float32), np.ones(nn, bool)
    key = jax.random.PRNGKey(seed)
    want = jpnp.pnp_ransac(key, jnp.asarray(pts), jnp.asarray(uv),
                           jnp.asarray(ones), jnp.asarray(valid),
                           jnp.asarray(cam))
    idx = _jax_indices(key, valid)
    got = _on_jax_hypotheses(monkeypatch, idx, pts, uv, cam, t(ones),
                             t(valid), t(cam))
    _same(got, want)
    assert bool(want.ok)

    # The port's own hypotheses and result.
    own = tpnp.pnp_ransac(torch.from_numpy(idx), t(pts), t(uv), t(ones),
                          t(valid), t(cam))
    np.testing.assert_array_equal(n(own.idx), idx)
    assert bool(own.ok)
    assert _angle(n(own.R), R) < 0.01
    assert np.linalg.norm(n(own.t) - tt) < 0.05
    if seed == 0:
        assert int(own.n_inliers) > 100
    else:
        assert n(own.inlier)[out_idx].mean() < 0.05
    Rj, tj = (np.asarray(a) for a in _jax_hypotheses(
        jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(cam)))
    x = np.stack([(uv[:, 0] - cam[2]) / cam[0],
                  (uv[:, 1] - cam[3]) / cam[1]], -1).astype(np.float32)
    Rp, _ = tpnp._dlt_pose(t(pts)[torch.from_numpy(idx)],
                           t(x)[torch.from_numpy(idx)])
    ang = _angle(Rj, n(Rp))
    turned = np.abs(ang - np.pi) < 1e-2
    same = ang < 1e-2
    print(f"key {seed}: of 128 hypotheses {same.sum()} the same pose, "
          f"{turned.sum()} turned by pi in the JAX function, "
          f"{128 - same.sum() - turned.sum()} apart (ill-conditioned "
          "samples)")
    # The JAX function's winning samples give the port the same pose, and
    # but for a few ill-conditioned samples each hypothesis is that pose
    # or it turned by pi.
    pc = np.einsum("nj,bij->bni", pts, Rj) + tj[:, None]
    chi2 = ((uv - cam[:2] * pc[..., :2] / pc[..., 2:] - cam[2:]) ** 2).sum(-1)
    scores = ((chi2 < 5.991) & (pc[..., 2] > 0.05)).sum(-1)
    assert same[scores == scores.max()].all()
    assert (same | turned).sum() >= 115 and turned.sum() > 30


def test_degenerate_fails_gracefully():
    """No valid row: ok is False, and nothing is NaN."""
    pts, uv = np.zeros((50, 3), np.float32), np.zeros((50, 2), np.float32)
    valid = np.zeros(50, bool)
    key = jax.random.PRNGKey(2)
    want = jpnp.pnp_ransac(key, jnp.asarray(pts), jnp.asarray(uv),
                           jnp.ones(50), jnp.asarray(valid),
                           jnp.asarray(CAM))
    got = tpnp.pnp_ransac(torch.from_numpy(_jax_indices(key, valid)),
                          t(pts), t(uv), torch.ones(50), t(valid), t(CAM))
    assert not bool(got.ok) and not bool(want.ok)
    assert int(got.n_inliers) == int(want.n_inliers) == 0
    assert np.isfinite(n(got.R)).all() and np.isfinite(n(got.t)).all()


def test_keypoint_rows_match_landmark_slots(rng, monkeypatch):
    """The relocalisation's form: 1024 landmark slots, 200 of them matched
    to 300 keypoints. The JAX function runs over the slots, the port over
    the keypoints (each keypoint's landmark, -1 without), with the JAX
    draws mapped from slots to keypoint rows."""
    pts, uv, R, tt, cam, out_idx = _make_problem(rng)
    L, K = 1024, 300
    slots = rng.choice(L, len(pts), replace=False)
    kps = rng.choice(K, len(pts), replace=False)
    pos = rng.normal(0, 3, (L, 3)).astype(np.float32)
    pos[slots] = pts
    xy = rng.uniform(0, 640, (K, 2)).astype(np.float32)
    xy[kps] = uv
    level = rng.integers(0, 3, K)
    inv_s2 = (1.0 / 1.2 ** (2 * level)).astype(np.float32)
    mj = np.full(L, -1, np.int32)          # each slot's keypoint
    mj[slots] = kps
    kp_lm = np.full(K, -1, np.int32)       # each keypoint's landmark
    kp_lm[kps] = slots
    key = jax.random.PRNGKey(3)
    lm_valid = mj >= 0
    kp = np.maximum(mj, 0)
    want = jpnp.pnp_ransac(key, jnp.asarray(pos), jnp.asarray(xy[kp]),
                           jnp.asarray(inv_s2[kp]), jnp.asarray(lm_valid),
                           jnp.asarray(cam))
    idx = _jax_indices(key, lm_valid)
    assert lm_valid[idx].all()             # no unmatched slot was drawn
    rows = mj[idx].astype(np.int64)
    H = _jax_hypotheses(jnp.asarray(idx), jnp.asarray(pos),
                        jnp.asarray(xy[kp]), jnp.asarray(cam))
    H = tuple(torch.from_numpy(np.array(a)) for a in H)
    monkeypatch.setattr(tpnp, "_dlt_pose", lambda X, x: H)
    got = tpnp.pnp_ransac(torch.from_numpy(rows),
                          t(pos[np.maximum(kp_lm, 0)]), t(xy), t(inv_s2),
                          t(kp_lm >= 0), t(cam))
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(n(got.R), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(n(got.t), np.asarray(want.t), atol=1e-4)
    per_kp = np.zeros(K, bool)
    per_kp[kps] = np.asarray(want.inlier)[slots]
    np.testing.assert_array_equal(n(got.inlier), per_kp)
    assert int(got.n_inliers) == int(want.n_inliers)
    assert not np.asarray(want.inlier)[~lm_valid].any()


def test_draw_indices():
    """The port's own draws: rows without replacement, only valid rows
    while enough have weight, on the generator's device."""
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::7] = True
    idx = tpnp.draw_indices(torch.Generator().manual_seed(0), valid)
    assert idx.shape == (128, 6)
    assert bool(valid[idx].all())
    assert all(len(set(r.tolist())) == 6 for r in idx)
