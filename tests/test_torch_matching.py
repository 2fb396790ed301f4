"""Port parity: Hamming matching, K2's plain version, frustum culling and
the projection search, against the JAX package. All integer results exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import matching as jm
from orbslam3_byzyh_tpu.ops import pallas_match
from orbslam3_byzyh_tpu_torch.ops import cuda_match
from orbslam3_byzyh_tpu_torch.ops import matching as tm


def _desc_with_ties(rng, na, nb):
    """uint32 descriptors where every target has a duplicate and some
    queries equal a target, so best == second and equal-distance columns
    occur."""
    db = rng.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
    db[1::2] = db[0::2]
    da = rng.integers(0, 2 ** 32, (na, 8), dtype=np.uint32)
    da[::5] = db[rng.integers(0, nb, len(da[::5]))]
    return da, db


def _window_inputs(rng, na, nb):
    xy_a = rng.uniform(0, 640, (na, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 640, (nb, 2)).astype(np.float32)
    xy_b[: na // 2] = xy_a[: na // 2] + rng.normal(0, 3, (na // 2, 2))
    la = rng.integers(0, 8, na).astype(np.int32)
    lb = rng.integers(0, 8, nb).astype(np.int32)
    radius = (4.0 * 1.2 ** la * rng.uniform(1, 20, na)).astype(np.float32)
    return xy_a, xy_b, la, lb, radius


def _epipolar_inputs(rng, na, nb):
    lines = rng.normal(0, 1, (na, 3)).astype(np.float32)
    lines[:, 2] *= 300.0
    xy_b = rng.uniform(0, 640, (nb, 2)).astype(np.float32)
    th = rng.uniform(50, 5000, nb).astype(np.float32)
    return lines, xy_b, th


def test_hamming_matrix_exact(rng):
    da = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, (90, 8), dtype=np.uint32)
    da[0] = 0xFFFFFFFF
    db[0] = 0
    np.testing.assert_array_equal(n(tm.hamming_matrix(t(da), t(db))),
                                  n(jm.hamming_matrix(da, db)))


def test_best_two_exact_with_ties(rng):
    dist = rng.integers(0, 12, (200, 64)).astype(np.int32)   # many ties
    dist[::7] = jm.INVALID_DIST
    dist[3, :] = 5
    for a, b in zip(tm.best_two(t(dist)), jm.best_two(jnp.asarray(dist))):
        np.testing.assert_array_equal(n(a), n(b))
    one_col = dist[:, :1]
    for a, b in zip(tm.best_two(t(one_col)), jm.best_two(jnp.asarray(one_col))):
        np.testing.assert_array_equal(n(a), n(b))


def _k2_inputs(rng, mode, na=200, nb=150):
    da, db = _desc_with_ties(rng, na, nb)
    va, vb = rng.random(na) > 0.1, rng.random(nb) > 0.1
    if mode == "window":
        xy_a, xy_b, la, lb, r = _window_inputs(rng, na, nb)
        gates = dict(xy_a=xy_a, xy_b=xy_b, radius=r, level_a=la, level_b=lb,
                     level_window=(-1, 1))
        pm = jm.window_mask(xy_a, xy_b, r) & jm.level_mask(la, lb, -1, 1)
    elif mode == "epipolar":
        lines, xy_b, th = _epipolar_inputs(rng, na, nb)
        gates = dict(xy_b=xy_b, lines=lines, line_th=th)
        num = (lines[:, None, 0] * xy_b[None, :, 0]
               + lines[:, None, 1] * xy_b[None, :, 1] + lines[:, None, 2])
        pm = num ** 2 / np.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2,
                                   1e-12)[:, None] < th[None, :]
    else:
        gates, pm = {}, None
    return da, db, va, vb, gates, pm


def _tgates(gates):
    return {k: (v if k == "level_window" else t(v)) for k, v in gates.items()}


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_k2_plain_matches_pallas_interpret(rng, mode):
    da, db, va, vb, gates, _ = _k2_inputs(rng, mode)
    ref = pallas_match.hamming_best2(
        da, db, jnp.asarray(va), jnp.asarray(vb), interpret=True,
        **{k: (v if k == "level_window" else jnp.asarray(v))
           for k, v in gates.items()})
    out = cuda_match.hamming_best2_plain(t(da), t(db), t(va), t(vb),
                                         **_tgates(gates))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), n(b))
    assert (n(out[0]) == n(out[1])).any()      # ties were exercised


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_k2_plain_matches_xla_path(rng, mode):
    da, db, va, vb, gates, pm = _k2_inputs(rng, mode)
    dist = jm.masked_hamming(da, db, jnp.asarray(va), jnp.asarray(vb),
                             None if pm is None else jnp.asarray(pm))
    ref = jm.best_two(dist)
    out = cuda_match.hamming_best2(t(da), t(db), t(va), t(vb),
                                   **_tgates(gates))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), n(b))


def _scene(rng, n_lm=300):
    pos = np.stack([rng.uniform(-5, 5, n_lm), rng.uniform(-4, 4, n_lm),
                    rng.uniform(-1, 12, n_lm)], -1).astype(np.float32)
    normal = rng.normal(0, 1, (n_lm, 3))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)
              + pos / np.linalg.norm(pos, axis=1, keepdims=True))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(
        np.float32)
    max_d = rng.uniform(2, 15, n_lm).astype(np.float32)
    min_d = (max_d / 1.2 ** 7).astype(np.float32)
    w = rng.normal(0, 0.05, 3)
    from orbslam3_byzyh_tpu_torch.ops import lie
    R = n(lie.so3_exp(torch.tensor(w))).astype(np.float32)
    tr = rng.normal(0, 0.2, 3).astype(np.float32)
    cam = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    return R, tr, pos, normal, min_d, max_d, cam


def test_frustum_cull(rng):
    args = _scene(rng)
    ref = jm.frustum_cull(*[jnp.asarray(a) for a in args], 640.0, 480.0)
    out = tm.frustum_cull(*[t(a) for a in args], 640.0, 480.0)
    assert 0 < n(ref[0]).sum() < len(n(ref[0]))
    np.testing.assert_array_equal(n(out[0]), n(ref[0]))         # visible
    np.testing.assert_array_equal(n(out[3]), n(ref[3]))         # level
    # Projection and distance: 3-term dot products in another order.
    np.testing.assert_allclose(n(out[1]), n(ref[1]), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(out[2]), n(ref[2]), rtol=1e-6)


def test_search_by_projection_exact(rng):
    na, nb = 300, 200
    da, db = _desc_with_ties(rng, na, nb)
    xy_a, xy_b, la, lb, r = _window_inputs(rng, na, nb)
    # Rows k < na/2 sit next to column k: give them its level and a
    # descriptor a few bits away, so the gates accept many of them.
    k = na // 2
    lb[:k] = la[:k]
    flips = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32) & np.uint32(7)
    da[:k] = db[:k] ^ flips
    va, vb = rng.random(na) > 0.05, rng.random(nb) > 0.05
    args = (xy_a, la, da, va, xy_b, lb, db, vb)
    ref = jm.search_by_projection(*[jnp.asarray(a) for a in args],
                                  radius=jnp.asarray(r), ratio=0.8)
    out = tm.search_by_projection(*[t(a) for a in args], radius=t(r),
                                  ratio=0.8)
    assert (n(ref[0]) >= 0).sum() > 10
    np.testing.assert_array_equal(n(out[0]), n(ref[0]))
    np.testing.assert_array_equal(n(out[1]), n(ref[1]))


def test_mutual_filter_exact(rng):
    m = 40
    best = rng.integers(0, 60, 300).astype(np.int32)
    best_j = rng.integers(0, m, 300).astype(np.int32)
    accept = rng.random(300) > 0.3
    ref = jm.mutual_filter_from_best(jnp.asarray(best), jnp.asarray(best_j),
                                     jnp.asarray(accept), m)
    out = tm.mutual_filter_from_best(t(best), t(best_j), t(accept), m)
    np.testing.assert_array_equal(n(out), n(ref))
    # The same filter on a full distance matrix whose best_j entries hold
    # the best distances.
    dist = rng.integers(0, 300, (300, m)).astype(np.int32)
    dist[np.arange(300), best_j] = best
    ref = jm.mutual_filter(jnp.asarray(dist), jnp.asarray(best_j),
                           jnp.asarray(accept))
    out = tm.mutual_filter(t(dist), t(best_j), t(accept))
    np.testing.assert_array_equal(n(out), n(ref))


def _angles(rng, na, nb, best_j):
    """Angles whose differences crowd a few histogram bins (as a real
    rotation does), with the rest spread, and some exactly on a bin edge
    (k * 2 pi / 30), where the float32 rounding decides the bin."""
    angle_b = rng.uniform(-np.pi, np.pi, nb).astype(np.float32)
    rot = np.where(rng.random(na) < 0.6, rng.normal(0.4, 0.05, na),
                   rng.uniform(-np.pi, np.pi, na))
    edge = rng.random(na) < 0.1
    rot[edge] = rng.integers(-15, 15, edge.sum()) * (2 * np.pi / 30) + 0.5 * (
        2 * np.pi / 30)
    angle_a = (angle_b[best_j] + rot).astype(np.float32)
    return angle_a, angle_b


@pytest.mark.parametrize("spread", ["peaked", "flat", "empty"])
def test_rotation_consistency_exact(rng, spread):
    na, nb = 500, 300
    best_j = rng.integers(0, nb, na).astype(np.int32)
    angle_a, angle_b = _angles(rng, na, nb, best_j)
    if spread == "flat":
        angle_a = rng.uniform(-4, 4, na).astype(np.float32)
    accept = rng.random(na) < (0.0 if spread == "empty" else 0.8)
    ref = jm.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b),
                                  jnp.asarray(best_j), jnp.asarray(accept))
    out = tm.rotation_consistency(t(angle_a), t(angle_b), t(best_j),
                                  t(accept))
    np.testing.assert_array_equal(n(out), n(ref))
    mj = np.where(accept, best_j, -1).astype(np.int32)
    ref = jm.apply_rotation_filter(jnp.asarray(mj), jnp.asarray(angle_a),
                                   jnp.asarray(angle_b))
    out = tm.apply_rotation_filter(t(mj), t(angle_a), t(angle_b))
    np.testing.assert_array_equal(n(out), n(ref))


def test_top_k_lowest_first_ties(rng):
    x = rng.integers(0, 4, 4096).astype(np.int32)      # heavy ties
    for k in (1, 3, 100, 4096):
        vals, idx = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tm.top_k_lowest_first(t(x), k)
        np.testing.assert_array_equal(n(tv), n(vals))
        np.testing.assert_array_equal(n(ti), n(idx))


@pytest.mark.parametrize("gate", ["none", "angles", "pair_mask"])
def test_match_exact(rng, gate):
    """``match`` with duplicate columns (ties) against the JAX package:
    without a pair mask the port takes K2's none mode (its plain version
    here), angles included."""
    na, nb = 400, 300
    da, db = _desc_with_ties(rng, na, nb)
    # Near-copies of columns without a twin, so that the TH_LOW and ratio
    # gates pass for many rows.
    uniq = np.arange(nb // 2 + 1, nb, 2)
    db[uniq] = rng.integers(0, 2 ** 32, (len(uniq), 8), dtype=np.uint32)
    k = na // 2
    da[:k] = db[rng.choice(uniq, k)] ^ (
        rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32) & np.uint32(3))
    va, vb = rng.random(na) > 0.05, rng.random(nb) > 0.05
    kw = dict(max_dist=jm.TH_LOW, ratio=0.7)
    jkw, tkw = dict(kw), dict(kw)
    if gate == "angles":
        best_j = n(jm.best_two(jm.masked_hamming(da, db, va, vb))[2])
        angle_a, angle_b = _angles(rng, na, nb, best_j)
        jkw["angles"] = (jnp.asarray(angle_a), jnp.asarray(angle_b))
        tkw["angles"] = (t(angle_a), t(angle_b))
    elif gate == "pair_mask":
        pm = rng.random((na, nb)) < 0.5
        jkw["pair_mask"], tkw["pair_mask"] = jnp.asarray(pm), t(pm)
    ref = jm.match(da, db, jnp.asarray(va), jnp.asarray(vb), **jkw)
    before = cuda_match.KERNEL.launches
    out = tm.match(t(da), t(db), t(va), t(vb), **tkw)
    assert cuda_match.KERNEL.launches == before     # CPU: the plain version
    assert (n(ref[0]) >= 0).sum() > 20
    np.testing.assert_array_equal(n(out[0]), n(ref[0]))
    np.testing.assert_array_equal(n(out[1]), n(ref[1]))


@pytest.mark.parametrize("radius", ["scalar", "per_row"])
def test_match_window_exact(rng, radius):
    na, nb = 300, 260
    da, db = _desc_with_ties(rng, na, nb)
    xy_a, xy_b, la, lb, r = _window_inputs(rng, na, nb)
    k = na // 2
    da[:k] = db[:k] ^ (rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32)
                       & np.uint32(1))
    va, vb = rng.random(na) > 0.05, rng.random(nb) > 0.05
    rad = 40.0 if radius == "scalar" else r
    args = (da, db, va, vb, xy_a, xy_b)
    ref = jm.match_window(*[jnp.asarray(a) for a in args], rad,
                          jnp.asarray(la), jnp.asarray(lb),
                          level_window=(-2, 2), max_dist=jm.TH_LOW, ratio=0.9)
    out = tm.match_window(*[t(a) for a in args],
                          rad if radius == "scalar" else t(rad), t(la), t(lb),
                          level_window=(-2, 2), max_dist=tm.TH_LOW, ratio=0.9)
    assert (n(ref[0]) >= 0).sum() > 10
    np.testing.assert_array_equal(n(out[0]), n(ref[0]))
    np.testing.assert_array_equal(n(out[1]), n(ref[1]))


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_k2_plain_row_blocks_bit_identical(rng, mode):
    """The plain version takes rows in blocks (so the fusion search's 65536
    rows need no (N, M) int64 temporaries): any block size gives the same
    bits as one block of all rows."""
    na, nb = 181, 96
    da, db = _desc_with_ties(rng, na, nb)
    va, vb = rng.random(na) > 0.1, rng.random(nb) > 0.1
    gates = {}
    if mode == "window":
        xy_a, xy_b, la, lb, radius = _window_inputs(rng, na, nb)
        gates = dict(xy_a=t(xy_a), xy_b=t(xy_b), radius=t(radius),
                     level_a=t(la), level_b=t(lb), level_window=(-1, 1))
    elif mode == "epipolar":
        lines, xy_b, th = _epipolar_inputs(rng, na, nb)
        gates = dict(lines=t(lines), xy_b=t(xy_b), line_th=t(th))
    args = (t(da), t(db), t(va), t(vb))
    whole = cuda_match.hamming_best2_plain(*args, chunk_rows=na, **gates)
    for rows in (1, 7, 64, 180):
        part = cuda_match.hamming_best2_plain(*args, chunk_rows=rows, **gates)
        for a, b in zip(part, whole):
            assert torch.equal(a, b)
    for rows in (1, 13):
        assert torch.equal(tm.hamming_matrix(t(da), t(db), chunk_rows=rows),
                           tm.hamming_matrix(t(da), t(db), chunk_rows=na))
    assert tm.chunk_rows_for(1200) * 1200 <= tm.CHUNK_PAIRS
