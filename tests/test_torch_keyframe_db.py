"""Port parity: the covisibility matrix and the keyframe database
(``map_state.covisibility_matrix``, ``pipeline/keyframe_db.py``) against
the JAX package's.

The covisibility counts are integers and must be equal: on a map at the
EuRoC-mono capacity (``graft.euroc_mono_map``: 1024 keyframe / 65536
landmark slots, 12 observations, 200 live keyframes; the port scatters
L x O x O cells where the JAX function multiplies a 65536 x 1025 one-hot
indicator by itself) and on a small map with repeated and dead
observations. The database holds 12 golden frames' keypoints (the port's
extraction, ``tests/golden/frames_golden_mono.npz`` at the golden config,
1536 features) under the runners' 10k-word vocabulary. Words, ids and the
shared-word counts must be equal; vectors and scores within 1e-6 (float32
sums in another order). Where two candidates' accumulated scores lie
within 1e-6 of each other their order could flip between the packages;
such pairs are printed with their gap.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_map_state, n, t

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.pipeline import keyframe_db as jkdb
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.ops import bow as tbow
from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db as tkdb

MAX_KF, N_FEAT = 16, 1536
FRAMES = tuple(range(0, 24, 2))          # 12 keyframes


def test_covisibility_at_euroc_capacity():
    m = graft.euroc_mono_map()
    want = np.asarray(jms.covisibility_matrix(jax_map_state(m.state)))
    got = n(tms.covisibility_matrix(convert.map_state_to_torch(m.state,
                                                               "cpu")))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1024, 1024) and (got > 0).sum() > 1000
    assert (np.diag(got) == 0).all() and (got == got.T).all()


def test_covisibility_repeated_and_dead_observations():
    """A keyframe that sees a landmark in two observation slots counts once;
    dead observations, dead landmarks and empty slots count nothing."""
    rng = np.random.default_rng(4)
    st = graft.euroc_mono_map(graft.MonoConfig(max_kf=32, max_lm=512),
                              n_live_kf=24, view_points=120).state
    kf = st.obs.kf.copy()
    rows = rng.choice(np.flatnonzero(st.lms.valid), 60, replace=False)
    kf[rows, 5] = kf[rows, 0]                     # repeats
    valid = st.obs.valid.copy()
    valid[rows, 5] = True
    valid[rng.choice(len(valid), 40), 1] = False  # dead observations
    lvalid = st.lms.valid.copy()
    lvalid[rng.choice(len(lvalid), 30)] = False   # dead landmarks
    st = st._replace(obs=st.obs._replace(kf=kf, valid=valid),
                     lms=st.lms._replace(valid=lvalid))
    want = np.asarray(jms.covisibility_matrix(jax_map_state(st)))
    got = n(tms.covisibility_matrix(convert.map_state_to_torch(st, "cpu")))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 50


@functools.cache
def _frames():
    """The 12 keyframes' (desc uint32, valid) from the port's extraction,
    and one query frame's."""
    g = graft.golden_frames()
    cfg = graft.mono_slam_config(graft.golden_slam_config())
    cam = torch.tensor([400.0, 400.0, 320.0, 240.0])
    out = []
    for k in FRAMES + (13,):
        f = graft.mono_extract(torch.from_numpy(g.frames[k]).float(), cam,
                               None, cfg)
        out.append((convert.desc_to_uint32(f.desc), n(f.valid)))
    return out


@functools.cache
def _vocabularies():
    return (jbow.load_vocabulary(str(graft.RELOC_VOCABULARY)),
            tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu"))


def _dbs():
    jv, tv = _vocabularies()
    jdb = jkdb.KeyframeDatabase(jv, MAX_KF, N_FEAT)
    tdb = tkdb.KeyframeDatabase(tv, MAX_KF, N_FEAT)
    for k, (d, v) in enumerate(_frames()[:-1]):
        jdb.add(k, jnp.asarray(d), jnp.asarray(v))
        tdb.add(k, t(d), t(v))
    return jdb, tdb


def _same_db(jdb, tdb):
    np.testing.assert_array_equal(n(tdb.valid), np.asarray(jdb.valid))
    np.testing.assert_array_equal(n(tdb.words), np.asarray(jdb.words))
    np.testing.assert_allclose(n(tdb.vecs), np.asarray(jdb.vecs), atol=1e-6)


def _close_pairs(scores, what):
    """Print the candidates whose scores lie within 1e-6 of another's."""
    s = np.sort(np.asarray(scores, np.float64)[np.asarray(scores) > 1e-6])
    gaps = np.diff(s)
    for i in np.flatnonzero(gaps < 1e-6):
        print(f"{what}: scores {s[i]:.9f} and {s[i + 1]:.9f} within "
              f"{gaps[i]:.1e}; their order may flip")


def test_add_and_remap():
    jdb, tdb = _dbs()
    _same_db(jdb, tdb)
    assert int(n(tdb.valid).sum()) == len(FRAMES)
    old2new = np.full(MAX_KF, -1, np.int64)
    live = [0, 1, 3, 4, 6, 7, 8, 11]
    old2new[live] = np.arange(len(live))
    jdb.remap(old2new, len(live))
    tdb.remap(old2new, len(live))
    _same_db(jdb, tdb)
    assert int(n(tdb.valid).sum()) == len(live)


@pytest.mark.parametrize("exclude", [None, "even"])
def test_query_matches_jax(exclude):
    jdb, tdb = _dbs()
    d, v = _frames()[-1]
    ex = None if exclude is None else np.arange(MAX_KF) % 2 == 0
    jid, js, jw = jdb.query(jnp.asarray(d), jnp.asarray(v), exclude=ex,
                            top_n=5)
    tid, ts, tw = tdb.query(t(d), t(v), exclude=ex, top_n=5)
    np.testing.assert_array_equal(n(tw), np.asarray(jw))
    _close_pairs(js, "query")
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)
    assert (tid[:3] >= 0).all()
    if ex is not None:
        assert not ex[tid[tid >= 0]].any()


def _covis(kind):
    """(MAX_KF, MAX_KF) shared-landmark counts: a chain of neighbours, or
    a matrix of few distinct counts (ties everywhere)."""
    rng = np.random.default_rng(11)
    if kind == "chain":
        c = np.zeros((MAX_KF, MAX_KF), np.int32)
        for k in range(len(FRAMES)):
            for j in range(max(0, k - 3), min(len(FRAMES), k + 4)):
                if j != k:
                    c[k, j] = 60 - 12 * abs(j - k)
        return c
    c = rng.choice(np.array([0, 0, 15, 15, 15, 40], np.int32),
                   (MAX_KF, MAX_KF))
    c = np.triu(c, 1)
    return c + c.T


@pytest.mark.parametrize("covis", ["chain", "tied"])
@pytest.mark.parametrize("n_covisibles", [3, 10])
def test_query_groups_matches_jax(covis, n_covisibles):
    jdb, tdb = _dbs()
    d, v = _frames()[-1]
    c = _covis(covis)
    jid, js, jw = jdb.query_groups(jnp.asarray(d), jnp.asarray(v),
                                   jnp.asarray(c), top_n=3,
                                   n_covisibles=n_covisibles)
    tid, ts, tw = tdb.query_groups(t(d), t(v), t(c), top_n=3,
                                   n_covisibles=n_covisibles)
    np.testing.assert_array_equal(n(tw), np.asarray(jw))
    _close_pairs(js, f"query_groups {covis} {n_covisibles}")
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)
    assert tid[0] >= 0
    # The JAX caller's liveness check, folded into the one read: a dead
    # candidate comes back as -1 in its place.
    kf_valid = torch.ones(MAX_KF, dtype=torch.bool)
    kf_valid[int(tid[0])] = False
    tid2, _, _ = tdb.query_groups(t(d), t(v), t(c), top_n=3,
                                  n_covisibles=n_covisibles,
                                  kf_valid=kf_valid)
    np.testing.assert_array_equal(tid2, np.where(tid == tid[0], -1, tid))


def test_shared_words_and_pair_mask():
    """The distinct shared-word counts (a column gather in the port) equal
    the JAX package's mask product, and SearchByBoW's pair mask."""
    jdb, tdb = _dbs()
    d, v = _frames()[-1]
    jv, tv = _vocabularies()
    jw = jbow.transform(jv, jnp.asarray(d), jnp.asarray(v))
    qv = jbow.bow_vector(jv, jw)
    want = np.asarray(((jdb.vecs > 0).astype(jnp.float32)
                       @ (qv > 0).astype(jnp.float32)))
    tw = tbow.transform(tv, t(d), t(v))
    got = n(tdb.shared_words(tw, tbow.bow_vector(tv, tw)))
    np.testing.assert_array_equal(got, want)
    assert got.max() > 100
    for k in (0, 5):
        np.testing.assert_array_equal(n(tdb.word_pair_mask(tw, k)),
                                      np.asarray(jdb.word_pair_mask(jw, k)))
