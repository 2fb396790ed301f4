"""Port parity: the BoW vocabulary (``ops/bow.py``) against the JAX
package's.

The vocabularies are the repo's ``vocabulary/synthetic_voc.npz`` (510
words), its ``synthetic_voc_10k.npz`` (9,999 words, k = 10, depth 4) and a
small one trained as ``tests/test_bow.py`` trains one (20 documents of
prototype windows, k = 5, depth 3). Words are compared exactly (the
descent's Hamming argmins are integers, the lowest child on ties in both
packages); vectors and scores within 1e-6 (float32 sums in another order).
The training is numpy in both packages and must build the same tree from
the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import bow as tbow

VOC_SMALL = graft.VOCABULARY_DIR / "synthetic_voc.npz"
VOC_10K = graft.RELOC_VOCABULARY


@pytest.fixture(scope="module")
def corpus():
    """tests/test_bow.py's corpus: 20 documents of 100 descriptors, each
    drawn from its own window of 25 of 200 prototypes with 6 bit flips."""
    rng = np.random.default_rng(7)
    protos = rng.integers(0, 2**32, (200, 8), dtype=np.uint32)
    descs, doc_ids = [], []
    for d in range(20):
        window = protos[d * 9:d * 9 + 25]
        for _ in range(100):
            p = window[rng.integers(len(window))].copy()
            for _ in range(6):
                w = rng.integers(8)
                p[w] ^= np.uint32(1) << np.uint32(rng.integers(32))
            descs.append(p)
            doc_ids.append(d)
    return np.stack(descs), np.asarray(doc_ids)


@pytest.fixture(scope="module")
def trained(corpus):
    descs, doc_ids = corpus
    return (jbow.train_vocabulary(descs, k=5, depth=3, doc_ids=doc_ids),
            tbow.train_vocabulary(descs, k=5, depth=3, doc_ids=doc_ids,
                                  device="cpu"))


def _queries(corpus, seed=0, m=600):
    """Corpus descriptors, random words, and corpus rows with 1-20 bit
    flips, with every tenth row invalid."""
    descs, _ = corpus
    rng = np.random.default_rng(seed)
    noisy = descs[rng.integers(len(descs), size=m // 3)].copy()
    for row in noisy:
        for _ in range(rng.integers(1, 21)):
            row[rng.integers(8)] ^= np.uint32(1) << np.uint32(
                rng.integers(32))
    q = np.concatenate([descs[:m // 3],
                        rng.integers(0, 2**32, (m - 2 * (m // 3), 8),
                                     dtype=np.uint32), noisy])
    valid = np.arange(len(q)) % 10 != 3
    return q, valid


def _same_words(jv, tv, q, valid):
    want = np.asarray(jbow.transform(jv, jnp.asarray(q), jnp.asarray(valid)))
    got = n(tbow.transform(tv, t(q), t(valid)))
    np.testing.assert_array_equal(got, want)
    return want


def test_training_builds_the_same_tree(trained):
    jv, tv = trained
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    assert tv.n_words > 20
    np.testing.assert_array_equal(convert.desc_to_uint32(tv.node_desc),
                                  np.asarray(jv.node_desc))
    for name in ("children", "word_id"):
        np.testing.assert_array_equal(n(getattr(tv, name)),
                                      np.asarray(getattr(jv, name)))
    # The idf comes from each package's own transform of the corpus.
    np.testing.assert_allclose(n(tv.idf), np.asarray(jv.idf), atol=1e-6)


@pytest.mark.parametrize("which", ["synthetic_voc", "trained", "10k"])
def test_transform_words_equal(which, trained, corpus):
    if which == "trained":
        jv, tv = trained
    else:
        path = VOC_SMALL if which == "synthetic_voc" else VOC_10K
        jv, tv = (jbow.load_vocabulary(str(path)),
                  tbow.load_vocabulary(path, device="cpu"))
    q, valid = _queries(corpus)
    words = _same_words(jv, tv, q, valid)
    assert (words[~valid] == -1).all() and (words[valid] >= 0).all()
    assert len(np.unique(words[valid])) > 20


def test_transform_ties_take_the_lowest_child():
    """Children at equal distances: both packages take the first."""
    rng = np.random.default_rng(3)
    k, depth = 4, 2
    node = rng.integers(0, 2**32, (1 + k + k * k, 8), dtype=np.uint32)
    node[2] = node[1]                    # root children 0 and 1 tie
    node[1 + k:1 + 2 * k] = node[1 + k]  # child 0's children all tie
    children = np.full((len(node), k), -1, np.int32)
    children[0] = np.arange(1, k + 1)
    for c in range(k):
        children[1 + c] = 1 + k + c * k + np.arange(k)
    word_id = np.full(len(node), -1, np.int32)
    word_id[1 + k:] = np.arange(k * k)
    idf = np.ones(k * k, np.float32)
    jv = jbow.Vocabulary(jnp.asarray(node), jnp.asarray(children),
                         jnp.asarray(word_id), jnp.asarray(idf), k, depth,
                         k * k)
    tv = convert.vocabulary_to_torch(jv, "cpu")
    q = np.concatenate([node[[1, 2]],
                        rng.integers(0, 2**32, (60, 8), dtype=np.uint32)])
    words = _same_words(jv, tv, q, np.ones(len(q), bool))
    assert words[0] == words[1] == 0


def test_bow_vector_and_scores(trained, corpus):
    jv, tv = trained
    descs, doc_ids = corpus
    vecs = {}
    for d in range(6):
        dd = descs[doc_ids == d]
        valid = np.arange(len(dd)) % 7 != 0
        w = _same_words(jv, tv, dd, valid)
        jvec = np.asarray(jbow.bow_vector(jv, jnp.asarray(w)))
        tvec = n(tbow.bow_vector(tv, t(w)))
        np.testing.assert_allclose(tvec, jvec, atol=1e-6)
        assert abs(tvec.sum() - 1.0) < 1e-5
        vecs[d] = (jvec, tvec)
    empty = np.full(10, -1, np.int32)        # no valid word: all zeros
    np.testing.assert_array_equal(n(tbow.bow_vector(tv, t(empty))),
                                  np.asarray(jbow.bow_vector(
                                      jv, jnp.asarray(empty))))
    jdb = np.stack([vecs[d][0] for d in range(6)])
    tdb = torch.stack([torch.from_numpy(vecs[d][1]) for d in range(6)])
    db_valid = np.array([True, True, False, True, True, True])
    for d in range(6):
        want = np.asarray(jbow.score_against_database(
            jnp.asarray(vecs[d][0]), jnp.asarray(jdb), jnp.asarray(db_valid)))
        got = n(tbow.score_against_database(torch.from_numpy(vecs[d][1]),
                                            tdb, t(db_valid)))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got[2] == -1.0
        np.testing.assert_allclose(
            float(tbow.l1_score(tdb[d], tdb[(d + 1) % 6])),
            float(jbow.l1_score(jnp.asarray(jdb[d]),
                                jnp.asarray(jdb[(d + 1) % 6]))), atol=1e-6)


def test_save_load_round_trip(trained, corpus, tmp_path):
    """The port writes the JAX package's layout and reads it back; each
    package reads the other's file."""
    jv, tv = trained
    q, valid = _queries(corpus, seed=1, m=96)
    p_port, p_jax = tmp_path / "port.npz", str(tmp_path / "jax.npz")
    tbow.save_vocabulary(p_port, tv)
    jbow.save_vocabulary(p_jax, jv)
    want = _same_words(jv, tv, q, valid)
    for voc in (tbow.load_vocabulary(p_port, device="cpu"),
                tbow.load_vocabulary(p_jax, device="cpu")):
        np.testing.assert_array_equal(n(tbow.transform(voc, t(q), t(valid))),
                                      want)
        np.testing.assert_array_equal(n(voc.idf), n(tv.idf))
    jv2 = jbow.load_vocabulary(str(p_port))
    np.testing.assert_array_equal(
        np.asarray(jbow.transform(jv2, jnp.asarray(q), jnp.asarray(valid))),
        want)


def test_vocabulary_device(monkeypatch):
    """``load_vocabulary`` selects the card without a device and raises
    without one; a vocabulary that is not the port's is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbow.load_vocabulary(VOC_SMALL)
    voc = tbow.load_vocabulary(VOC_SMALL, device="cpu")
    assert voc.node_desc.device.type == "cpu" and voc.n_words == 510
    assert tbow.to_device(voc, "cpu").idf is voc.idf
    with pytest.raises(TypeError, match="ops.bow.Vocabulary"):
        tbow.to_device(np.zeros(4), "cpu")
    back = convert.vocabulary_to_numpy(voc)
    with np.load(VOC_SMALL) as z:
        np.testing.assert_array_equal(back["node_desc"], z["node_desc"])
        np.testing.assert_array_equal(back["idf"], z["idf"])
