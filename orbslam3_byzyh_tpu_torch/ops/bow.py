"""Binary bag-of-words place recognition.

Port of ``orbslam3_byzyh_tpu/ops/bow.py`` (DBoW2's ``TemplatedVocabulary``
k-ary tree, ``transform`` and the L1 score). The vocabulary is an
array-encoded k-ary tree on a device: node descriptors (n_nodes, 8) int32
words holding the JAX package's uint32 bits, children (n_nodes, k) int32
(-1 none), and each leaf's word id. ``transform`` descends the tree at a
fixed depth, one Hamming argmin over a node's k children a level (the
lowest child on ties, as ``jnp.argmin``); image signatures are dense,
L1-normalised tf-idf vectors (n_words,), scored against a database of
them in one pass.

``train_vocabulary`` is the JAX package's numpy training (hierarchical
binary k-means with bit-majority centroids), kept here as the port's own
copy; it calls :func:`transform` for the idf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .matching import popcount32


class Vocabulary(NamedTuple):
    node_desc: torch.Tensor  # (n_nodes, 8) int32 words
    children: torch.Tensor   # (n_nodes, k) int32, -1 = none
    word_id: torch.Tensor    # (n_nodes,) int32: leaf -> word index, else -1
    idf: torch.Tensor        # (n_words,) float32
    k: int
    depth: int
    n_words: int


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8) x (..., 8) int32 words -> (...) int32 popcount distance."""
    return popcount32(a ^ b).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Training: binary k-means with bit-majority centroids (numpy)
# ---------------------------------------------------------------------------

def _bit_majority(descs: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted per-bit majority of (N, 8) uint32 -> (8,) uint32
    (FORB::meanValue)."""
    n = len(descs)
    acc = np.zeros(256, np.float64)
    chunk = 262144
    for i in range(0, n, chunk):
        bits = np.unpackbits(descs[i:i + chunk].view(np.uint8), axis=-1,
                             bitorder="little")          # (n', 256) uint8
        acc += bits.astype(np.float64).T @ weights[i:i + chunk]
    mean = acc / max(weights.sum(), 1e-9)
    out_bits = (mean > 0.5).astype(np.uint8)
    return np.packbits(out_bits, bitorder="little").view(np.uint32)


_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=-1).sum(-1).astype(np.uint8)


def _np_hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Na, 8) x (Nb, 8) -> (Na, Nb) Hamming, in blocks of rows with a
    byte-popcount table."""
    n = len(a)
    chunk = max(1, int(4e6 / max(len(b), 1)))
    if n <= chunk:
        x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
        return _POPCOUNT8[x].sum(-1, dtype=np.int32)
    out = np.empty((n, len(b)), np.int32)
    for i in range(0, n, chunk):
        x = (a[i:i + chunk, None, :] ^ b[None, :, :]).view(np.uint8)
        out[i:i + chunk] = _POPCOUNT8[x].sum(-1, dtype=np.int32)
    return out


def _kmeans_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means. Returns (centers (k', 8), assignment (N,))."""
    n = len(descs)
    k = min(k, n)
    sel = rng.choice(n, k, replace=False)
    centers = descs[sel].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _np_hamming_matrix(descs, centers)
        assign = d.argmin(-1)
        new_centers = []
        for c in range(len(centers)):
            members = descs[assign == c]
            if len(members) == 0:
                continue
            new_centers.append(_bit_majority(members, np.ones(len(members))))
        centers = np.stack(new_centers)
        if len(centers) <= 1:
            break
    d = _np_hamming_matrix(descs, centers)
    assign = d.argmin(-1)
    return centers, assign


def _vocabulary(node_desc, children, word_id, idf, k, depth, n_words,
                device) -> Vocabulary:
    """A :class:`Vocabulary` on ``device`` from numpy arrays (uint32 node
    words become int32 bits)."""
    def up(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return Vocabulary(up(node_desc), up(children.astype(np.int32)),
                      up(word_id.astype(np.int32)),
                      up(idf.astype(np.float32)), int(k), int(depth),
                      int(n_words))


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4,
                     seed: int = 0, doc_ids: np.ndarray | None = None,
                     device=None) -> Vocabulary:
    """Hierarchical binary k-means (TemplatedVocabulary::create).

    descriptors: (N, 8) uint32 training corpus. doc_ids: optional (N,)
    image ids for the idf (uniform without them). The tree is built in
    numpy; the vocabulary goes to ``device`` (``None``: the card)."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(8, np.uint32)]   # root placeholder
    children: list = [[]]

    def build(node_id, descs, level):
        if level == depth or len(descs) < k:
            return
        centers, assign = _kmeans_binary(descs, k, rng)
        for c in range(len(centers)):
            cid = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            children[node_id].append(cid)
            build(cid, descs[assign == c], level + 1)

    build(0, descriptors, 0)

    n_nodes = len(node_desc)
    child_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_arr[i, :len(ch)] = ch
    word_id = np.full(n_nodes, -1, np.int32)
    w = 0
    for i in range(n_nodes):
        if children[i] == [] and i != 0:
            word_id[i] = w
            w += 1
    n_words = w

    voc = _vocabulary(np.stack(node_desc), child_arr, word_id,
                      np.ones(max(n_words, 1), np.float32), k, depth,
                      n_words, dev)
    if doc_ids is not None and n_words > 0:
        desc = torch.from_numpy(
            np.ascontiguousarray(descriptors).view(np.int32)).to(dev)
        words = transform(voc, desc, torch.ones(len(descriptors),
                                                dtype=torch.bool,
                                                device=dev)).cpu().numpy()
        n_docs = int(doc_ids.max()) + 1
        df = np.zeros(n_words, np.float64)
        for d in range(n_docs):
            ws = np.unique(words[doc_ids == d])
            ws = ws[ws >= 0]
            df[ws] += 1
        idf = np.log(n_docs / np.maximum(df, 1.0))
        voc = voc._replace(idf=torch.from_numpy(idf.astype(np.float32))
                           .to(dev))
    return voc


def to_device(voc: Vocabulary, device) -> Vocabulary:
    """``voc``'s tensors on ``device`` (no copy where they are already
    there). Raises unless ``voc`` is this package's :class:`Vocabulary`
    (``convert.vocabulary_to_torch`` carries the JAX package's across)."""
    if not isinstance(voc, Vocabulary):
        raise TypeError(
            f"a vocabulary must be an ops.bow.Vocabulary, got "
            f"{type(voc).__name__}; load one with bow.load_vocabulary or "
            "carry one across with convert.vocabulary_to_torch")
    dev = device_mod.resolve(device)
    return voc._replace(node_desc=voc.node_desc.to(dev),
                        children=voc.children.to(dev),
                        word_id=voc.word_id.to(dev), idf=voc.idf.to(dev))


def save_vocabulary(path: str, voc: Vocabulary):
    """Write ``voc`` in the JAX package's npz layout (node words uint32)."""
    np.savez_compressed(
        path,
        node_desc=voc.node_desc.cpu().numpy().astype(np.int32).view(np.uint32),
        children=voc.children.cpu().numpy(), word_id=voc.word_id.cpu().numpy(),
        idf=voc.idf.cpu().numpy(),
        meta=np.array([voc.k, voc.depth, voc.n_words], np.int64))


def load_vocabulary(path, device=None) -> Vocabulary:
    """A vocabulary npz (``vocabulary/*.npz``, :func:`save_vocabulary`) on
    ``device`` (``None``: the card; raises without one)."""
    dev = device_mod.resolve(device)
    with np.load(path) as z:
        k, depth, n_words = [int(x) for x in z["meta"]]
        return _vocabulary(z["node_desc"], z["children"], z["word_id"],
                           z["idf"], k, depth, n_words, dev)


# ---------------------------------------------------------------------------
# Transform and scoring
# ---------------------------------------------------------------------------

def transform(voc: Vocabulary, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Descriptors (N, 8) int32 words -> word ids (N,) int32, -1 where not
    ``valid``. At each of ``depth`` levels the descriptor moves to its
    nearest child (the lowest child on ties, by a (distance, child) key);
    a leaf keeps it."""
    n, k = desc.shape[0], voc.k
    dev = desc.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    col = torch.arange(k, device=dev)
    for _ in range(voc.depth):
        ch = voc.children[node]                                # (N, k)
        has_child = ch >= 0
        ch_safe = ch.clamp_min(0).long()
        d = _hamming(voc.node_desc[ch_safe], desc[:, None, :])
        d = torch.where(has_child, d, 1 << 20).to(torch.int64)
        best = (d * k + col).amin(-1) % k
        nxt = ch_safe.gather(1, best[:, None])[:, 0]
        node = torch.where(has_child.any(-1), nxt, node)
    return torch.where(valid, voc.word_id[node], -1)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """Word ids (N,) -> the L1-normalised tf-idf dense vector (n_words,):
    one ``index_add_`` of ones into n_words + 1 bins (the last takes the
    invalid keypoints; counts of 1.0 are exact in float32). Batched: word
    ids (B, N) -> (B, n_words), one ``index_add_`` for the batch."""
    W = voc.n_words
    w_safe = torch.where(words >= 0, words, W).long()
    lead = w_safe.shape[:-1]
    rows = torch.arange(w_safe[..., 0].numel(), device=words.device)
    flat = (rows.reshape(lead + (1,)) * (W + 1) + w_safe).reshape(-1)
    counts = torch.zeros(rows.numel() * (W + 1), dtype=torch.float32,
                         device=words.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    v = counts.reshape(lead + (W + 1,))[..., :W] * voc.idf
    return v / v.abs().sum(-1, keepdim=True).clamp_min(1e-9)


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 score in [0, 1] of L1-normalised vectors, s = 1 - 0.5 *
    sum |a - b| (``b`` may be batched: (..., W))."""
    return 1.0 - 0.5 * (a - b).abs().sum(-1)


def score_against_database(query_vec: torch.Tensor, db_vecs: torch.Tensor,
                           db_valid: torch.Tensor) -> torch.Tensor:
    """(W,) against (K, W) -> (K,) L1 scores; invalid rows get -1."""
    return torch.where(db_valid, l1_score(query_vec, db_vecs), -1.0)
