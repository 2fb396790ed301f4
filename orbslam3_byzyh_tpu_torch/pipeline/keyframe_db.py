"""Keyframe database: BoW signatures and relocalisation / loop candidates.

Port of ``orbslam3_byzyh_tpu/pipeline/keyframe_db.py`` (ORB-SLAM3's
``KeyFrameDatabase``): the word -> keyframe inverted file becomes a dense
(K, W) tf-idf matrix on the device, scored against a query in one pass.
``word_pair_mask`` is SearchByBoW's bucket gate (keypoints in the same
word).

Tie order follows the JAX package: ``jax.lax.top_k`` puts the lower index
first among equal values (a stable descending sort here, or
``matching.top_k_lowest_first`` for integers) and ``jnp.argmax`` takes the
first maximum. Each query reads the device once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..models import map_state as ms
from ..ops import bow, matching


# Keyframes one ``add_range`` transform takes at a time: 128 x 1536
# keypoints at depth 4 of k = 10 gather about 63 MB of child words a level.
ADD_RANGE_CHUNK = 128


def _top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` of a 1-D float tensor: the k largest in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class KeyframeDatabase:
    """Per-keyframe BoW data of one map, on the vocabulary's device."""

    def __init__(self, voc: bow.Vocabulary, max_kf: int, n_feat: int):
        self.voc = voc
        dev = voc.idf.device
        self.vecs = torch.zeros((max_kf, voc.n_words), device=dev)
        self.words = torch.full((max_kf, n_feat), -1, dtype=torch.int32,
                                device=dev)
        self.valid = torch.zeros(max_kf, dtype=torch.bool, device=dev)

    def add(self, kf_id, desc: torch.Tensor, kp_valid: torch.Tensor):
        """Store keyframe ``kf_id``'s words and vector, in place (a
        Python int or a 0-d tensor; no host read)."""
        words = bow.transform(self.voc, desc, kp_valid)
        vec = bow.bow_vector(self.voc, words)
        row = ms.slot_index(kf_id, self.vecs.device)
        self.vecs.index_copy_(0, row, vec[None])
        self.words.index_copy_(0, row, words[None])
        self.valid.index_fill_(0, row, True)

    def add_range(self, lo: int, desc: torch.Tensor, kp_valid: torch.Tensor):
        """Store keyframes ``lo, lo + 1, ...``: ``desc`` (n, N, 8) and
        ``kp_valid`` (n, N) are their keypoints, in place; the same rows as
        ``add`` of each in turn, ``ADD_RANGE_CHUNK`` keyframes a transform
        (no host read)."""
        chunk = ADD_RANGE_CHUNK
        for a in range(0, desc.shape[0], chunk):
            d, v = desc[a:a + chunk], kp_valid[a:a + chunk]
            n = d.shape[0]
            words = bow.transform(self.voc, d.reshape(-1, 8),
                                  v.reshape(-1)).reshape(n, -1)
            rows = slice(lo + a, lo + a + n)
            self.vecs[rows].copy_(bow.bow_vector(self.voc, words))
            self.words[rows].copy_(words)
            self.valid[rows].fill_(True)

    def remap(self, old2new: np.ndarray, n_valid: int):
        """Keyframe slots were compacted (``map_state.compact_keyframes``):
        gather the rows into their new slots and clear the rest."""
        max_kf = self.valid.shape[0]
        old_of_new = np.zeros(max_kf, np.int64)
        live = np.flatnonzero(old2new >= 0)
        old_of_new[old2new[live]] = live
        g = device_mod.upload(old_of_new, self.vecs.device)
        keep = torch.arange(max_kf, device=g.device) < n_valid
        self.vecs = torch.where(keep[:, None], self.vecs[g], 0.0)
        self.words = torch.where(keep[:, None], self.words[g], -1)
        self.valid = self.valid[g] & keep

    def _query_vector(self, desc, kp_valid, exclude):
        words = bow.transform(self.voc, desc, kp_valid)
        qv = bow.bow_vector(self.voc, words)
        valid = self.valid
        if isinstance(exclude, torch.Tensor):
            valid = valid & ~exclude
        elif exclude is not None:
            valid = valid & ~device_mod.upload(np.asarray(exclude, bool),
                                               valid.device)
        return words, qv, valid

    def query(self, desc: torch.Tensor, kp_valid: torch.Tensor,
              exclude: np.ndarray | None = None, top_n: int = 3,
              min_score: float = 0.0):
        """Top-N keyframes by L1 BoW score. ``exclude``: a (K,) bool mask
        of keyframes to skip (numpy, or a tensor on the database's
        device). Returns (ids (top_n,), scores (top_n,)) as
        numpy (id -1: none) and the query's words (device)."""
        words, qv, valid = self._query_vector(desc, kp_valid, exclude)
        scores = bow.score_against_database(qv, self.vecs, valid)
        top_s, top_i = _top_k_stable(scores, top_n)
        top_s, top_i = device_mod.read(top_s, top_i, dtype=torch.float64)
        ids = np.where(top_s >= max(min_score, 1e-6), top_i, -1).astype(
            np.int64)
        return ids, top_s.astype(np.float32), words

    def shared_words(self, words: torch.Tensor,
                     qv: torch.Tensor) -> torch.Tensor:
        """(K,) float32: the query's distinct words with a nonzero weight
        that each keyframe's vector also holds (the JAX package's
        ``(vecs > 0) @ (qv > 0)``, as a gather of the query's own columns:
        at 92,613 words the mask would be another (K, W) matrix a query)."""
        n = words.shape[0]
        dev = words.device
        w_safe = torch.where(words >= 0, words, self.voc.n_words).long()
        first = torch.full((self.voc.n_words + 1,), n, dtype=torch.int64,
                           device=dev)
        first.scatter_reduce_(0, w_safe, torch.arange(n, device=dev),
                              reduce="amin")
        distinct = ((words >= 0) & (first[w_safe] == torch.arange(
            n, device=dev)))
        distinct = distinct & (qv[w_safe.clamp_max(self.voc.n_words - 1)]
                               > 0)
        cols = self.vecs[:, w_safe.clamp_max(self.voc.n_words - 1)] > 0
        return (cols & distinct[None, :]).sum(-1).to(torch.float32)

    def query_groups(self, desc: torch.Tensor, kp_valid: torch.Tensor,
                     covis: torch.Tensor, exclude: np.ndarray | None = None,
                     top_n: int = 3, n_covisibles: int = 10,
                     kf_valid: torch.Tensor | None = None):
        """Covisibility-group candidate scoring (DetectNBestCandidates):

          1. the distinct shared words per keyframe, gated at > 0.8 x the
             most any keyframe shares;
          2. the L1 score of the keyframes that pass;
          3. each keyframe's group score: its own plus its
             ``n_covisibles`` best covisible neighbours'; each group
             reports its best-scoring member;
          4. the top-N groups, deduplicated by best member on the host.

        ``covis``: (K, K) shared-landmark counts
        (``map_state.covisibility_matrix``). ``kf_valid``: the map's (K,)
        keyframe liveness; when given, a candidate whose keyframe is dead
        comes back as -1 (the check the JAX caller makes with a read of
        its own), read with the rest. Returns (ids, accumulated scores) as
        numpy and the query's words; the device is read once."""
        words, qv, valid = self._query_vector(desc, kp_valid, exclude)
        common = self.shared_words(words, qv)
        max_common = torch.where(valid, common, 0.0).max()
        pass_gate = valid & (common > 0.8 * max_common) & (common > 0)

        scores = bow.score_against_database(qv, self.vecs, valid)
        s_g = torch.where(pass_gate, scores, 0.0)

        # Group accumulation over each keyframe's best covisible
        # neighbours (s_g is already zero off the gate).
        K = covis.shape[0]
        cv, ci = matching.top_k_lowest_first(covis, n_covisibles)
        nb_scores = torch.where(cv > 0, s_g[ci], 0.0)
        acc = torch.where(pass_gate, s_g + nb_scores.sum(-1), 0.0)
        member_scores = torch.cat([s_g[:, None], nb_scores], -1)
        member_ids = torch.cat(
            [torch.arange(K, device=ci.device)[:, None], ci], -1)
        best = member_ids.gather(
            1, torch.argmax(member_scores, -1, keepdim=True))[:, 0]

        k = min(top_n * 3, K)                  # headroom for the dedup
        top_acc, top_group = _top_k_stable(acc, k)
        top_best = best[top_group]
        live = (kf_valid[top_best] if kf_valid is not None
                else torch.ones_like(top_best, dtype=torch.bool))
        top_acc, top_best, live = device_mod.read(
            top_acc, top_best, live, dtype=torch.float64)
        ids, out_s, seen = [], [], set()
        for b, s, ok in zip(top_best.astype(np.int64).tolist(),
                            top_acc.tolist(), live.tolist()):
            if s <= 1e-6 or b in seen:
                continue
            seen.add(b)
            ids.append(b if ok else -1)
            out_s.append(s)
            if len(ids) == top_n:
                break
        while len(ids) < top_n:
            ids.append(-1)
            out_s.append(0.0)
        return (np.asarray(ids), np.asarray(out_s, np.float32), words)

    def word_pair_mask(self, words_a: torch.Tensor,
                       kf_id: int) -> torch.Tensor:
        """(Na, Nb) mask: the same vocabulary word (SearchByBoW's gate)."""
        words_b = self.words[kf_id]
        return ((words_a[:, None] == words_b[None, :])
                & (words_a[:, None] >= 0))
