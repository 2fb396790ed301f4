"""Loop closing: detection, Sim3 verification and correction.

Port of ``orbslam3_byzyh_tpu/pipeline/loop_closing.py`` (ORB-SLAM3's
``LoopClosing``): the per-map keyframe databases with their lifecycle
(``switch_map``, ``reset_active``, ``remap_keyframes``, ``add_keyframe``),
which relocalisation mines too; ``detect``, the BoW candidate mining, the
geometric verification ladder and the temporal streak
(``NewDetectCommonRegions``); and ``close``, the Sim3 propagation, the
essential-graph pose graph and the landmark correction (``CorrectLoop``);
the merge branch, ``detect_merge`` (the same ladder against every other
atlas map's database) and ``on_maps_merged`` (the databases and loop edges
after ``Atlas.merge``).

The ladder runs on the device. The JAX package reads the match, both
keyframes' landmarks, the whole observation table for the window mask and
each stage's count back to the host; here the matched pairs, the keypoint
-> landmark tables and the window mask stay on the device and each
candidate reads three packed values (``HOST_READS``), beside the
database's candidates and the Sim3 RANSAC's two SVDs. The RANSAC's sample
rows come from ``_sim3_indices`` (a hook, as the systems' ``_pnp_indices``
is: parity tests hand it the JAX rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from ..models import map_state as ms
from ..ops import bow, lie, matching, sim3_solve
from ..solver import pose_graph
from ..utils import cuda_graph
from . import tracking
from .keyframe_db import KeyframeDatabase

# The packed reads of one verified candidate, in ladder order: the BoW match
# and its landmark pairs; the Sim3 RANSAC's outcome with the coarse guided
# projection's count; the refinement's inliers, the tight projection's
# count and the Sim3.
HOST_READS = ("bow", "sim3", "refine")

# A refined Sim3 scale this far (a factor either way) from the Sim3
# RANSAC's is taken for a runaway of OptimizeSim3 (see _verify_projective).
SCALE_RUNAWAY = 1.2


@dataclasses.dataclass
class LoopCloserConfig:
    """Verification-ladder gates (DetectCommonRegionsFromBoW,
    LoopClosing.cc:738-742 defaults)."""
    min_bow_matches: int = 20      # nBoWMatches
    min_ransac_inliers: int = 15   # nBoWInliers (Sim3 RANSAC gate)
    min_sim3_inliers: int = 20     # nSim3Inliers (OptimizeSim3 inlier gate)
    min_proj_matches: int = 50     # nProjMatches (coarse guided projection)
    min_proj_opt_matches: int = 80  # nProjOptMatches (refined projection)
    consecutive_needed: int = 3    # temporal verifications (:475)
    max_not_found: int = 2         # silent KFs a streak survives (:497)
    n_covisibles: int = 10         # candidate window size (nNumCovisibles)
    min_kf_gap: int = 10           # don't match recent covisible KFs
    min_map_kfs: int = 12          # guard (LoopClosing.cc:407-430)
    cov_edge_threshold: int = 30   # essential-graph covisibility weight gate
                                   # (reference: 100; smaller synthetic maps)
    fix_scale: bool = False        # SE3 pose graph for stereo/inertial
    opt_rows: int = 512            # static row budget for OptimizeSim3


def _kp_landmarks(state: ms.MapState, kf_id, n_feat: int):
    """(n_feat,) int64 landmark of each of ``kf_id``'s keypoints (-1 for
    none; of two landmarks on one keypoint the higher slot, as the JAX
    package's numpy assignment leaves it), with ``landmarks_seen_by``'s
    mask and keypoints."""
    seen, kp = ms.landmarks_seen_by(state, kf_id)
    L = seen.shape[0]
    lm = torch.arange(L, device=seen.device)
    out = torch.full((n_feat + 1,), -1, dtype=torch.int64, device=seen.device)
    out.scatter_reduce_(0, torch.where(seen, kp.long(), n_feat),
                        torch.where(seen, lm, -1), reduce="amax")
    return out[:n_feat], seen, kp


def _on(x, dev) -> torch.Tensor:
    """A measurement part (a tensor, or numpy / a number as the JAX
    package stores it) as a float32 tensor on ``dev``, with no
    synchronising copy."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return device_mod.upload(np.asarray(x, np.float32), dev)


class LoopCloser:
    """Loop closing over an atlas: one keyframe database per map (so that
    keyframe slot ids stay unambiguous), on the vocabulary's device.
    ``db`` is the active map's. ``cam_params`` (fx, fy, cx, cy) enables
    the ladder's projective stages; without them it stops after the Sim3
    RANSAC."""

    def __init__(self, voc: bow.Vocabulary, max_kf: int, n_feat: int,
                 cfg: LoopCloserConfig | None = None, cam_params=None):
        self.voc = voc
        self.dbs = {0: KeyframeDatabase(voc, max_kf, n_feat)}
        self.active = 0
        self.cfg = cfg or LoopCloserConfig()
        self.max_kf = max_kf
        self.n_feat = n_feat
        self.cam_params = (None if cam_params is None else _on(
            cam_params, voc.idf.device))
        # Temporal-consistency streaks (mnLoopNumCoincidences /
        # mnMergeNumCoincidences, LoopClosing.cc:445-497):
        # dict(cand, count, miss, corr).
        self._streak = None
        self._merge_streak = None
        # The inertial systems' 4-DoF pose-graph switch, set after the IMU
        # initialisation.
        self.inertial_4dof = False
        # Past closures per map (KeyFrame::AddLoopEdge): (i, j, (R, t, s)),
        # the measurement M_ij at correction time; each stays a hard
        # constraint of every later essential graph.
        self.loop_edges: dict[int, list] = {0: []}
        # The last ``detect`` call's record (candidates, each tried
        # candidate's stage counts, the host reads).
        self.info: dict = {}

    @property
    def db(self) -> KeyframeDatabase:
        return self.dbs[self.active]

    # ------------------------------------------------------------------
    # The atlas lifecycle
    # ------------------------------------------------------------------
    def switch_map(self, map_idx: int, fresh: bool = True):
        """The active map changed (CreateMapInAtlas, or a re-entry with
        ``fresh`` False)."""
        self.active = map_idx
        self._streak = None
        self._merge_streak = None
        if fresh or map_idx not in self.dbs:
            self.dbs[map_idx] = KeyframeDatabase(self.voc, self.max_kf,
                                                 self.n_feat)
            self.loop_edges[map_idx] = []

    def reset_active(self):
        """The active map was reset in place (ResetActiveMap)."""
        self._streak = None
        self._merge_streak = None
        self.dbs[self.active] = KeyframeDatabase(self.voc, self.max_kf,
                                                 self.n_feat)
        self.loop_edges[self.active] = []

    def remap_keyframes(self, old2new: np.ndarray, n_valid: int):
        """Keyframe-slot compaction: the database and the loop edges
        follow (an edge with a dead end dies with it)."""
        self.db.remap(old2new, n_valid)
        self.loop_edges[self.active] = [
            (int(old2new[i]), int(old2new[j]), m)
            for i, j, m in self.loop_edges.get(self.active, [])
            if old2new[i] >= 0 and old2new[j] >= 0]

    def on_maps_merged(self, kept_idx: int, removed_idx: int,
                       state: ms.MapState, kf_lo: int, kf_hi: int):
        """Map ``removed_idx`` was welded into the current map
        (``Atlas.merge``), whose index after the deletion is ``kept_idx``;
        the other map's keyframe k sits in slot ``kf_lo + k`` of ``state``
        for the slots [kf_lo, kf_hi). The databases and loop edges of the
        maps past ``removed_idx`` move down one index, the removed map's
        loop edges move into the kept map with the shift (those with an
        end the clip dropped die), and the transplanted keyframes join the
        kept map's database (one ``add_range``; no host read)."""
        moved = [(i + kf_lo, j + kf_lo, m)
                 for i, j, m in self.loop_edges.get(removed_idx, [])
                 if i + kf_lo < kf_hi and j + kf_lo < kf_hi]
        self.dbs.pop(removed_idx, None)
        self.loop_edges.pop(removed_idx, None)
        self.dbs = {(i - 1 if i > removed_idx else i): d
                    for i, d in self.dbs.items()}
        self.loop_edges = {(i - 1 if i > removed_idx else i): e
                           for i, e in self.loop_edges.items()}
        self.active = kept_idx
        self.loop_edges.setdefault(kept_idx, []).extend(moved)
        if kf_hi > kf_lo:
            self.dbs[kept_idx].add_range(kf_lo, state.kfs.kp_desc[kf_lo:kf_hi],
                                         state.kfs.kp_valid[kf_lo:kf_hi])

    def add_keyframe(self, state: ms.MapState, kf_id):
        """Store keyframe ``kf_id``'s BoW (no host read)."""
        kfs = state.kfs
        self.db.add(kf_id, kfs.kp_desc[kf_id], kfs.kp_valid[kf_id])

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------
    def _sim3_indices(self, mask: torch.Tensor, q: int) -> torch.Tensor:
        """The Sim3 RANSAC's (128, 3) sample rows over the matched pairs
        ``mask`` (one row per query keypoint) of query keyframe ``q``:
        drawn by weighted Gumbel top-k from a generator seeded with ``q``,
        as the JAX package keys its draw with ``PRNGKey(q)``."""
        gen = torch.Generator(mask.device).manual_seed(int(q))
        return sim3_solve.draw_indices(gen, mask)

    def detect(self, state: ms.MapState, kf_id: int, n_kf: int):
        """Mine, verify and temporally confirm a loop at keyframe
        ``kf_id``. Returns (candidate, (R, t, s, n)) once
        ``consecutive_needed`` successive keyframes have verified the same
        place (LoopClosing.cc:445-497), else None; (R, t, s) maps the query
        world onto the candidate's (numpy, float)."""
        self.info = {"query": int(kf_id), "host_reads": [], "tried": []}
        hit = self._detect_geometric(state, kf_id, n_kf)
        if hit is None:
            # The reference lets up to max_not_found keyframes fail before
            # it drops the accumulated coincidences (:497).
            if self._streak is not None:
                self._streak["miss"] += 1
                if self._streak["miss"] > self.cfg.max_not_found:
                    self._streak = None
            self.info["streak"] = (None if self._streak is None
                                   else self._streak["count"])
            return None
        cand, corr = hit
        st = self._streak
        if st is not None and self._same_place(state, st["cand"], cand):
            count = st["count"] + 1
        else:
            count = 1
        self._streak = dict(cand=cand, count=count, miss=0, corr=corr)
        self.info["streak"] = count
        if count >= self.cfg.consecutive_needed:
            self._streak = None
            self.info["fired"] = True
            return cand, corr
        return None

    def _same_place(self, state: ms.MapState, prev_cand: int,
                    cand: int) -> bool:
        """The new candidate lies in the previous candidate's covisible
        window (the spKFsCurrentCovisibles membership check,
        LoopClosing.cc:463-472): one read."""
        if prev_cand == cand:
            return True
        counts = ms.covisibility_counts(state, prev_cand, self.max_kf)
        self.info["host_reads"].append("same_place")
        return bool(device_mod.read(counts[cand])[0] > 0)

    def _detect_geometric(self, state: ms.MapState, kf_id: int, n_kf: int):
        """One keyframe's candidate mining and verification ladder."""
        if n_kf < self.cfg.min_map_kfs:
            return None
        dev = state.kfs.valid.device
        counts = ms.covisibility_counts(state, kf_id, self.max_kf)
        lo = max(0, int(kf_id) - self.cfg.min_kf_gap)
        exclude = (counts > 0) | (torch.arange(self.max_kf, device=dev) >= lo)
        # Covisibility-group scoring and the 0.8x common-words gate
        # (DetectNBestCandidates, KeyFrameDatabase.cc:649-760); a dead
        # candidate comes back as -1.
        ids, scores, words_q = self.db.query_groups(
            state.kfs.kp_desc[kf_id], state.kfs.kp_valid[kf_id],
            ms.covisibility_matrix(state), exclude=exclude, top_n=3,
            n_covisibles=self.cfg.n_covisibles, kf_valid=state.kfs.valid)
        self.info["host_reads"].append("candidates")
        self.info["candidates"] = [int(c) for c in ids]
        for cand in ids:
            if cand < 0:
                continue
            m = self._verify(state, kf_id, state, int(cand), self.db,
                             words_q)
            if m is not None:
                return int(cand), m
        return None

    def _verify(self, state_q: ms.MapState, q: int, state_c: ms.MapState,
                c: int, db_c: KeyframeDatabase, words_q):
        """The verification ladder of one candidate
        (DetectCommonRegionsFromBoW, LoopClosing.cc:733):

          1. BoW matches >= min_bow_matches;
          2. Sim3 RANSAC inliers >= min_ransac_inliers over the matched
             keypoints that both bind a landmark;
          3. the guided projection of the candidate window's landmarks
             (radius 8 x scale, distance <= 1.5 TH_LOW) >= min_proj_matches;
          4. OptimizeSim3's inliers (th2 = 10) >= min_sim3_inliers (a
             refined scale that runs off the RANSAC's is held at it);
          5. the tight re-projection with the refined Sim3 (radius 5 x
             scale, TH_LOW) >= min_proj_opt_matches.

        Returns (R, t, s, n) mapping query world -> candidate world, or
        None. Three packed reads (``HOST_READS``); the stage counts go to
        ``info["tried"]``."""
        kq, kc = state_q.kfs, state_c.kfs
        rec = {"cand": int(c)}
        self.info["tried"].append(rec)
        # SearchByBoW: a pair mask, so ``match`` takes the plain path (as
        # the JAX match takes XLA for a masked call).
        pm = db_c.word_pair_mask(words_q, c)
        mj, _ = matching.match(kq.kp_desc[q], kc.kp_desc[c], kq.kp_valid[q],
                               kc.kp_valid[c], pair_mask=pm,
                               max_dist=matching.TH_LOW, ratio=0.75,
                               mutual=True)
        lm_of_kp_q, _, _ = _kp_landmarks(state_q, q, self.n_feat)
        lm_of_kp_c, seen_c, kp_of_c = _kp_landmarks(state_c, c, self.n_feat)
        matched = mj >= 0
        lc = torch.where(matched, lm_of_kp_c[mj.clamp_min(0).long()], -1)
        pair = matched & (lm_of_kp_q >= 0) & (lc >= 0)
        n_bow, n_pairs = device_mod.read(matched.sum(), pair.sum())
        self.info["host_reads"].append(f"candidate {c} bow")
        rec.update(bow=int(n_bow), pairs=int(n_pairs))
        if n_bow < self.cfg.min_bow_matches:
            rec["failed"] = "bow"
            return None
        if n_pairs < self.cfg.min_ransac_inliers:
            rec["failed"] = "pairs"
            return None

        # Pairs stay one row per query keypoint, masked.
        pa = state_q.lms.pos[lm_of_kp_q.clamp_min(0)]       # query (drifted)
        pb = state_c.lms.pos[lc.clamp_min(0)]               # candidate
        idx = self._sim3_indices(pair, q)
        res = sim3_solve.sim3_ransac(
            idx, pa, pb, pair, th=0.1, with_scale=not self.cfg.fix_scale,
            min_inliers=self.cfg.min_ransac_inliers)
        if self.cam_params is None:
            ok, n_inl, R, t, s = device_mod.read(res.ok, res.n_inliers,
                                                 res.R, res.t, res.s)
            self.info["host_reads"].append(f"candidate {c} sim3")
            rec.update(ransac_ok=bool(ok), ransac_inliers=int(n_inl))
            if not ok:
                rec["failed"] = "ransac"
                return None
            rec["failed"] = None
            return R, t, float(s), int(n_inl)
        return self._verify_projective(state_q, q, state_c, c, lm_of_kp_q,
                                       seen_c, kp_of_c, res, rec)

    def _window_landmark_mask(self, state_c: ms.MapState, c: int):
        """(max_lm,) bool: the landmarks observed by the candidate window,
        the candidate and its ``n_covisibles`` best covisible keyframes
        (GetBestCovisibilityKeyFrames, LoopClosing.cc:925-947), on the
        device."""
        dev = state_c.kfs.valid.device
        counts = ms.covisibility_counts(state_c, c, self.max_kf)
        cv, ci = matching.top_k_lowest_first(counts, self.cfg.n_covisibles)
        # (max_kf + 1,) with the drop slot max_kf False; built by
        # comparisons (an element assignment of a Python value copies it to
        # the device and synchronises).
        k = torch.arange(self.max_kf + 1, device=dev)
        best = torch.where(cv > 0, ci, self.max_kf)
        in_window = (((k[:, None] == best[None, :]).any(-1) | (k == c))
                     & (k < self.max_kf))
        obs = state_c.obs
        hit = in_window[torch.where(obs.valid, obs.kf,
                                    self.max_kf).long()]
        return hit.any(-1) & state_c.lms.valid

    def _guided_projection(self, state_q, q, state_c, c, win_mask,
                           R_u, t_u, s_u, radius_factor, max_dist):
        """SearchByProjection with a world-to-world Sim3 (ORBmatcher.cc):
        the candidate window's landmarks moved into the query world by U =
        (R_u, t_u, s_u) (x_q = s R x_c + t) and matched against the query
        keyframe's keypoints: K2's window mode over every landmark slot."""
        kfs_q, lms_c = state_q.kfs, state_c.lms
        cam = self.cam_params
        pos_q = s_u * (lms_c.pos @ R_u.T) + t_u
        R_qw, t_qw = kfs_q.R[q], kfs_q.t[q]
        cam_center = -(R_qw.T @ t_qw)
        dist = torch.linalg.vector_norm(pos_q - cam_center, dim=-1)
        pred_level = matching.predict_scale_level(dist, lms_c.max_dist * s_u)
        pc = pos_q @ R_qw.T + t_qw
        z = pc[:, 2].clamp_min(1e-6)
        uv = torch.stack([cam[0] * pc[:, 0] / z + cam[2],
                          cam[1] * pc[:, 1] / z + cam[3]], -1)
        in_front = pc[:, 2] > 0.01
        radius = radius_factor * 1.2 ** pred_level.to(torch.float32)
        mj, _ = matching.search_by_projection(
            uv, pred_level, lms_c.desc, win_mask & in_front,
            kfs_q.kp_xy[q], kfs_q.kp_level[q], kfs_q.kp_desc[q],
            kfs_q.kp_valid[q], radius, max_dist=max_dist, ratio=None,
            level_window=(-1, 1))
        return mj

    def _verify_projective(self, state_q, q, state_c, c, lm_of_kp_q, seen_c,
                           kp_of_c, res, rec):
        """Ladder stages 3-5 (see ``_verify``): two packed reads."""
        dev = lm_of_kp_q.device
        # U maps candidate world -> query world; the RANSAC gave query ->
        # candidate.
        R_u, t_u, s_u = lie.sim3_inv(res.R, res.t, res.s)
        win_mask = self._window_landmark_mask(state_c, c)
        mj = self._guided_projection(
            state_q, q, state_c, c, win_mask, R_u, t_u, s_u,
            radius_factor=8.0, max_dist=int(matching.TH_LOW * 1.5))
        hit = mj >= 0
        ok, n_inl, n_proj = device_mod.read(res.ok, res.n_inliers, hit.sum())
        self.info["host_reads"].append(f"candidate {c} sim3")
        rec.update(ransac_ok=bool(ok), ransac_inliers=int(n_inl),
                   projection=int(n_proj))
        if not ok:
            rec["failed"] = "ransac"
            return None
        if n_proj < self.cfg.min_proj_matches:
            rec["failed"] = "projection"
            return None

        # Stage 4 on the first opt_rows matched landmarks, in slot order.
        M = self.cfg.opt_rows
        kfs_q, kfs_c = state_q.kfs, state_c.kfs
        top, rows = matching.top_k_lowest_first(hit.to(torch.int32), M)
        valid_a = top > 0
        lm_c = torch.where(valid_a, rows, 0)
        kp_q = torch.where(valid_a, mj[rows].long(), 0)
        inv_s2 = tracking._inv_sigma2_on(dev)
        lm_q = lm_of_kp_q[kp_q]
        # Direction B: the matched query keypoint binds a landmark and the
        # candidate keyframe itself observes the candidate landmark.
        valid_b = valid_a & (lm_q >= 0) & seen_c[lm_c]
        kp_c = torch.where(valid_b, kp_of_c[lm_c].long(), 0)
        rows = (state_c.lms.pos[lm_c], kfs_q.kp_xy[q][kp_q],
                inv_s2[kfs_q.kp_level[q][kp_q].long()], valid_a, kfs_q.R[q],
                kfs_q.t[q], state_q.lms.pos[lm_q.clamp_min(0)],
                kfs_c.kp_xy[c][kp_c], inv_s2[kfs_c.kp_level[c][kp_c].long()],
                valid_b, kfs_c.R[c], kfs_c.t[c], self.cam_params)
        opt = sim3_solve.optimize_sim3(R_u, t_u, s_u, *rows,
                                       fix_scale=self.cfg.fix_scale)
        held = torch.zeros((), dtype=torch.bool, device=dev)
        if not self.cfg.fix_scale:
            # OptimizeSim3 is Gauss-Newton. Where the query and the
            # candidate see the place from nearly one viewpoint, their
            # reprojections barely hold the scale and its steps can run far
            # along it (a revisit welded at 1.45 where the truth is 1.0),
            # while the RANSAC's 3D-3D fit holds it: a refined scale
            # SCALE_RUNAWAY or more from the RANSAC's gives way to the
            # refinement at the RANSAC's scale.
            fixed = sim3_solve.optimize_sim3(R_u, t_u, s_u, *rows,
                                             fix_scale=True)
            held = ((opt.s / s_u).log().abs()
                    > float(np.log(SCALE_RUNAWAY))).reshape(())
            opt = sim3_solve.OptimizeSim3Result(*(
                torch.where(held, f, o) for f, o in zip(fixed, opt)))
        # Stage 5: the tight re-projection with the refined Sim3, run
        # before stage 4's gate is read (one read for both).
        mj2 = self._guided_projection(
            state_q, q, state_c, c, win_mask, opt.R, opt.t, opt.s,
            radius_factor=5.0, max_dist=matching.TH_LOW)
        R_f, t_f, s_f = lie.sim3_inv(opt.R, opt.t, opt.s)
        n_sim3, n_final, R, t, s, scale_held = device_mod.read(
            opt.n_inliers, (mj2 >= 0).sum(), R_f, t_f, s_f, held)
        self.info["host_reads"].append(f"candidate {c} refine")
        rec.update(sim3_inliers=int(n_sim3), projection_opt=int(n_final),
                   s=float(s), scale_held=bool(scale_held))
        if n_sim3 < self.cfg.min_sim3_inliers:
            rec["failed"] = "sim3"
            return None
        if n_final < self.cfg.min_proj_opt_matches:
            rec["failed"] = "projection_opt"
            return None
        rec["failed"] = None
        return R, t, float(s), int(n_final)

    # ------------------------------------------------------------------
    # Correction
    # ------------------------------------------------------------------
    def _posegraph_dof(self):
        """Sim3 for monocular loops (the drift has 7 DoF), SE3 with a fixed
        scale, 4 DoF (yaw and translation) once the IMU is initialised
        (Optimizer::OptimizeEssentialGraph4DoF, via LoopClosing.cc:1371)."""
        if self.inertial_4dof:
            return pose_graph.DOF_4
        return (pose_graph.DOF_SE3 if self.cfg.fix_scale
                else pose_graph.DOF_SIM3)

    def _edges(self, C: np.ndarray, valid: np.ndarray, n_kf: int,
               span_parent):
        """The essential graph's edges measured from the current poses:
        the spanning tree (the temporal chain without one) and the
        covisibility edges of weight >= ``cov_edge_threshold``, each pair
        once, in the JAX package's order."""
        pairs, ei, ej = set(), [], []

        def add(i, j):
            key = (min(i, j), max(i, j))
            if i == j or key in pairs or not (valid[i] and valid[j]):
                return
            pairs.add(key)
            ei.append(i)
            ej.append(j)

        if span_parent is not None:
            for k in range(n_kf):
                p = int(span_parent[k])
                if p >= 0:
                    add(k, p)
        else:
            for k in range(1, n_kf):
                add(k, k - 1)
        iu, ju = np.nonzero(np.triu(C, 1) >= self.cfg.cov_edge_threshold)
        for i, j in zip(iu.tolist(), ju.tolist()):
            if i < n_kf and j < n_kf:
                add(i, j)
        return ei, ej

    def close(self, state: ms.MapState, kf_id: int, cand: int, correction,
              n_kf: int, span_parent=None) -> ms.MapState:
        """Correct the loop (CorrectLoop): ``correction`` (R_m, t_m, s_m,
        n) maps the drifted query world onto the loop's (x_loop = s R
        x_drift + t). The essential graph holds the spanning tree, the
        covisibility edges over all keyframe pairs, every past loop edge
        of this map and the new one (weight 5); the query's covisible group
        starts at S_k M^-1, the measurements come from the uncorrected
        poses. The pose graph solves over the live prefix (``n_kf``).
        Landmarks follow their first observer. One read: the covisibility
        matrix and the keyframe liveness (the edge set is built on the
        host)."""
        R_m, t_m, s_m, _ = correction
        kfs = state.kfs
        dev = kfs.R.device
        K = self.max_kf
        M_inv = lie.sim3_inv(_on(R_m, dev), _on(t_m, dev),
                             torch.full((), float(s_m), device=dev))
        one = torch.ones((), device=dev)
        Sq_corr = lie.sim3_mul(kfs.R[kf_id], kfs.t[kf_id], one, *M_inv)

        covis = ms.covisibility_matrix(state)
        C, valid = device_mod.read(covis, kfs.valid)
        valid = valid > 0
        ei, ej = self._edges(C, valid, n_kf, span_parent)
        stored = [e for e in self.loop_edges.get(self.active, [])
                  if e[0] < n_kf and e[1] < n_kf and valid[e[0]]
                  and valid[e[1]]]
        n_cur = len(ei)
        ei = ei + [e[0] for e in stored] + [kf_id]
        ej = ej + [e[1] for e in stored] + [cand]
        E = len(ei)
        E_pad = cuda_graph.bucket(E, 128)
        eit = device_mod.upload(np.pad(np.asarray(ei, np.int64),
                                       (0, E_pad - E)), dev)
        ejt = device_mod.upload(np.pad(np.asarray(ej, np.int64),
                                       (0, E_pad - E)), dev)
        ones = torch.ones(n_cur, device=dev)
        mR_b, mt_b, ms_b = pose_graph.relative_sim3(
            kfs.R[eit[:n_cur]], kfs.t[eit[:n_cur]], ones, kfs.R[ejt[:n_cur]],
            kfs.t[ejt[:n_cur]], ones)
        Sc = (kfs.R[cand], kfs.t[cand], one)
        Mrel = pose_graph.sim3_tuple_mul(Sq_corr,
                                         pose_graph.sim3_tuple_inv(Sc))

        def stack(k, pad):
            parts = [(mR_b, mt_b, ms_b)[k]]
            parts += [_on(e[2][k], dev).reshape(parts[0].shape[1:])[None]
                      for e in stored]
            parts += [Mrel[k].reshape(parts[0].shape[1:])[None], pad]
            return torch.cat(parts)

        n_pad = E_pad - E
        mR = stack(0, torch.eye(3, device=dev).expand(n_pad, 3, 3))
        mt = stack(1, torch.zeros((n_pad, 3), device=dev))
        ms_w = stack(2, torch.ones(n_pad, device=dev))
        w = device_mod.upload(np.concatenate([
            np.ones(n_cur, np.float32), np.full(len(stored) + 1, 5.0,
                                                np.float32),
            np.zeros(n_pad, np.float32)]), dev)

        k = torch.arange(K, device=dev)
        fixed = (k == 0) | (k == cand)
        # Initial estimates: the correction propagated through the query's
        # covisible group (S_k' = S_k M^-1).
        group = (((k == kf_id) | (covis[kf_id] > 0)) & kfs.valid
                 & ~fixed)
        R0g, t0g, s0g = lie.sim3_mul(
            kfs.R, kfs.t, torch.ones(K, device=dev),
            M_inv[0].expand(K, 3, 3), M_inv[1].expand(K, 3),
            M_inv[2].expand(K))
        R0 = torch.where(group[:, None, None], R0g, kfs.R)
        t0 = torch.where(group[:, None], t0g, kfs.t)
        s0 = torch.where(group, s0g, torch.ones(K, device=dev))

        dof = self._posegraph_dof()
        res = pose_graph.optimize_pose_graph(
            R0, t0, s0, eit, ejt, mR, mt, ms_w, w, fixed, dof, n_iters=25,
            # 4-DoF frees yaw about the world z axis (gravity): the world-
            # frame (right) perturbation.
            right_perturb=(dof == pose_graph.DOF_4), n_live=n_kf)

        self.loop_edges.setdefault(self.active, []).append(
            (int(kf_id), int(cand), tuple(x.clone() for x in Mrel)))

        # Landmarks through their first observer: p' = S_k'^-1 (S_k (p)).
        first_kf = state.lms.first_kf.clamp_min(0).long()
        p_cam = ((kfs.R[first_kf] @ state.lms.pos[..., None])[..., 0]
                 + kfs.t[first_kf])
        R_new, t_new, s_new = (res.R[first_kf], res.t[first_kf],
                               res.s[first_kf])
        pos_new = ((R_new.transpose(-1, -2) @ (p_cam - t_new)[..., None])
                   [..., 0] / s_new[:, None])
        pos_new = torch.where(state.lms.valid[:, None], pos_new,
                              state.lms.pos)
        # Poses with the scale folded into the translation: Tcw = [R, t/s].
        kfs = kfs._replace(R=res.R, t=res.t / res.s[:, None])
        return state._replace(kfs=kfs,
                              lms=state.lms._replace(pos=pos_new))

    # ------------------------------------------------------------------
    # The merge branch
    # ------------------------------------------------------------------
    def detect_merge(self, state: ms.MapState, kf_id: int, atlas):
        """Mine the other atlas maps for a common region at keyframe
        ``kf_id`` of the active map (the merge branch of
        NewDetectCommonRegions), with the loop branch's temporal streak
        (mnMergeNumCoincidences). Returns (other map, candidate, (R, t, s,
        n) with x_other = s R x_active + t) once ``consecutive_needed``
        successive keyframes have verified the same place of one map, else
        None. ``info`` records each map's candidates and host reads."""
        self.info = {"query": int(kf_id), "host_reads": [], "tried": [],
                     "merge": True, "maps": []}
        hit = self._detect_merge_geometric(state, kf_id, atlas)
        if hit is None:
            if self._merge_streak is not None:
                self._merge_streak["miss"] += 1
                if self._merge_streak["miss"] > self.cfg.max_not_found:
                    self._merge_streak = None
            self.info["streak"] = (None if self._merge_streak is None
                                   else self._merge_streak["count"])
            return None
        idx, cand, corr = hit
        st = self._merge_streak
        if (st is not None and st["map_idx"] == idx
                and self._same_place(atlas.maps[idx], st["cand"], cand)):
            count = st["count"] + 1
        else:
            count = 1
        self._merge_streak = dict(map_idx=idx, cand=cand, count=count,
                                  miss=0, corr=corr)
        self.info["streak"] = count
        if count >= self.cfg.consecutive_needed:
            self._merge_streak = None
            self.info["fired"] = True
            return idx, cand, corr
        return None

    def _detect_merge_geometric(self, state: ms.MapState, kf_id: int, atlas):
        """Each other map with 3 keyframes or more, in index order: its
        database's covisibility groups against the query keyframe, then the
        verification ladder on each candidate (``_verify`` with that map's
        state and database). A system of fixed scale refuses a Sim3 scale
        outside 0.9-1.1 (LoopClosing.cc:168)."""
        kfs = state.kfs
        for idx, db in sorted(self.dbs.items()):
            if (idx == self.active or idx >= len(atlas.maps)
                    or atlas.meta[idx].n_kf < 3):
                continue
            other = atlas.maps[idx]
            n_reads = len(self.info["host_reads"])
            ids, _, words_q = db.query_groups(
                kfs.kp_desc[kf_id], kfs.kp_valid[kf_id],
                ms.covisibility_matrix(other), top_n=3,
                n_covisibles=self.cfg.n_covisibles, kf_valid=other.kfs.valid)
            self.info["host_reads"].append(f"map {idx} candidates")
            rec = {"map": idx, "candidates": [int(c) for c in ids]}
            self.info["maps"].append(rec)
            try:
                for cand in ids:
                    if cand < 0:
                        continue
                    m = self._verify(state, kf_id, other, int(cand), db,
                                     words_q)
                    if m is None:
                        continue
                    if self.cfg.fix_scale and not 0.9 <= m[2] <= 1.1:
                        self.info["tried"][-1]["failed"] = "scale"
                        continue
                    return idx, int(cand), m
            finally:
                rec["host_reads"] = len(self.info["host_reads"]) - n_reads
        return None
