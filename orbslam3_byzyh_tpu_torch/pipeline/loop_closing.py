"""Loop closing: the keyframe databases of the atlas maps.

Port of the database half of ``orbslam3_byzyh_tpu/pipeline/loop_closing.py``
(ORB-SLAM3's ``LoopClosing``): the verification ladder's configuration
and the ``LoopCloser``'s per-map keyframe databases with their lifecycle
(``switch_map``, ``reset_active``, ``remap_keyframes``, ``add_keyframe``),
which relocalisation mines. Loop detection and correction (``detect``,
``close``) wait for ROADMAP item 12b, the atlas merge (``detect_merge``,
``on_maps_merged``) for item 12c; each raises. The per-map loop edges are
kept, empty, for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models import map_state as ms
from ..ops import bow
from .keyframe_db import KeyframeDatabase


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


def _waits(what: str, item: str):
    raise NotImplementedError(f"LoopCloser.{what} waits for ROADMAP item "
                              f"{item}")


class LoopCloser:
    """The per-map keyframe databases of an atlas (one per map, so that
    keyframe slot ids stay unambiguous), on the vocabulary's device.
    ``db`` is the active map's."""

    def __init__(self, voc: bow.Vocabulary, max_kf: int, n_feat: int,
                 cfg: LoopCloserConfig | None = None):
        self.voc = voc
        self.dbs = {0: KeyframeDatabase(voc, max_kf, n_feat)}
        self.active = 0
        self.cfg = cfg or LoopCloserConfig()
        self.max_kf = max_kf
        self.n_feat = n_feat
        # The inertial systems' 4-DoF pose-graph switch, set after the IMU
        # initialisation (read by item 12b).
        self.inertial_4dof = False
        # Past closures per map (KeyFrame::AddLoopEdge): (i, j, measurement).
        self.loop_edges: dict[int, list] = {0: []}

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
        if fresh or map_idx not in self.dbs:
            self.dbs[map_idx] = KeyframeDatabase(self.voc, self.max_kf,
                                                 self.n_feat)
            self.loop_edges[map_idx] = []

    def reset_active(self):
        """The active map was reset in place (ResetActiveMap)."""
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

    def add_keyframe(self, state: ms.MapState, kf_id):
        """Store keyframe ``kf_id``'s BoW (no host read)."""
        kfs = state.kfs
        self.db.add(kf_id, kfs.kp_desc[kf_id], kfs.kp_valid[kf_id])

    # ------------------------------------------------------------------
    # Detection, correction and merging: later slices.
    # ------------------------------------------------------------------
    def detect(self, *args, **kwargs):
        _waits("detect", "12b")

    def close(self, *args, **kwargs):
        _waits("close", "12b")

    def detect_merge(self, *args, **kwargs):
        _waits("detect_merge", "12c")

    def on_maps_merged(self, *args, **kwargs):
        _waits("on_maps_merged", "12c")
