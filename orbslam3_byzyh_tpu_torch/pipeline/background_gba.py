"""Background (time-sliced, abortable) global bundle adjustment.

Port of ``orbslam3_byzyh_tpu/pipeline/background_gba.py`` (ORB-SLAM3's
``LoopClosing::RunGlobalBundleAdjustment``, a detached thread that
tracking outlives, aborted by ``mbStopGBA``). On one card the solve is
time-sliced instead: it runs against a snapshot of the map (a
``ba.BAProblem`` taken at the correction) and advances one
Levenberg-Marquardt iteration a tracked frame, so each frame pays a bounded
slice of device work. The merge folds the result into the current map:

  * keyframes of the snapshot take their refined pose;
  * keyframes made since are re-anchored through their nearest snapshot
    ancestor on the spanning tree, Tcw' = Tcw_cur Twc_anchor Tcw_anchor_gba
    (the walk runs on the host, as in the JAX package);
  * landmarks of the snapshot take their refined position (a recycled slot,
    ``first_kf`` at or past the snapshot's keyframe count, counts as new);
  * landmarks made since move rigidly with their creating keyframe's
    anchor.

A newer correction, a map reset or a slot compaction aborts the run;
``flush`` finishes it inline (the shutdown and save paths wait for the
thread the same way). A tick reads nothing back; ``start`` reads the
keyframe liveness once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..models import map_state as ms
from ..ops import camera as cam
from ..solver import ba, lm


def _delta2(p: ba.BAProblem):
    if p.obs_ur is None:
        return lm.CHI2_MONO
    return torch.where(p.obs_ur >= 0.0, lm.CHI2_STEREO, lm.CHI2_MONO)


def _gba_step(p: ba.BAProblem, R, t, points, inlier, lam, model_id: int,
              robust: bool):
    """One LM iteration on the snapshot problem (one bounded slice): the
    scatter Schur step from the current iterate, accepted if it lowers the
    cost."""
    delta2 = _delta2(p)
    n_kf = p.R.shape[0]
    sys_cur = ba._build_system(p, R, t, points, inlier, model_id, robust,
                               delta2)
    dp, dl = ba._schur_reduce(p, sys_cur, lam, n_kf,
                              ba.schur_pieces_scatter)
    cand = ba._retract(R, t, points, dp, dl, p.fixed)
    sys_cand = ba._build_system(p, *cand, inlier, model_id, robust, delta2)
    accept = sys_cand["cost"] < sys_cur["cost"]
    return (torch.where(accept, cand[0], R), torch.where(accept, cand[1], t),
            torch.where(accept, cand[2], points),
            torch.where(accept, lam * 0.5, lam * 10.0))


def _gate_inliers(p: ba.BAProblem, R, t, points, model_id: int):
    """The outlier re-classification between the robust and final
    stages."""
    r, _, _, depth_ok = ba._residuals(p, R, t, points, model_id)
    chi2 = (r * r).sum(-1) * p.obs_w
    return (chi2 <= _delta2(p)) & depth_ok


def _merge_result(state: ms.MapState, R_gba, t_gba, pts_gba, snap_kf,
                  snap_lm_valid, anchor, snap_n_kf: int) -> ms.MapState:
    """Fold a finished snapshot solve into the current state. anchor: (K,)
    each keyframe's nearest snapshot ancestor (-1: none); snap_kf: (K,) the
    snapshot's keyframes; snap_lm_valid: (L,) its landmarks."""
    kfs, lms = state.kfs, state.lms
    a = anchor.clamp_min(0).long()
    has_anchor = anchor >= 0
    R_o, t_o = kfs.R[a], kfs.t[a]                    # anchor, current
    R_n, t_n = R_gba[a], t_gba[a]                    # anchor, refined
    # Keyframes made since: Tcw' = Tcw_cur Twc_anchor_cur Tcw_anchor_gba.
    Rel = kfs.R @ R_o.transpose(-1, -2)
    R_child = Rel @ R_n
    t_child = (Rel @ (t_n - t_o)[..., None])[..., 0] + kfs.t
    take_gba = snap_kf & kfs.valid
    propagate = ~snap_kf & kfs.valid & has_anchor
    R_new = torch.where(take_gba[:, None, None], R_gba,
                        torch.where(propagate[:, None, None], R_child, kfs.R))
    t_new = torch.where(take_gba[:, None], t_gba,
                        torch.where(propagate[:, None], t_child, kfs.t))
    # Landmarks made since (and recycled slots) through their creating
    # keyframe's anchor: x' = R_n^T (R_o x + t_o - t_n).
    fk = lms.first_kf.clamp(0, anchor.shape[0] - 1).long()
    la = anchor[fk].clamp_min(0).long()
    l_has = anchor[fk] >= 0
    xc = (kfs.R[la] @ lms.pos[..., None])[..., 0] + kfs.t[la]
    x_corr = (R_gba[la].transpose(-1, -2)
              @ (xc - t_gba[la])[..., None])[..., 0]
    is_snap = snap_lm_valid & (lms.first_kf < snap_n_kf) & lms.valid
    is_new = lms.valid & ~is_snap & l_has
    pos_new = torch.where(is_snap[:, None], pts_gba,
                          torch.where(is_new[:, None], x_corr, lms.pos))
    return state._replace(kfs=kfs._replace(R=R_new, t=t_new),
                          lms=lms._replace(pos=pos_new))


class BackgroundGBA:
    """Host orchestration of the time-sliced global BA."""

    def __init__(self, model_id: int = cam.PINHOLE, stages=(4, 6)):
        self.model_id = model_id
        self.stages = stages
        self.active = False
        self._prob = None
        self._carry = None
        self._iters = 0
        self._snap_n_kf = 0
        self._snap_lm_valid = None
        self._snap_kf = None

    def start(self, state: ms.MapState, n_kf: int, cam_params,
              use_stereo: bool = False, bf: float = 0.0):
        """Snapshot the map and begin the solve (a run in flight is
        replaced: a newer correction supersedes it). One read: the keyframe
        liveness, for the host's anchor walk at the merge."""
        from . import mapping
        valid = state.kfs.valid
        free = valid & (torch.arange(valid.shape[0],
                                     device=valid.device) != 0)
        self._prob = mapping._full_ba_problem(state, free, cam_params,
                                              use_stereo, bf)
        p = self._prob
        self._carry = (p.R, p.t, p.points, torch.ones_like(p.obs_valid),
                       torch.full((), 1e-4, device=valid.device))
        self._iters = 0
        self._snap_n_kf = int(n_kf)
        self._snap_kf = device_mod.read(valid)[0] > 0
        self._snap_lm_valid = state.lms.valid
        self.active = True

    def abort(self):
        self.active = False
        self._prob = None
        self._carry = None

    @property
    def total_iters(self) -> int:
        return sum(self.stages)

    def tick(self) -> bool:
        """Advance one LM iteration (no host read). Returns True when the
        solve is complete and ready to merge."""
        if not self.active:
            return False
        robust = self._iters < self.stages[0]
        R, t, pts, inlier, lam = self._carry
        if self._iters == self.stages[0]:
            inlier = _gate_inliers(self._prob, R, t, pts, self.model_id)
            lam = torch.full_like(lam, 1e-4)
        R, t, pts, lam = _gba_step(self._prob, R, t, pts, inlier, lam,
                                   self.model_id, robust)
        self._carry = (R, t, pts, inlier, lam)
        self._iters += 1
        return self._iters >= self.total_iters

    def flush(self) -> bool:
        """Run the remaining iterations inline. Returns True if a finished
        solve is ready to merge."""
        if not self.active:
            return False
        done = self._iters >= self.total_iters
        while not done:
            done = self.tick()
        return True

    @staticmethod
    def anchors(snap: np.ndarray, kf_parent: np.ndarray,
                snap_n_kf: int) -> np.ndarray:
        """Each keyframe slot's nearest snapshot ancestor on the spanning
        tree (-1: none); a root made since the snapshot takes the nearest
        earlier snapshot slot."""
        max_kf = len(snap)
        anchor = np.full(max_kf, -1, np.int64)
        for k in range(max_kf):
            p, hops = k, 0
            while p >= 0 and hops <= max_kf:
                if p < len(snap) and snap[p]:
                    anchor[k] = p
                    break
                p = int(kf_parent[p]) if p < len(kf_parent) else -1
                hops += 1
            if anchor[k] < 0 and k >= snap_n_kf:
                earlier = np.flatnonzero(snap[:k])
                if len(earlier):
                    anchor[k] = earlier[-1]
        return anchor

    def merge(self, state: ms.MapState, kf_parent: np.ndarray) -> ms.MapState:
        """Fold the finished solve into the current state (spanning-tree
        propagation to the keyframes and landmarks made meanwhile)."""
        R, t, pts, _, _ = self._carry
        dev = R.device
        anchor = self.anchors(self._snap_kf, kf_parent, self._snap_n_kf)
        new_state = _merge_result(
            state, R, t, pts, device_mod.upload(self._snap_kf, dev),
            self._snap_lm_valid, device_mod.upload(anchor, dev),
            self._snap_n_kf)
        self.abort()
        return new_state
