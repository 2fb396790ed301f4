"""Frame-trajectory log with save-time replay against current keyframe poses.

The reference logs, per tracked frame, the pose RELATIVE to its reference
keyframe (``mlRelativeFramePoses``/``mlpReferences``,
ORB-SLAM3 src/Tracking.cc:3396-3419) and composes against the
keyframes' CURRENT poses when saving (``System::SaveTrajectoryEuRoC``), so
loop-closure / global-BA / gravity-scale corrections retroactively fix the
whole per-frame trajectory. This module is the array-state equivalent:

* ``log``        — store ``T_cr = T_cw ∘ T_rw⁻¹`` for a frame against its
                   reference KF's pose at track time;
* ``replay``     — recompose every frame against the keyframe array's
                   current poses (vectorized);
* ``rebase``     — move records off a culled KF onto a surviving parent
                   using the poses current at cull time (the reference's
                   ``while(pKF->isBad()) Trel = Trel * Tcp; pKF = parent``
                   walk, resolved eagerly because array slots are reused);
* ``remap``      — follow keyframe-slot compaction;
* ``rescale``    — gravity/scale map rebase: relative rotations are
                   invariant, relative translations scale by ``s``
                   (``Tracking::UpdateFrameIMU`` rescales
                   mlRelativeFramePoses the same way);
* ``freeze_all`` — when a map is abandoned (new map in the Atlas), its
                   frames are replayed once and stored absolute.
"""

from __future__ import annotations

import numpy as np


class TrajectoryLog:
    def __init__(self):
        self.stamps: list[float] = []
        self.refs: list[int] = []       # keyframe slot id; -1 = absolute
        self.R_cr: list[np.ndarray] = []
        self.t_cr: list[np.ndarray] = []
        # Atlas-map tag per record: meaningful for FROZEN (ref=-1) records,
        # which live in an abandoned map's world frame until that map is
        # merged back (then transform_frozen re-coordinates them). Live
        # records always reference the active map.
        self.tags: list[int] = []

    def __len__(self) -> int:
        return len(self.stamps)

    # ------------------------------------------------------------------
    def log(self, stamp: float, R_cw: np.ndarray, t_cw: np.ndarray,
            ref_kf: int, R_rw: np.ndarray | None = None,
            t_rw: np.ndarray | None = None):
        """Record one frame. ``(R_rw, t_rw)`` is the reference KF's
        world->cam pose at track time (required when ref_kf >= 0)."""
        R_cw = np.asarray(R_cw, np.float32)
        t_cw = np.asarray(t_cw, np.float32)
        if ref_kf < 0:
            R, t = R_cw, t_cw
        else:
            # T_cr = T_cw ∘ T_rw⁻¹ = (R_cw R_rw^T, t_cw - R_cw R_rw^T t_rw)
            R = R_cw @ np.asarray(R_rw, np.float32).T
            t = t_cw - R @ np.asarray(t_rw, np.float32)
        self.stamps.append(float(stamp))
        self.refs.append(int(ref_kf))
        self.R_cr.append(R)
        self.t_cr.append(t)
        self.tags.append(-1)

    # ------------------------------------------------------------------
    def replay(self, kfs_R: np.ndarray, kfs_t: np.ndarray):
        """Compose every record against the CURRENT keyframe poses.
        Returns a list of (stamp, R_cw, t_cw)."""
        if not self.stamps:
            return []
        refs = np.asarray(self.refs)
        Rcr = np.stack(self.R_cr)
        tcr = np.stack(self.t_cr)
        safe = np.maximum(refs, 0)
        Rrw = np.asarray(kfs_R)[safe]
        trw = np.asarray(kfs_t)[safe]
        R_out = np.einsum("nij,njk->nik", Rcr, Rrw)
        t_out = np.einsum("nij,nj->ni", Rcr, trw) + tcr
        absolute = refs < 0
        R_out[absolute] = Rcr[absolute]
        t_out[absolute] = tcr[absolute]
        return [(s, R_out[i], t_out[i]) for i, s in enumerate(self.stamps)]

    # ------------------------------------------------------------------
    def rebase(self, dead: np.ndarray, parent_of: np.ndarray,
               kfs_R: np.ndarray, kfs_t: np.ndarray):
        """Move records referencing a culled KF onto its parent:
        ``T_cr' = T_cr ∘ (T_rw ∘ T_pw⁻¹)`` with both poses current at cull
        time, so the recomposition is exact now and future corrections to
        the parent keep propagating. ``dead``: bool (max_kf,); ``parent_of``:
        int (max_kf,) new reference per dead slot (must be live)."""
        kfs_R = np.asarray(kfs_R)
        kfs_t = np.asarray(kfs_t)
        for i, r in enumerate(self.refs):
            if r < 0 or not dead[r]:
                continue
            R_cr, t_cr = self.R_cr[i], self.t_cr[i]
            R_rw, t_rw = kfs_R[r], kfs_t[r]
            p = int(parent_of[r])
            if p < 0:
                # No surviving parent: freeze absolute (T_cw = T_cr ∘ T_rw).
                self.R_cr[i] = R_cr @ R_rw
                self.t_cr[i] = R_cr @ t_rw + t_cr
                self.refs[i] = -1
                continue
            R_pw, t_pw = kfs_R[p], kfs_t[p]
            # T_rp = T_rw ∘ T_pw⁻¹; T_cr' = T_cr ∘ T_rp.
            R_rp = R_rw @ R_pw.T
            t_rp = t_rw - R_rp @ t_pw
            self.R_cr[i] = R_cr @ R_rp
            self.t_cr[i] = R_cr @ t_rp + t_cr
            self.refs[i] = p

    # ------------------------------------------------------------------
    def remap(self, old2new: np.ndarray):
        """Follow a keyframe-slot compaction (ms.compact_keyframes)."""
        for i, r in enumerate(self.refs):
            if r >= 0:
                self.refs[i] = int(old2new[r])

    # ------------------------------------------------------------------
    def rescale(self, s: float):
        """Gravity/scale map rebase: t_cr scales, R_cr is invariant
        (derivation: R_cr' = R_cw R_wg (R_rw R_wg)^T = R_cr;
        t_cr' = s t_cw - R_cr s t_rw = s t_cr). Absolute (frozen) records
        belong to abandoned maps and are left untouched."""
        for i, r in enumerate(self.refs):
            if r >= 0:
                self.t_cr[i] = np.float32(s) * self.t_cr[i]

    # ------------------------------------------------------------------
    def freeze_all(self, kfs_R: np.ndarray, kfs_t: np.ndarray,
                   map_tag: int = -1):
        """Replay every live record once and store it absolute — called
        when the active map is abandoned (its KF slots will be reused).
        ``map_tag``: the atlas index the abandoned map keeps living at —
        if it is later merged back, ``transform_frozen`` re-coordinates
        these records through the welding Sim3."""
        for i, (s, R, t) in enumerate(self.replay(kfs_R, kfs_t)):
            if self.refs[i] >= 0:
                self.tags[i] = map_tag
            self.refs[i] = -1
            self.R_cr[i] = R
            self.t_cr[i] = t

    # ------------------------------------------------------------------
    def transform_frozen(self, map_tag: int, R_m: np.ndarray,
                         t_m: np.ndarray, s_m: float, new_tag: int):
        """The map at atlas index ``map_tag`` was welded into the active
        map with x_active = s R_m x_other + t_m (Atlas.merge): move its
        frozen records into active-world coordinates (pose transform
        R' = R R_m^T, t' = s t - R' t_m — the same formula Atlas.merge
        applies to the transplanted keyframes) and retag. Tags above the
        deleted index shift down by one (Atlas.merge list deletion)."""
        R_m = np.asarray(R_m, np.float32)
        t_m = np.asarray(t_m, np.float32)
        s = np.float32(s_m)
        for i, tag in enumerate(self.tags):
            if self.refs[i] >= 0:
                continue
            if tag == map_tag:
                R = self.R_cr[i] @ R_m.T
                self.R_cr[i] = R
                self.t_cr[i] = s * self.t_cr[i] - R @ t_m
                self.tags[i] = new_tag
            elif tag > map_tag:
                self.tags[i] = tag - 1
