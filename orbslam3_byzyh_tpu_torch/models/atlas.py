"""Atlas: the current map and the maps kept from earlier sequences.

Port of the JAX package's ``models/atlas.py`` (ORB-SLAM3's ``Atlas``): a list
of whole map states with their host-side counters; a new map is made when
tracking is lost with a mature map (``CreateMapInAtlas``), and a young map is
reset in place; ``merge`` welds another map into the current one through
a Sim3 (loop closing's merge branch, ``MergeLocal``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import device as device_mod
from . import map_state as ms


@dataclasses.dataclass
class MapMeta:
    n_kf: int = 0
    n_lm: int = 0
    # Spanning-tree parents (numpy int32 (max_kf,), -1 = root or unset):
    # the essential graph's tree edges (KeyFrame::GetParent). Allocated on
    # first use.
    kf_parent: object = None


class Atlas:
    """Maps of the given capacities on ``device`` (``None``: the card;
    raises without one)."""

    def __init__(self, max_kf: int, max_lm: int, max_obs: int, n_feat: int,
                 device=None):
        self.device = device_mod.resolve(device)
        self.dims = (max_kf, max_lm, max_obs, n_feat)
        self.maps: List[ms.MapState] = [self._empty()]
        self.meta: List[MapMeta] = [MapMeta()]
        self.current = 0

    def _empty(self) -> ms.MapState:
        return ms.empty_map(*self.dims, device=self.device)

    @property
    def state(self) -> ms.MapState:
        return self.maps[self.current]

    @state.setter
    def state(self, s: ms.MapState):
        self.maps[self.current] = s

    def counts(self) -> MapMeta:
        return self.meta[self.current]

    def create_new_map(self) -> int:
        """Keep the current map and make a new empty one current (tracking
        lost with a mature map)."""
        self.maps.append(self._empty())
        self.meta.append(MapMeta())
        self.current = len(self.maps) - 1
        return self.current

    def reset_active_map(self):
        """Empty the current map in place (a map too young to keep)."""
        self.maps[self.current] = self._empty()
        self.meta[self.current] = MapMeta()

    def merge(self, other_idx: int, R_m, t_m, s_m: float) -> int:
        """Weld map ``other_idx`` into the current map and delete it.

        (R_m, t_m, s_m) maps the other map's world into the current one's
        (x_cur = s R_m x_oth + t_m; numpy or tensors). The other map's
        first ``kf_take`` keyframes and ``lm_take`` landmarks that fit the
        free slots are appended after the current map's counters (the
        capacity clip drops the rest): poses as R' = R R_m^T, t' = s t -
        R' t_m (the scale folded into the translation), positions moved,
        normals rotated, the distance range scaled, ``first_kf`` and
        ``obs.kf`` shifted by the current keyframe count, a dropped
        keyframe's ids -1 and its observations dead. Each field is one
        slice copy on the device; the counters and the spanning tree
        (transplanted with the same shift, a dropped parent -1) are the
        host's. Returns the merged map's index (the current one, re-indexed
        past the deletion).

        The JAX ``Atlas.merge`` leaves a landmark that lost observations
        to the clip live with its old ``n_obs``, possibly with no live
        observation; here such a landmark's ``n_obs`` is recounted from its
        surviving observations and it dies below 2, as ``drop_keyframe``
        and the VI-BA write-back recount."""
        cur, oth = self.maps[self.current], self.maps[other_idx]
        mc, mo = self.meta[self.current], self.meta[other_idx]
        max_kf, max_lm = self.dims[:2]
        kf_take = min(mo.n_kf, max_kf - mc.n_kf)
        lm_take = min(mo.n_lm, max_lm - mc.n_lm)
        kf_off, lm_off = mc.n_kf, mc.n_lm
        dev = cur.kfs.R.device
        R_m, t_m = (x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
                    else device_mod.upload(np.asarray(x, np.float32), dev)
                    for x in (R_m, t_m))
        s = float(s_m)

        def put(dst, src, lo, n):
            # dst with rows [lo, lo + n) replaced by src: one copy.
            return torch.cat([dst[:lo], src, dst[lo + n:]])

        ko, lo_ = oth.kfs, oth.lms
        R_new = ko.R[:kf_take] @ R_m.T
        t_new = s * ko.t[:kf_take] - (R_new @ t_m[:, None])[..., 0]
        kfs = ms.KeyFrames(*(
            put(c, o, kf_off, kf_take) for c, o in zip(cur.kfs, ms.KeyFrames(
                R=R_new, t=t_new, **{f: getattr(ko, f)[:kf_take]
                                     for f in ms.KeyFrames._fields[2:]}))))

        okf, oobs = oth.obs.kf[:lm_take], oth.obs.valid[:lm_take]
        kept = (okf >= 0) & (okf < kf_take)
        obs_valid = oobs & kept
        # The Low repair: a landmark that lost an observation to the clip.
        lost = (oobs & ~kept).any(-1)
        recount = (obs_valid & (okf >= 0)).sum(-1).to(lo_.n_obs.dtype)
        n_obs = torch.where(lost, recount, lo_.n_obs[:lm_take])
        fkf = lo_.first_kf[:lm_take]
        new_lms = ms.Landmarks(
            pos=s * (lo_.pos[:lm_take] @ R_m.T) + t_m,
            desc=lo_.desc[:lm_take],
            normal=lo_.normal[:lm_take] @ R_m.T,
            min_dist=lo_.min_dist[:lm_take] * s,
            max_dist=lo_.max_dist[:lm_take] * s,
            n_obs=n_obs, n_found=lo_.n_found[:lm_take],
            n_visible=lo_.n_visible[:lm_take],
            first_kf=torch.where(fkf < kf_take, fkf + kf_off, -1).to(
                fkf.dtype),
            valid=lo_.valid[:lm_take] & ~(lost & (n_obs < 2)))
        lms = ms.Landmarks(*(put(c, o, lm_off, lm_take)
                             for c, o in zip(cur.lms, new_lms)))
        new_obs = ms.Observations(
            kf=torch.where(kept, okf + kf_off, -1).to(okf.dtype),
            kp=torch.where(kept, oth.obs.kp[:lm_take], -1).to(okf.dtype),
            valid=obs_valid)
        obs = ms.Observations(*(put(c, o, lm_off, lm_take)
                                for c, o in zip(cur.obs, new_obs)))
        self.maps[self.current] = ms.MapState(kfs=kfs, lms=lms, obs=obs)

        # The other map's spanning tree, ids shifted; a parent the clip
        # dropped leaves its child a root (attached at the weld).
        parent, po = mc.kf_parent, mo.kf_parent
        if po is not None or parent is not None:
            parent = (np.full(max_kf, -1, np.int32) if parent is None
                      else parent.copy())
            if po is not None:
                src = np.asarray(po)[:kf_take]
                parent[kf_off:kf_off + kf_take] = np.where(
                    (src >= 0) & (src < kf_take), src + kf_off, -1)
        self.meta[self.current] = MapMeta(n_kf=kf_off + kf_take,
                                          n_lm=lm_off + lm_take,
                                          kf_parent=parent)
        del self.maps[other_idx]
        del self.meta[other_idx]
        if other_idx < self.current:
            self.current -= 1
        return self.current
