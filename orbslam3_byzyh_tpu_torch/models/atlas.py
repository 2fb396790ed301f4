"""Atlas: the current map and the maps kept from earlier sequences.

Port of the JAX package's ``models/atlas.py`` (ORB-SLAM3's ``Atlas``): a list
of whole map states with their host-side counters; a new map is made when
tracking is lost with a mature map (``CreateMapInAtlas``), and a young map is
reset in place. The merge of two maps waits for ROADMAP item 12c.
"""

from __future__ import annotations

import dataclasses
from typing import List

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
        """Weld map ``other_idx`` into the current map (loop closing's
        merge of two maps)."""
        raise NotImplementedError("atlas merge waits for ROADMAP item 12c")
