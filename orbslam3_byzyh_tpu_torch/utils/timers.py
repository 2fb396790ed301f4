"""Per-stage timing statistics (ORB-SLAM3's REGISTER_TIMES).

Port of the JAX package's ``utils/timers.py``: the same stage taxonomy
(ORB-SLAM3's ``Tracking`` and ``LocalMapping`` timing vectors), the same
statistics and report, and the same ``ExecTimeMean.txt`` artefact as
``Tracking::PrintTimeStats``. A system turns them on with
``enable_stage_timers()``. The device runs asynchronously, so the systems
end each timed stage with ``torch.cuda.synchronize`` on their device (the
JAX package blocks on the stage's outputs); with the timers off no stage
synchronises.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

# ORB-SLAM3's stage taxonomy (Tracking.h, LocalMapping.h timing vectors).
STAGES = (
    "orb_extract", "stereo_match", "imu_preint", "pose_pred",
    "lm_track", "new_kf_decision", "total_track",
    "kf_insert", "mp_culling", "mp_creation", "lba", "kf_culling",
    "total_mapping", "loop_detect", "loop_correct", "global_ba",
)


class StageTimers:
    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[stage].append(time.perf_counter() - t0)

    def stats(self):
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = dict(mean=float(a.mean()), std=float(a.std()),
                          n=len(a), total=float(a.sum()))
        return out

    def report(self) -> str:
        lines = ["stage                    mean(ms)   std(ms)      n"]
        for k, s in sorted(self.stats().items()):
            lines.append(f"{k:24s} {s['mean']*1e3:9.2f} {s['std']*1e3:9.2f} "
                         f"{s['n']:6d}")
        return "\n".join(lines)

    def save(self, path: str = "ExecTimeMean.txt"):
        """The artefact ``Tracking::PrintTimeStats`` writes."""
        with open(path, "w") as f:
            f.write(self.report() + "\n")
