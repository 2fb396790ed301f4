"""The golden-trajectory gate (``tests/test_golden.py``) on the port's
``MonoSlam``, on the CPU: the frozen golden config on the committed golden
frames (``graft.golden_frames()``, ``SynthWorld(seed=3)`` at t = 0.0 ...
4.4 s). The port's RANSAC draws from its own generator, so the run is not
the JAX run; the gate is a tolerance: at least 44 - 2 frames in the
trajectory, and a Horn-scaled ATE against the true camera centres below
1.5 x 0.0086 + 0.002 m. ``chip_smoke.py`` runs the same gate on the card.
"""

import numpy as np
import pytest

from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.io import trajectory
from orbslam3_byzyh_tpu_torch.pipeline.system import OK, MonoSlam
from orbslam3_byzyh_tpu_torch.utils import evaluate

pytestmark = pytest.mark.slow  # a whole sequence (minutes on the CPU)


def test_frozen_config_stays_within_golden(tmp_path):
    g = graft.golden_frames()
    slam = MonoSlam(graft.golden_slam_config(), device="cpu")
    for img, stamp in zip(g.frames, g.stamps):
        slam.track(img, float(stamp))
    assert slam.status == OK
    traj = slam.trajectory
    assert len(traj) >= graft.GOLDEN_N_FRAMES - 2
    stamps = np.array([s for s, _, _ in traj])
    est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                  np.stack([t for _, _, t in traj]))
    idx = np.searchsorted(g.stamps, stamps - 1e-6)
    np.testing.assert_allclose(g.stamps[idx], stamps, atol=1e-6)
    _, _, _, rmse = evaluate.horn_align(est, g.centres[idx])
    assert rmse < graft.GOLDEN_ATE_GATE_M, rmse
    # The trajectory files in the golden format: ns stamps, unit quaternions.
    path = str(tmp_path / "f_port.txt")
    trajectory.save_tum(path, stamps, [R for _, R, _ in traj],
                        [t for _, _, t in traj], stamp_scale=1e9)
    s, centres, quats = trajectory.load_tum(path)
    assert np.all(np.diff(s) > 0) and s[-1] >= 1e8
    np.testing.assert_allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-4)
    ks, _, _ = slam.keyframe_trajectory()
    assert len(ks) >= 10 and np.all(np.diff(ks) > 0)
