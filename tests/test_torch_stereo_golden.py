"""The stereo and RGB-D runs' gates on the port's systems, on the CPU, on the
committed stereo frames (``graft.stereo_frames()``, ``SynthWorld(seed=11)``
at t = 0.0 ... 2.9 s, baseline 0.2 m). ``chip_smoke.py`` phase "11 stereo"
runs the same gates on the card, with the RGB-D run at its full 1024
keyframe / 65536 landmark slots.

  (a) ``StereoSlam`` at tests/test_stereo_system.py's configuration, held to
      that test's gate: more than 20 frames, the ATE without scale
      alignment under 0.12 m, the path length within 5 %.
  (c) ``RgbdSlam`` at TUM1's RGB-D settings, held to the JAX ``RgbdSlam``'s
      run on the same frames (``scripts/stereo_reference_jax.py rgbd``: 30
      frames, ATE 0.007657 m): its frame count +- 1 and an ATE under
      1.5 x 0.007657 + 0.002 m. Both runs here use 64 keyframe and 16384
      landmark slots, as the reference run did (30 frames fill neither).
"""

import numpy as np
import pytest

from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.pipeline.stereo_system import RgbdSlam, StereoSlam
from orbslam3_byzyh_tpu_torch.pipeline.system import OK
from orbslam3_byzyh_tpu_torch.utils import evaluate

pytestmark = pytest.mark.slow  # a whole sequence (minutes on the CPU)


def _run(slam, second):
    g = graft.stereo_frames()
    for img, other, stamp in zip(g.left, second(g), g.stamps):
        slam.track(img, other, float(stamp))
    assert slam.status == OK
    traj = slam.trajectory
    stamps = np.array([s for s, _, _ in traj]) + slam.t0
    est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                  np.stack([t for _, _, t in traj]))
    ate, n_assoc = evaluate.ate_rmse(stamps, est, g.stamps, g.centres,
                                     with_scale=False)
    idx = np.searchsorted(g.stamps, stamps - 1e-6)
    length = np.linalg.norm(np.diff(est, axis=0), axis=-1).sum()
    true_len = np.linalg.norm(np.diff(g.centres[idx], axis=0),
                              axis=-1).sum()
    return len(traj), n_assoc, ate, abs(length - true_len) / true_len


def test_stereo_golden_gate():
    frames, n_assoc, ate, path_err = _run(
        StereoSlam(graft.stereo_golden_config(), device="cpu"),
        lambda g: g.right)
    assert n_assoc > graft.STEREO_MIN_FRAMES, frames
    assert ate < graft.STEREO_ATE_GATE_M, ate
    assert path_err < graft.STEREO_PATH_TOL, path_err


def test_rgbd_against_the_jax_run():
    frames, _, ate, _ = _run(
        RgbdSlam(graft.tum_rgbd_golden_config(max_kf=64, max_lm=16384),
                 device="cpu"), lambda g: g.depth)
    assert abs(frames - graft.RGBD_JAX_FRAMES) <= 1, frames
    assert ate < 1.5 * graft.RGBD_JAX_ATE_M + 0.002, ate
