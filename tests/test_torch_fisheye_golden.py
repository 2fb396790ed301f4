"""The non-rectified (fisheye) systems' gates on the port, on the CPU.
``chip_smoke.py`` phase "14 fisheye" runs the same gates on the card, (h)
at TUM-VI 512's full capacity.

  (g) ``FisheyeStereoSlam`` at tests/test_fisheye_stereo_system.py's
      configuration (``graft.fisheye_stereo_golden_config()``) on
      ``graft.fisheye_frames()``: status OK, a keyframe, more than 50
      landmarks, more than 20 frames, the ATE without scale alignment under
      0.15 m and under 1.5 x the JAX system's on the same frames +
      0.002 m, the path length within 8 %.
  (h) ``FisheyeStereoInertialSlam`` at ``graft.tumvi_vi_golden_config()``
      on the stereo-inertial frames warped to TUM-VI's 512x512
      Kannala-Brandt pair (``graft.tumvi_vi_frames()``), with the map cut
      to the JAX reference run's 48 / 4096 / 8 slots and VI-BA 12 / 6 /
      1024 / 32 (the full capacity is the card's): (d)'s gates,
      ``imu_ready``, at least 35 frames, the ATE without scale alignment
      under 0.15 m and under 1.5 x the JAX system's + 0.002 m, the speed
      within 0.3 m/s.

The JAX systems' runs are the recorded constants
``graft.FISHEYE_JAX_ATE_M`` and ``TUMVI_VI_JAX_ATE_M``
(``scripts/fisheye_reference_jax.py``); ``test_jax_reference_is_recorded``
re-runs them and checks the constants.
"""

import json
import os
import subprocess
import sys

import pytest
import torch_port_util  # noqa: F401  (caps torch at 2 threads a worker)

from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
    FisheyeStereoInertialSlam
from orbslam3_byzyh_tpu_torch.pipeline.stereo_system import FisheyeStereoSlam
from orbslam3_byzyh_tpu_torch.pipeline.system import OK

pytestmark = pytest.mark.slow  # whole sequences (minutes on the CPU)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_fisheye_stereo_golden_gate():
    g = graft.fisheye_frames()
    slam = FisheyeStereoSlam(graft.fisheye_stereo_golden_config(g),
                             device="cpu")
    for left, right, stamp in zip(g.left, g.right, g.stamps):
        slam.track(left, right, float(stamp))
    out = graft.fisheye_gates(slam.trajectory, slam.t0, g)
    assert slam.status == OK and slam.n_kf >= 1 and slam.n_lm > 50
    assert out["ok"], out
    assert out["ate_m"] < graft.FISHEYE_JAX_ATE_GATE_M, out


def test_tumvi_stereo_inertial_gate():
    g = graft.tumvi_vi_frames()
    s = graft.tumvi_vi_golden_config(**graft.TUMVI_VI_CPU_SLOTS)
    slam = FisheyeStereoInertialSlam(s.config, s.imu,
                                     **graft.TUMVI_VI_CPU_VIBA, device="cpu")
    for i, (left, right, stamp) in enumerate(zip(g.left, g.right,
                                                 g.stamps)):
        slam.track(left, right, float(stamp), g.imu(i))
    assert slam.status == OK and slam.imu_ready
    out = graft.vi_gates("stereo", slam.trajectory, slam.t0, g,
                         slam._body[2].numpy())
    assert out["ok"], out
    assert out["ate_m"] < graft.TUMVI_VI_JAX_ATE_GATE_M, out


@pytest.mark.parametrize("kind", ["stereo", "vi"])
def test_jax_reference_is_recorded(kind):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "fisheye_reference_jax.py"), kind],
        capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = (graft.FISHEYE_JAX_ATE_M if kind == "stereo"
            else graft.TUMVI_VI_JAX_ATE_M)
    assert out["ate_m"] == pytest.approx(want, rel=1e-6), out
