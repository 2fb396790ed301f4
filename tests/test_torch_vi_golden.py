"""The inertial systems' gates on the port, on the CPU, on the committed VI
frames. ``chip_smoke.py`` phase "13 inertial system" runs the same gates on
the card, and (f), the stereo frames at the EuRoC stereo-inertial
capacity.

  (d) ``StereoInertialSlam`` at tests/test_stereo_inertial.py's
      configuration (``graft.stereo_inertial_golden_config()``) on
      ``graft.vi_stereo_frames()``: ``imu_ready``, at least 35 frames, the
      ATE without scale alignment under 0.15 m and under 1.5 x the JAX
      system's on the same frames + 0.002 m, the speed within 0.3 m/s at
      the last frame.
  (e) ``MonoInertialSlam`` at tests/test_inertial_system.py's
      (``graft.mono_inertial_golden_config()``) on
      ``graft.vi_mono_frames()``: ``imu_ready`` and VIBA1 done, at least 50
      frames; after 3 s the Horn scale within 0.25 of 1, the ATE under
      0.30 m, the gravity axis within 10 deg; no single-frame outlier; the
      speed within 0.3 m/s.

The JAX systems' runs on the same frames are the recorded constants
``graft.VI_STEREO_JAX_ATE_M`` and ``VI_MONO_JAX_ATE_M``
(``scripts/vi_reference_jax.py``); ``test_jax_reference_is_recorded``
re-runs them and checks the constants.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch_port_util  # noqa: F401  (caps torch at 2 threads a worker)

from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.pipeline.inertial_system import MonoInertialSlam
from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
    StereoInertialSlam
from orbslam3_byzyh_tpu_torch.pipeline.system import OK

pytestmark = pytest.mark.slow  # whole sequences (minutes on the CPU)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(kind):
    if kind == "stereo":
        g, s = graft.vi_stereo_frames(), graft.stereo_inertial_golden_config()
        slam = StereoInertialSlam(s.config, s.imu, **s.viba, device="cpu")
        images = list(zip(g.left, g.right))
    else:
        g, s = graft.vi_mono_frames(), graft.mono_inertial_golden_config()
        slam = MonoInertialSlam(s.config, s.imu, **s.viba, device="cpu")
        images = [(f,) for f in g.left]
    for i, (imgs, stamp) in enumerate(zip(images, g.stamps)):
        slam.track(*imgs, float(stamp), g.imu(i))
    assert slam.status == OK and slam.imu_ready
    return slam, graft.vi_gates(kind, slam.trajectory, slam.t0, g,
                                slam._body[2].numpy())


def test_stereo_inertial_golden_gate():
    _, out = _run("stereo")
    assert out["ok"], out
    assert out["ate_m"] < graft.VI_STEREO_JAX_ATE_GATE_M, out


def test_mono_inertial_golden_gate():
    slam, out = _run("mono")
    assert slam.viba_stage >= 2
    assert out["ok"], out


@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_jax_reference_is_recorded(kind):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "vi_reference_jax.py"),
         kind], capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = (graft.VI_STEREO_JAX_ATE_M if kind == "stereo"
            else graft.VI_MONO_JAX_ATE_M)
    np.testing.assert_allclose(out["ate_m"], want, rtol=1e-6)
    assert out["ok"] and out["imu_ready"], out
