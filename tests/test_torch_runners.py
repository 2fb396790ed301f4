"""The port's dataset runners (``runners.py``) on their small fabricated
datasets on the CPU, part 1: EuRoC stereo-inertial (the flagship) and
KITTI stereo; the ``--snapshot-every`` guard.

For each runner: its files are written, in its JAX runner's names and
formats; what its frame loop hands the system equals the JAX runner's
frame loop on the same files (``cv2.imread``, ``rig.rectify`` with
``cv2.remap`` within 1e-4 -- the device remap's float32 arithmetic against
OpenCV's --, otherwise bit for bit; the stamps and the IMU batches
equal); its poses equal the same port system driven directly with those
frames. ``test_torch_runners_more.py`` holds the other four runners.
"""

import os

import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu_torch import graft, runners
from orbslam3_byzyh_tpu_torch.io import png, rectify
from torch_runner_util import (Run, assert_calls_equal,
                               assert_direct_drive_equal, assert_outputs,
                               jax_calls)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stereo_inertial(tmp_path_factory):
    return Run("euroc_stereo_inertial", tmp_path_factory.mktemp("si"), 8)


def test_stereo_inertial_files_and_lines(stereo_inertial, capfd):
    run = stereo_inertial
    assert_outputs(run)
    assert len(run.result.slam.trajectory) == run.d.n_frames
    with open(run.result.outputs[2]) as f:
        assert f.readline().split()[0] == "stage"


def test_stereo_inertial_frames_equal_the_jax_runners(stereo_inertial):
    assert_calls_equal(stereo_inertial, jax_calls(stereo_inertial),
                       image_tol=1e-4)


def test_stereo_inertial_direct_drive(stereo_inertial):
    assert_direct_drive_equal(stereo_inertial)


def test_stereo_inertial_rig_and_tbc_repair(stereo_inertial):
    """The rig the runner built is the yaml's Bouguet rectification, and
    the system got the rectified camera's IMU extrinsic (the intended
    difference from the JAX runner: the yaml's T_b_c1 is off by R1)."""
    run = stereo_inertial
    rig = run.result.rig
    raw = graft.euroc_raw_rig(0.5)
    np.testing.assert_allclose(rig.R1, raw.R_raw1.T, atol=1e-12)
    want = rectify.rectified_body_extrinsic(np.eye(4), rig.R1)
    np.testing.assert_allclose(run.result.T_bc, want, atol=1e-12)
    np.testing.assert_allclose(run.result.slam.imu_cfg.T_bc,
                               want.astype(np.float32), atol=0)
    cfg = run.result.slam.cfg
    assert (cfg.fx, cfg.cx, cfg.cy, cfg.bf) == (rig.fx, rig.cx, rig.cy,
                                               rig.bf)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return Run("kitti", tmp_path_factory.mktemp("kitti"), 8)


def test_kitti_files(kitti):
    assert_outputs(kitti)
    rows = np.loadtxt(kitti.result.outputs[0])
    assert rows.shape == (len(kitti.result.slam.trajectory), 12)


def test_kitti_frames_equal_the_jax_runners(kitti):
    assert_calls_equal(kitti, jax_calls(kitti))


def test_kitti_direct_drive(kitti):
    assert_direct_drive_equal(kitti)


@pytest.mark.parametrize("main", ["main_euroc_mono",
                                  "main_euroc_mono_inertial",
                                  "main_euroc_stereo_inertial"])
def test_snapshot_every_raises_naming_the_viewer_item(main, tmp_path):
    # The viewer (ROADMAP item 15d) is ported: ``--snapshot-every`` no
    # longer raises but writes the map every N frames beside the runner's
    # other files (test_torch_viewer.py holds the images).
    kind = {"main_euroc_mono": "euroc_mono",
            "main_euroc_mono_inertial": "euroc_mono_inertial",
            "main_euroc_stereo_inertial": "euroc_stereo_inertial"}[main]
    d = graft.write_runner_dataset(kind, str(tmp_path / "data"), n_frames=2,
                                   small=True)
    res = getattr(runners, main)(d.argv + ["--device", "cpu", "--max-kf",
                                           "48", "--max-lm", "8192",
                                           "--snapshot-every", "1"],
                                 out_dir=str(tmp_path))
    snaps = [os.path.basename(p) for p in res.outputs if p.endswith(".png")]
    assert snaps == ["map_00001.png", "map_00002.png"]
    assert png.read_rgb(str(tmp_path / snaps[-1])).shape == (480, 640, 3)


def test_runners_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = graft.write_runner_dataset("euroc_mono", str(tmp_path), n_frames=1,
                                   small=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runners.main_euroc_mono(d.argv)
