"""The port's dataset runners (``runners.py``) on their small fabricated
datasets on the CPU, part 2: EuRoC monocular, EuRoC mono-inertial with
``--clahe``, TUM RGB-D and TUM-VI (CLAHE on), as
``test_torch_runners.py`` holds the other two: the files, the frames
handed to the system equal the JAX runner's frame loop's on the same files
bit for bit (``cv2.imread``, cv2's CLAHE, the depth divided by its PNG
factor, the stamps and the IMU batches), the poses equal the same system
driven directly.
"""

import numpy as np
import pytest
import torch

from torch_runner_util import (Run, assert_calls_equal,
                               assert_direct_drive_equal, assert_outputs,
                               jax_calls)

torch.set_num_threads(2)

# (kind, frames, small): EuRoC mono at its full 640x480 (at half size the
# world's frames do not initialise within 10 frames), the rest at half size.
CASES = {"euroc_mono": (6, False), "euroc_mono_inertial": (6, True),
         "tum_rgbd": (8, True), "tumvi": (6, True)}


@pytest.fixture(scope="module", params=list(CASES))
def run(request, tmp_path_factory):
    n, small = CASES[request.param]
    return Run(request.param, tmp_path_factory.mktemp(request.param), n,
               small=small)


def test_files(run):
    assert_outputs(run)


def test_frames_equal_the_jax_runners(run):
    assert_calls_equal(run, jax_calls(run))


def test_direct_drive(run):
    assert_direct_drive_equal(run)


def test_tracking(run):
    """Each dataset initialises where its system does on the fixture:
    EuRoC mono two-view on frame 4 (the radtan warp's background corners
    cost it two frames against the golden run's frame 2), mono-inertial
    two-view, RGB-D on frame 0; TUM-VI never at its runner's default
    init gates (300 depth points; the world gives 84-153, as cell (h))."""
    traj = run.result.slam.trajectory
    if run.d.kind == "tumvi":
        assert not traj
        return
    assert traj
    slam = run.result.slam
    first = int(np.argmin(np.abs(run.d.stamps - (traj[0][0] + slam.t0))))
    assert first == 0 or run.d.kind != "tum_rgbd"
