"""Port parity: ``MonoSlam``'s chessboard world frame against the JAX
system's, on the committed chessboard frames at 640x512 (Mycamera's
intrinsics halved, its radtan, 1000 features, the map cut to
``graft.CHESS_CPU_SLOTS``).

Frame by frame from the JAX system's state (``test_torch_system._sync``;
the features extracted once and handed to both; the port's two-view
RANSAC given the JAX system's draws), through the snoop, the init, the
rebase and the frames after it. On the snoop frame both systems find the
board; the port poses it from the undistorted corners and lands nearer
the truth (the repair, ROADMAP section 3); from the next frame on the port
is handed the JAX system's board pose, as earlier parity files hand it the
JAX bundle's outputs.

The rebase: both move the map by the same M (the maps right after each
system's rebase agree within 1e-5). The JAX system moves the last frame's
pose but not the current frame's, builds the velocity from the two and
hosts that frame's keyframe at its old-frame pose (``system.py:552-575``):
its map and context mix the two frames and it loses track on the next
frame. A fault of the reference, repaired in the port, which moves the
frame's pose and track result with the map. On the rebase frame the
port's pose is held to the JAX pose moved by M; from the next frame on the
JAX system is given the port's state (map and host context) before each
frame, and both run it: frame by frame from the repaired state (the test's
repair; the JAX package is not edited).

The JAX side of that run is recorded (``tests/chessboard_parity.py``,
written by ``scripts/chessboard_parity_jax.py`` into
``tests/golden/chessboard_parity_jax.pkl.xz``): the tests replay the
port's side from the record (the JAX contexts it is synced from, the JAX
RANSAC draws) and compare it with the recorded JAX frames, without
compiling the JAX system.

A rebase-invariance case runs the port freely with and without the board:
up to the next keyframe, the frames after the rebase are the board-less
run's moved by M (within 1e-4). The stereo, RGB-D and inertial systems
ignore the chessboard configuration, as the JAX classes do.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from chessboard_parity import CFG, N_FRAMES, moved, replay
from torch_port_util import assert_states_close

from orbslam3_byzyh_tpu.pipeline import inertial_system as jinert
from orbslam3_byzyh_tpu.pipeline import stereo_inertial as jsi
from orbslam3_byzyh_tpu.pipeline import stereo_system as jstereo
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tinert
from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial as tsi
from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tstereo
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys
from orbslam3_byzyh_tpu_torch.utils import chessboard as tcb

CAM = CFG.cam_params()
_run = replay


def _assert_same(ref, got):
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert (got["pose"] is None) == (ref["pose"] is None)
    if ref["pose"] is not None:
        for a, b in zip(got["pose"], ref["pose"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert (got["bindings"] is None) == (ref["bindings"] is None)
    if ref["bindings"] is not None:
        np.testing.assert_array_equal(got["bindings"], ref["bindings"])
    assert_states_close(ref["state"], got["state"], CAM)


def test_sequence_does_its_work():
    """The JAX run snoops the board on the first frame, initialises, moves
    the map into the board's frame on the next tracked frame; both track
    at least 5 frames after it (from the repaired state)."""
    records, events = _run()
    assert events["snoop"] == 0
    r = events["rebase"]
    assert 0 < r <= N_FRAMES - 6
    assert all(rec[side]["status"] == tsys.OK for rec in records[r:]
               for side in ("jax", "port"))
    R_c, t_c = events["moved"]["jax"]["state"].kfs.R[0], \
        events["moved"]["jax"]["state"].kfs.t[0]
    np.testing.assert_allclose(R_c, records[r]["jax"]["chess_pose"][0],
                               atol=1e-5)
    np.testing.assert_allclose(t_c, records[r]["jax"]["chess_pose"][1],
                               atol=1e-5)


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_frame_matches_jax(i):
    records, events = _run()
    rec = records[i]
    if i == events["snoop"]:
        # Each side snooped with its own detector and PnP.
        assert rec["port"]["chess_pose"] is not None
        f = graft.chessboard_frames()
        board = CFG.chessboard
        ej = graft.chessboard_pose_error(*rec["jax"]["chess_pose"],
                                         f.R[i], f.t[i], board)
        ep = graft.chessboard_pose_error(*rec["port"]["chess_pose"],
                                         f.R[i], f.t[i], board)
        assert ep[0] < ej[0] and ep[1] < ej[1], (ep, ej)
        assert ep[0] < 0.5 and ep[1] < 0.005
    if i == events["rebase"]:
        # The maps right after each system's rebase, and the port's pose
        # against the JAX pose moved by M (the rest of the JAX frame is in
        # two frames at once: the fault).
        ref, got = events["moved"]["jax"], events["moved"]["port"]
        assert_states_close(ref["state"], got["state"], CAM, pose_atol=1e-5)
        for a, b in zip(rec["port"]["pose"], rec["jax_pose_moved"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        return
    _assert_same(rec["jax"], rec["port"])


def test_rebase_moves_what_holds_world_coordinates():
    """On the rebase frame the port's keyframe 0 is the board pose and the
    frame's pose is in the board's frame; the JAX system's frame pose is
    not (its fault): it is M away from the port's."""
    records, events = _run()
    r = events["rebase"]
    rec = records[r]["port"]
    R_c, t_c = rec["chess_pose"]
    np.testing.assert_allclose(rec["state"].kfs.R[0], R_c, atol=1e-5)
    np.testing.assert_allclose(rec["state"].kfs.t[0], t_c, atol=1e-5)
    gap = np.abs(np.asarray(records[r]["jax"]["pose"][0], np.float64)
                 - rec["pose"][0]).max()
    assert gap > 0.1, gap


def test_rebase_invariance():
    """The port run freely with and without the board: from the rebase to
    the next keyframe, each frame's pose is the board-less run's moved by
    M, within 1e-4."""
    f = graft.chessboard_frames()
    poses, rebase = {}, {}
    for name, cfg in (("board", CFG),
                      ("none", dataclasses.replace(CFG, chessboard=None))):
        slam = tsys.MonoSlam(cfg, device="cpu")
        seen, kfs = [], []
        for i in range(8):
            p = slam.track(f.frames_half[i], float(f.stamps[i]))
            seen.append(p)
            kfs.append(slam.n_kf)
            if name == "board" and slam._chess_applied and not rebase:
                rebase.update(i=i, n_kf=slam.n_kf)
        poses[name] = (seen, kfs)
        if name == "board":
            R0 = slam.state.kfs.R[0].numpy()
            t0 = slam.state.kfs.t[0].numpy()
        else:
            R0s = slam.state.kfs.R[0].numpy()
            t0s = slam.state.kfs.t[0].numpy()
    # M = Tc_board^-1 Tc_slam at keyframe 0, from the two runs' keyframe 0.
    R_w, t_w = (a.numpy() for a in tcb.rebase_transform(
        *(torch.from_numpy(a) for a in (R0, t0, R0s, t0s))))
    i, kfs = rebase["i"], poses["board"][1]
    held = 0
    for j in range(i, 8):
        if kfs[j] != kfs[i]:
            break
        Rb, tb = poses["board"][0][j]
        Rn, tn = poses["none"][0][j]
        Rm, tm = moved(Rn, tn, R_w, t_w)
        np.testing.assert_allclose(Rb, Rm, atol=1e-4)
        np.testing.assert_allclose(tb, tm, atol=1e-4)
        held += 1
    assert held >= 1


@pytest.mark.parametrize("cls", ["StereoSlam", "RgbdSlam", "MonoInertialSlam",
                                 "StereoInertialSlam"])
def test_other_systems_ignore_the_board(cls):
    """The stereo, RGB-D and inertial classes never snoop: in the JAX
    package their ``track`` does not call ``_snoop_chessboard``; the port's
    builds with a board and tracks a frame without snooping."""
    jcls = {"StereoSlam": jstereo.StereoSlam, "RgbdSlam": jstereo.RgbdSlam,
            "MonoInertialSlam": jinert.MonoInertialSlam,
            "StereoInertialSlam": jsi.StereoInertialSlam}[cls]
    assert "_snoop_chessboard" not in inspect.getsource(jcls.track)
    tcls = {"StereoSlam": tstereo.StereoSlam, "RgbdSlam": tstereo.RgbdSlam,
            "MonoInertialSlam": tinert.MonoInertialSlam,
            "StereoInertialSlam": tsi.StereoInertialSlam}[cls]
    assert "_snoop_chessboard" not in inspect.getsource(tcls.track)
    if cls not in ("StereoSlam", "MonoInertialSlam"):
        return
    calls = []
    if cls == "StereoSlam":
        g = graft.stereo_frames()
        slam = tstereo.StereoSlam(graft.stereo_golden_config(
            chessboard=graft.MYCAMERA_BOARD), device="cpu")
        slam._snoop_chessboard = calls.append
        slam.track(g.left[0], g.right[0], float(g.stamps[0]))
        assert slam.status == tsys.OK
    else:
        g, setup = graft.vi_mono_frames(), graft.mono_inertial_golden_config(
            chessboard=graft.MYCAMERA_BOARD)
        slam = tinert.MonoInertialSlam(setup.config, setup.imu,
                                       **setup.viba, device="cpu")
        slam._snoop_chessboard = calls.append
        slam.track(g.left[0], float(g.stamps[0]), g.imu(0))
    assert calls == [] and slam._chess_pose is None
