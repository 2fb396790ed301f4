"""Port parity: ``utils/chessboard.py`` against the JAX package's (OpenCV's
``findChessboardCornersSB`` and ``solvePnP``).

The detector is not OpenCV's, so it is held to the truth and to OpenCV's
error on the same image, not bit for bit:

  * ``tests/test_chessboard.py``'s three cases, replayed;
  * a grid of poses (tilt 0-50 degrees, distance 0.3-1.5 m, in-plane
    turns) of that test's board: on every image where OpenCV finds the
    board the port finds it too. The renders are drawn as that test draws
    them (polygons without anti-aliasing), and again area-sampled (each
    pixel the mean of 8 x 8 samples, as a camera's pixel integrates
    light): a point-sampled edge moves a corner by up to half a pixel, so
    the accuracy gate (mean error within OpenCV's + 0.05 px, largest 0.5 px)
    is held on the area-sampled renders;
  * the committed chessboard frames (Mycamera's 1280x1024 and its half
    size, through its radtan): the same gates against the true corners;
  * noise, a board cut by the image border and frames with no board give
    None;
  * the device reads: two for the detector, one for the pose.

The planar pose, on the same corners, agrees with the JAX function (IPPE
and the iterative refine) up to the board's 180-degree symmetry within
1e-3 rad and 1 mm. Intended difference: a tie within 1e-6 px goes to the
first ordering (the JAX loop picks by float noise). The repair: with the
camera's radtan coefficients the port undistorts the corners before the
PnP, where the JAX function poses the distorted corners with K alone; on
the distorted renders its error against the truth is below the JAX
function's. ``rebase_transform`` and ``rebase_map`` agree with the JAX
functions within 1e-6 and 1e-5.
"""

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (caps torch's threads)
from scipy.spatial.transform import Rotation
from test_chessboard import CFG as JCFG
from test_chessboard import K, gt_pose, render_board
from test_torch_atlas_merge import random_map
from torch_port_util import jax_map_state

from orbslam3_byzyh_tpu.utils import chessboard as jcb
from orbslam3_byzyh_tpu_torch import convert, device, graft
from orbslam3_byzyh_tpu_torch.utils import chessboard as tcb

CFG = tcb.ChessboardConfig(**JCFG.__dict__)
SS = 8


def _truth(R, t, cfg=CFG, K_=K):
    pc = tcb.board_world_points(cfg) @ R.T + t
    uv = pc @ K_.T
    return uv[:, :2] / uv[:, 2:]


def _errors(corners, truth):
    """Each corner's distance to its nearest true corner (the grid order
    may differ by the board's symmetries)."""
    d = np.linalg.norm(corners[:, None] - truth[None], axis=-1)
    return np.where(np.isfinite(d), d, np.inf).min(1)


def _flip_err(pose, ref, board=CFG):
    """(rotation rad, centre m) between two poses up to the board's
    symmetry about its centre."""
    R, t = (np.asarray(x, np.float64) for x in pose)
    Rr, tr = (np.asarray(x, np.float64) for x in ref)
    Rf, tf = graft.chessboard_flip(board)
    out = []
    for flip in (False, True):
        Rq = Rr @ Rf if flip else Rr
        tq = Rr @ tf + tr if flip else tr
        ang = np.arccos(np.clip((np.trace(R.T @ Rq) - 1) / 2, -1, 1))
        out.append((ang, np.linalg.norm(-R.T @ t + Rq.T @ tq)))
    return min(out)


def _look(tilt, dist, turn):
    """A camera ``dist`` m from the board's centre, its axis ``tilt``
    degrees off the board's normal, turned ``turn`` degrees about it."""
    ctr = np.array([CFG.start_x + 4 * CFG.square_size,
                    CFG.start_y + 2.5 * CFG.square_size, 0.0])
    az = np.radians(30 + turn)
    d = np.array([np.sin(np.radians(tilt)) * np.cos(az),
                  np.sin(np.radians(tilt)) * np.sin(az),
                  np.cos(np.radians(tilt))])
    C = ctr + dist * d
    z = (ctr - C) / dist
    x = np.cross(z, [0, 1, 0.0]) if abs(z[1]) < 0.9 else np.cross(z, [1, 0, 0.])
    x /= np.linalg.norm(x)
    R_wc = np.stack([x, np.cross(z, x), z], 1) @ Rotation.from_euler(
        "z", turn, degrees=True).as_matrix()
    return R_wc.T, -R_wc.T @ C


def _render(R_cw, t_cw, area, w=640, h=480):
    """``test_chessboard.render_board``'s board with the polygons at
    1/16-px precision; ``area``: drawn at 8x and area-averaged."""
    import cv2
    s = SS if area else 1
    img = np.full((h * s, w * s), 180, np.uint8)
    sq = CFG.square_size
    for i in range(CFG.height + 1):
        for j in range(CFG.width + 1):
            if (i + j) % 2 == 0:
                continue
            x0, y0 = CFG.start_x + (j - 1) * sq, CFG.start_y + (i - 1) * sq
            cw = np.array([[x0, y0, 0], [x0 + sq, y0, 0],
                           [x0 + sq, y0 + sq, 0], [x0, y0 + sq, 0]])
            pc = cw @ R_cw.T + t_cw
            if (pc[:, 2] <= 0.05).any():
                continue
            uv = pc @ K.T
            uv = uv[:, :2] / uv[:, 2:3]
            uv = (uv + 0.5) * s - 0.5
            cv2.fillConvexPoly(img, np.round(uv * 16).astype(np.int32), 20,
                               cv2.LINE_8, 4)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA) if area \
        else img


POSES = [(tilt, dist, turn) for tilt in (0, 25, 50)
         for dist in (0.3, 0.8, 1.5) for turn in (0, 60, 140)]


# --- test_chessboard.py's cases -------------------------------------------

def test_detect_and_pose():
    """``TestChessboard.test_detect_and_pose``, through the port."""
    R_cw, t_cw = gt_pose()
    img = render_board(R_cw, t_cw)
    corners = tcb.detect_chessboard(img, CFG, device="cpu")
    assert corners is not None and corners.shape == (54, 2)
    assert corners.dtype == np.float64
    pose = tcb.pose_from_chessboard(corners, CFG, K, device="cpu")
    assert pose is not None
    R_est, t_est = pose
    C_est, C_gt = -R_est.T @ t_est, -R_cw.T @ t_cw
    assert abs(C_est[2] - C_gt[2]) < 0.01
    assert abs(R_est[2][2] - R_cw[2][2]) < 0.02
    errs = []
    for Ry in (np.eye(3), np.diag([-1.0, -1.0, 1.0])):
        dR = (R_est @ Ry).T @ R_cw
        errs.append(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                                 -1, 1))))
    assert min(errs) < 1.0, errs


def test_no_board_returns_none(rng):
    img = rng.integers(0, 255, (480, 640), dtype=np.uint8)
    assert tcb.detect_chessboard(img, CFG, device="cpu") is None


def test_rebase_transform_consistency():
    R_chess, t_chess = gt_pose()
    R_slam = Rotation.from_euler("xyz", [5, -3, 8], degrees=True).as_matrix()
    t_slam = np.array([0.1, -0.2, 0.4])
    R_m, t_m = tcb.rebase_transform(R_chess, t_chess,
                                    R_slam.astype(np.float32),
                                    t_slam.astype(np.float32))
    R_m, t_m = R_m.numpy(), t_m.numpy()
    p_s = np.array([0.3, 0.1, 2.0], np.float32)
    np.testing.assert_allclose(R_slam @ p_s + t_slam,
                               R_chess @ (R_m @ p_s + t_m) + t_chess,
                               atol=1e-5)


# --- the detector ---------------------------------------------------------

def test_pose_grid_finds_what_opencv_finds():
    """On each render where OpenCV finds the board, the port finds it too;
    on the area-sampled renders its mean corner error is within OpenCV's +
    0.05 px and its largest 0.5 px."""
    import cv2
    found_cv = both = 0
    worst = 0.0
    for pose in POSES:
        R, t = _look(*pose)
        truth = _truth(R, t)
        for area in (False, True):
            img = _render(R, t, area)
            ok, cc = cv2.findChessboardCornersSB(img, (9, 6))
            c = tcb.detect_chessboard(img, CFG, device="cpu")
            if not ok:
                continue
            found_cv += 1
            assert c is not None, (pose, area)
            both += 1
            if area:
                e, e_cv = _errors(c, truth), _errors(cc.reshape(-1, 2), truth)
                assert e.mean() <= e_cv.mean() + 0.05, (pose, e.mean(),
                                                        e_cv.mean())
                worst = max(worst, e.max())
    assert found_cv >= 40 and both == found_cv
    assert worst <= 0.5, worst


@pytest.mark.parametrize("half", [False, True], ids=["1280x1024", "640x512"])
def test_fixture_corners(half):
    """The committed frames: the board found on every frame OpenCV found it
    on (and on no frame without the whole board), within OpenCV's error +
    0.05 px and 0.5 px of the truth."""
    f = graft.chessboard_frames()
    frames = f.frames_half if half else f.frames
    truth = f.corners_half if half else f.corners
    cv_err = f.cv_err_half if half else f.cv_err
    full = np.isfinite(truth).all((1, 2))
    for i in range(0, len(frames), 2):
        c = tcb.detect_chessboard(frames[i], graft.MYCAMERA_BOARD,
                                  device="cpu")
        if np.isfinite(cv_err[i]):
            assert c is not None, i
        if c is None:
            continue
        assert full[i], i
        e = _errors(c, truth[i])
        assert e.max() <= 0.5 and e.mean() <= cv_err[i] + 0.05, (i, e)


def test_partial_board_and_no_board_return_none():
    """A board cut by the image border (the fixture's frames as the board
    leaves, and a render whose board runs off the image) and frames with
    no board give None."""
    f = graft.chessboard_frames()
    cut = [i for i in range(len(f.stamps))
           if np.isfinite(f.corners_half[i]).any()
           and not np.isfinite(f.corners_half[i]).all()]
    gone = [i for i in range(len(f.stamps))
            if not np.isfinite(f.corners_half[i]).any()]
    assert cut and gone
    for i in cut[:3] + gone[-2:]:
        assert tcb.detect_chessboard(f.frames_half[i], graft.MYCAMERA_BOARD,
                                     device="cpu") is None, i
    R, t = _look(0, 0.5, 0)
    img = np.roll(_render(R, t, True), 280, axis=1)
    img[:, :280] = 180
    assert tcb.detect_chessboard(img, CFG, device="cpu") is None


def test_reads(monkeypatch):
    """Two reads for a found board (one where no lattice closes), one for
    the pose; ``graft.chessboard_pose`` makes three."""
    n = [0]
    read = device.read

    def counted(*a, **kw):
        n[0] += 1
        return read(*a, **kw)

    monkeypatch.setattr(device, "read", counted)
    R, t = _look(25, 0.8, 60)
    img = torch.tensor(_render(R, t, True))
    c = tcb.detect_chessboard(img, CFG)
    assert c is not None and n[0] == 2
    tcb.pose_from_chessboard(c, CFG, K, device="cpu")
    assert n[0] == 3
    n[0] = 0
    assert tcb.detect_chessboard(torch.zeros(480, 640), CFG) is None
    assert n[0] == 1
    n[0] = 0
    cam = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    out = graft.chessboard_pose(img.float(), CFG, cam)
    assert out.R is not None and n[0] == 3


# --- the planar pose --------------------------------------------------------

def _pose_cases():
    R, t = gt_pose()
    cases = [render_board(R, t)]
    for pose in POSES[::4]:
        cases.append(_render(*_look(*pose), True))
    return cases


def test_pose_equals_jax_up_to_flip():
    """On the same corners (OpenCV's), with dist=None: within 1e-3 rad and
    1 mm of the JAX function's pose, up to the board's symmetry; each
    ordering's pose as the JAX ``_pose_one_ordering``'s."""
    n_cases = 0
    for img in _pose_cases():
        cj = jcb.detect_chessboard(img, JCFG)
        if cj is None:
            continue
        n_cases += 1
        pj = jcb.pose_from_chessboard(cj, JCFG, K)
        pt = tcb.pose_from_chessboard(cj, CFG, K, device="cpu")
        assert (pj is None) == (pt is None)
        if pj is None:
            continue
        ang, cen = _flip_err(pt, pj)
        assert ang < 1e-3 and cen < 1e-3, (ang, cen)
        grid = cj.reshape(6, 9, 2)
        for order in (grid, grid[::-1], grid[:, ::-1], grid[::-1, ::-1]):
            cand = order.reshape(-1, 2)
            oj = jcb._pose_one_ordering(cand, JCFG, K)
            ot = tcb._pose_one_ordering(cand, CFG, K, device="cpu")
            if oj is None or ot is None:
                continue
            ej = jcb._reproj_err(oj, JCFG, K, cand)
            et = tcb._reproj_err(ot, CFG, K, cand)
            assert et <= ej + 1e-3
            if ej < 3.0:
                a, c = _flip_err(ot, oj)
                assert a < 1e-3 and c < 1e-3
    assert n_cases >= 5


def test_tie_goes_to_first_ordering():
    """Exact corners: the two orderings above the board tie to float
    rounding; the port takes the first (the detector's own order)."""
    R, t = gt_pose()
    uv = _truth(R, t)
    pose = tcb.pose_from_chessboard(uv, CFG, K, device="cpu")
    R_e, _ = pose
    # The detector's order is the world's: no flip.
    assert np.abs(R_e - R).max() < 1e-5


def test_distortion_repair():
    """On the committed frames (Mycamera's radtan), the JAX function's pose
    of the distorted corners is off by degrees; with ``dist`` the port's is
    within 0.1 degree and 1 mm of the truth, and with ``dist=None`` it
    equals the JAX function's."""
    f = graft.chessboard_frames()
    cam = f.camera
    K_m = np.array([[cam[0], 0, cam[2]], [0, cam[1], cam[3]], [0, 0, 1.0]])
    board = graft.MYCAMERA_BOARD
    jboard = jcb.ChessboardConfig(**board.__dict__)
    errs = []
    for i in (0, 4, 8):
        corners = f.cv_corners[i]
        truth = (f.R[i], f.t[i])
        pj = jcb.pose_from_chessboard(corners, jboard, K_m)
        p0 = tcb.pose_from_chessboard(corners, board, K_m, device="cpu")
        pd = tcb.pose_from_chessboard(corners, board, K_m, dist=cam[6:10],
                                      device="cpu")
        a0, c0 = _flip_err(p0, pj, board)
        assert a0 < 1e-3 and c0 < 1e-3
        ej = graft.chessboard_pose_error(*pj, *truth, board)
        ed = graft.chessboard_pose_error(*pd, *truth, board)
        errs.append((ej[:2], ed[:2]))
        assert ed[0] < 0.1 and ed[1] < 1e-3, ed
        assert ed[0] < ej[0] and ed[1] < ej[1], (ej, ed)
    assert max(e[0][0] for e in errs) > 0.5, errs


# --- the rebase -----------------------------------------------------------

def test_rebase_transform_equals_jax(rng):
    for _ in range(5):
        Rc = Rotation.random(random_state=rng.integers(1 << 30)).as_matrix()
        Rs = Rotation.random(random_state=rng.integers(1 << 30)).as_matrix()
        tc, ts = rng.normal(size=3), rng.normal(size=3)
        args = (Rc.astype(np.float32), tc.astype(np.float32),
                Rs.astype(np.float32), ts.astype(np.float32))
        Rj, tj = jcb.rebase_transform(*args)
        Rt, tt = tcb.rebase_transform(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6)


def test_rebase_map_equals_jax(rng):
    state, _ = random_map(rng, (16, 256, 4, 32), 9, 200)
    R_m = Rotation.random(random_state=7).as_matrix().astype(np.float32)
    t_m = rng.normal(size=3).astype(np.float32)
    ref = jcb.rebase_map(jax_map_state(state), R_m, t_m)
    got = tcb.rebase_map(convert.map_state_to_torch(state, "cpu"),
                         torch.from_numpy(R_m), torch.from_numpy(t_m))
    for part in ("kfs", "lms"):
        for name in getattr(ref, part)._fields:
            a = np.asarray(getattr(getattr(ref, part), name))
            b = convert.to_numpy(getattr(getattr(got, part), name))
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)
