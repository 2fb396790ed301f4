"""Shared by ``test_torch_runners*.py``: run a port runner on its small
fabricated dataset on the CPU, recording what its frame loop handed the
system, and the JAX runner's preprocessing of the same files (OpenCV)."""

import os

import cv2
import numpy as np
import torch

from orbslam3_byzyh_tpu.io import euroc as jeuroc
from orbslam3_byzyh_tpu.io import kitti as jkitti
from orbslam3_byzyh_tpu.io import rectify as jrectify
from orbslam3_byzyh_tpu.io import settings as jsettings
from orbslam3_byzyh_tpu.io import trajectory as jtrajectory
from orbslam3_byzyh_tpu.io import tum_rgbd as jtum
from orbslam3_byzyh_tpu_torch import graft, runners

# Reduced slots for the CPU (the systems' 32-keyframe BA window and 4096
# landmark window need at least these).
SLOTS = ["--max-kf", "48", "--max-lm", "8192"]


class Run:
    """A runner's run: its result, the (args) of each ``track`` call (the
    tensors copied), the dataset and the printed output."""

    def __init__(self, kind, root, n_frames, small=True, extra=(),
                 capsys=None):
        self.d = graft.write_runner_dataset(kind, str(root / "data"),
                                            n_frames=n_frames, small=small)
        self.out = root / "out"
        self.out.mkdir()
        self.calls = []
        main = getattr(runners, self.d.main)
        self.result = main(self.d.argv + ["--device", "cpu"] + SLOTS
                           + list(extra), out_dir=str(self.out),
                           on_system=self._record)
        self.printed = capsys.readouterr().out if capsys else ""

    def _record(self, slam):
        track = slam.track

        def recorded(*args):
            self.calls.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args))
            return track(*args)

        slam.track = recorded


def _imread(path, flag=cv2.IMREAD_GRAYSCALE):
    return cv2.imread(path, flag).astype(np.float32)


def _clahe(img):
    return cv2.createCLAHE(3.0, (8, 8)).apply(img.astype(np.uint8)).astype(
        np.float32)


def jax_calls(run: Run) -> list:
    """The ``track`` arguments of the JAX runner's frame loop on the same
    files: its loaders, ``cv2.imread``, its ``rig.rectify`` (cv2.remap) and
    cv2's CLAHE, its IMU batches."""
    d, n = run.d, run.d.n_frames
    out = []
    if d.kind in ("euroc_stereo_inertial", "euroc_mono",
                  "euroc_mono_inertial", "tumvi"):
        sl = jeuroc.load_euroc(d.sequence, cam="cam0")
        stereo = d.kind in ("euroc_stereo_inertial", "tumvi")
        sr = jeuroc.load_euroc(d.sequence, cam="cam1") if stereo else None
        rig = None
        if d.kind == "euroc_stereo_inertial":
            s = jsettings.load_settings(d.settings)
            rig = jrectify.build_rectification(s.cam1, s.cam2, s.Tlr)
        t_prev = None
        for i in range(n):
            t = float(sl.stamps[i])
            imgs = [_imread(sl.image_paths[i])]
            if stereo:
                imgs.append(_imread(sr.image_paths[i]))
            if rig is not None:
                imgs = list(rig.rectify(*imgs))
            if d.clahe:
                imgs = [_clahe(im) for im in imgs]
            imu = ((sl.imu_between(t_prev, t) if t_prev is not None
                    else None),) if d.kind != "euroc_mono" else ()
            out.append((*imgs, t, *imu))
            t_prev = t
    elif d.kind == "kitti":
        seq = jkitti.load_kitti(d.sequence)
        out = [(seq.read_image(i), seq.read_image(i, right=True),
                float(seq.stamps[i])) for i in range(n)]
    else:
        seq = jtum.load_tum_rgbd(d.sequence)
        out = [(*seq.read_pair(i), float(seq.stamps[i])) for i in range(n)]
    return out


def assert_calls_equal(run: Run, ref: list, image_tol: float = 0.0):
    """The runner's ``track`` arguments equal the JAX runner's: images
    within ``image_tol`` (0: bit for bit), stamps and IMU batches equal."""
    assert len(run.calls) == len(ref) == run.d.n_frames
    for got, want in zip(run.calls, ref):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(g, torch.Tensor):
                assert g.dtype == torch.float32
                diff = np.abs(g.numpy() - np.asarray(w, np.float32)).max()
                assert diff <= image_tol, diff
            elif g is None or w is None:
                assert g is None and w is None
            elif isinstance(g, tuple):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            else:
                assert g == w


def twin_of(slam):
    """A fresh system of the runner's class and configuration."""
    args = (slam.cfg, slam.imu_cfg) if hasattr(slam, "imu_cfg") else (
        slam.cfg,)
    twin = type(slam)(*args, device="cpu")
    if slam.timers is not None:
        twin.enable_stage_timers()
    return twin


def assert_direct_drive_equal(run: Run):
    """The runner's poses equal the same system driven directly with the
    frames its loop handed over (stamps and IMU from the JAX loader's
    reading, which :func:`assert_calls_equal` holds equal)."""
    twin = twin_of(run.result.slam)
    for call in run.calls:
        twin.track(*call)
    a, b = run.result.slam.trajectory, twin.trajectory
    assert len(a) == len(b)
    for (s1, R1, t1), (s2, R2, t2) in zip(a, b):
        assert s1 == s2
        np.testing.assert_array_equal(np.asarray(R1), np.asarray(R2))
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    return twin


def assert_outputs(run: Run):
    """The runner's files exist; its ``f_`` file holds its trajectory, in
    the dataset's stamps (ns for the EuRoC layout), read by the JAX
    package's ``load_tum``."""
    for path in run.result.outputs:
        assert os.path.exists(path), path
    assert [os.path.basename(p) for p in run.result.outputs] == list(
        run.d.outputs)
    slam = run.result.slam
    f_ = [p for p in run.result.outputs
          if os.path.basename(p).startswith("f_")][0]
    traj = slam.trajectory
    if not traj:
        with open(f_) as f:
            assert not f.read().strip()
        return
    stamps, centres, _ = jtrajectory.load_tum(f_)
    scale = 1.0 if run.d.kind in ("kitti", "tum_rgbd") else 1e-9
    want = np.array([s + slam.t0 for s, _, _ in traj])
    np.testing.assert_allclose(stamps * scale, want, rtol=0, atol=2e-6)
    # Every stamp is one of the dataset's frames.
    assert np.abs(want[:, None] - run.d.stamps[None]).min(1).max() < 1e-6
    est = -np.einsum("nji,nj->ni", np.stack([np.asarray(R)
                                             for _, R, _ in traj]),
                     np.stack([np.asarray(t) for _, _, t in traj]))
    np.testing.assert_allclose(centres, est, atol=1e-5)
