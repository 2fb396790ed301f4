"""The port's dataset loaders (``io/euroc.py``, ``io/kitti.py``,
``io/tum_rgbd.py``) against the JAX package's, and the port's prefetcher
(``io/prefetch.py``) against the JAX ``native`` prefetcher's contract
(``tests/test_native.py``) and ``cv2.imread``.

The loaders must give the same stamps, paths, IMU batches, association and
images; the EuRoC case of ``tests/test_io.py::TestEurocReader`` is replayed.
The datasets are the port's fabricated ones (``graft.write_*_dataset``).
"""

import os

import cv2
import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu.io import euroc as jeuroc
from orbslam3_byzyh_tpu.io import kitti as jkitti
from orbslam3_byzyh_tpu.io import tum_rgbd as jtum
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.io import euroc, kitti, png, tum_rgbd
from orbslam3_byzyh_tpu_torch.io.prefetch import ImagePrefetcher

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    """test_io.py's EuRoC case: 5 frames 50 ms apart at a real ns epoch,
    40 IMU rows 5 ms apart, cv2-written images."""
    root = tmp_path_factory.mktemp("euroc")
    d = root / "seq" / "mav0"
    (d / "cam0" / "data").mkdir(parents=True)
    (d / "imu0").mkdir(parents=True)
    stamps = [1403636579763555584 + i * 50000000 for i in range(5)]
    rows = ["#ts,filename"]
    for s in stamps:
        img = np.random.default_rng(s % 100).integers(
            0, 255, (48, 64), dtype=np.uint8)
        cv2.imwrite(str(d / "cam0" / "data" / f"{s}.png"), img)
        rows.append(f"{s},{s}.png")
    (d / "cam0" / "data.csv").write_text("\n".join(rows))
    imu_rows = ["#ts,wx,wy,wz,ax,ay,az"]
    for i in range(40):
        ts = stamps[0] + i * 5000000
        imu_rows.append(f"{ts},0.01,0.02,0.03,0.1,0.2,9.8")
    (d / "imu0" / "data.csv").write_text("\n".join(imu_rows))
    (root / "times.txt").write_text("\n".join(str(s) for s in stamps[1:4]))
    return str(root)


def test_euroc_reader_case(euroc_dir):
    """test_io.py::TestEurocReader::test_load, on the port's loader."""
    seq = euroc.load_euroc(os.path.join(euroc_dir, "seq"))
    assert len(seq) == 5
    img = seq.read_image(0)
    assert img.shape == (48, 64) and img.dtype == np.float32
    assert seq.imu_stamps is not None
    t, g, a = seq.imu_between(seq.stamps[0], seq.stamps[1])
    assert len(t) == 10
    assert g.shape == (10, 3)


@pytest.mark.parametrize("timestamps", [False, True])
def test_euroc_equals_jax_loader(euroc_dir, timestamps):
    seq_dir = os.path.join(euroc_dir, "seq")
    ts = os.path.join(euroc_dir, "times.txt") if timestamps else None
    p, j = euroc.load_euroc(seq_dir, ts), jeuroc.load_euroc(seq_dir, ts)
    np.testing.assert_array_equal(p.stamps, j.stamps)
    assert p.image_paths == j.image_paths
    for a in ("imu_stamps", "imu_gyro", "imu_acc"):
        np.testing.assert_array_equal(getattr(p, a), getattr(j, a))
        assert getattr(p, a).dtype == getattr(j, a).dtype
    for i in range(len(p)):
        np.testing.assert_array_equal(p.read_image(i), j.read_image(i))
    for t0, t1 in zip(p.stamps[:-1], p.stamps[1:]):
        for x, y in zip(p.imu_between(t0, t1), j.imu_between(t0, t1)):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def fabricated(tmp_path_factory):
    """The runners' small datasets of three layouts (4 frames each)."""
    root = tmp_path_factory.mktemp("fab")
    return {k: graft.write_runner_dataset(k, str(root / k), n_frames=4,
                                          small=True)
            for k in ("euroc_stereo_inertial", "kitti", "tum_rgbd")}


def test_fabricated_euroc_equals_jax_loader(fabricated):
    d = fabricated["euroc_stereo_inertial"]
    for cam in ("cam0", "cam1"):
        p = euroc.load_euroc(d.sequence, cam=cam)
        j = jeuroc.load_euroc(d.sequence, cam=cam)
        np.testing.assert_array_equal(p.stamps, j.stamps)
        np.testing.assert_array_equal(p.stamps, d.stamps)
        assert p.image_paths == j.image_paths
        np.testing.assert_array_equal(p.imu_acc, j.imu_acc)
        for i in range(len(p)):
            np.testing.assert_array_equal(p.read_image(i), j.read_image(i))
        # The first frame's batch is empty by construction; the rest hold
        # the 200 Hz samples of each 0.1 s gap.
        t, _, _ = p.imu_between(p.stamps[0], p.stamps[1])
        assert len(t) == 20


def test_kitti_equals_jax_loader(fabricated):
    d = fabricated["kitti"]
    p, j = kitti.load_kitti(d.sequence), jkitti.load_kitti(d.sequence)
    np.testing.assert_array_equal(p.stamps, j.stamps)
    assert p.left_paths == j.left_paths and p.right_paths == j.right_paths
    for i in range(len(p)):
        for right in (False, True):
            np.testing.assert_array_equal(p.read_image(i, right),
                                          j.read_image(i, right))


@pytest.mark.parametrize("max_dt", [0.02, 0.004])
def test_tum_association_equals_jax(fabricated, max_dt):
    d = fabricated["tum_rgbd"]
    p = tum_rgbd.load_tum_rgbd(d.sequence, max_dt=max_dt)
    j = jtum.load_tum_rgbd(d.sequence, max_dt=max_dt)
    np.testing.assert_array_equal(p.stamps, j.stamps)
    assert p.rgb_paths == j.rgb_paths and p.depth_paths == j.depth_paths
    # The depth images lag 5 ms: within 0.02 s all pair, within 4 ms none.
    assert len(p) == (4 if max_dt == 0.02 else 0)
    for i in range(len(p)):
        for x, y in zip(p.read_pair(i), j.read_pair(i)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype == np.float32


def test_tum_association_file_equals_jax(fabricated, tmp_path):
    d = fabricated["tum_rgbd"]
    j = jtum.load_tum_rgbd(d.sequence)
    lines = [f"{t:.6f} {os.path.relpath(r, d.sequence)} {t:.6f} "
             f"{os.path.relpath(dp, d.sequence)}"
             for t, r, dp in zip(j.stamps, j.rgb_paths, j.depth_paths)]
    assoc = tmp_path / "assoc.txt"
    assoc.write_text("# rgb depth\n" + "\n".join(lines) + "\n")
    p = tum_rgbd.load_tum_rgbd(d.sequence, association_file=str(assoc))
    q = jtum.load_tum_rgbd(d.sequence, association_file=str(assoc))
    np.testing.assert_array_equal(p.stamps, q.stamps)
    assert p.rgb_paths == q.rgb_paths and p.depth_paths == q.depth_paths


# -- the prefetcher -------------------------------------------------------------

@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """test_native.py's 12 images, and 3 more with every filter (cv2 at
    compression 9 writes Paeth rows; the port's writer the rest)."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        p = str(d / f"{i:03d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    ramp = (np.add.outer(np.arange(48), np.arange(64)) * 3 % 256).astype(
        np.uint8)
    cv2.imwrite(str(d / "012.png"), ramp, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    png.write_png(str(d / "013.png"), ramp, filters=(0, 1, 2, 3, 4))
    png.write_png(str(d / "014.png"), (ramp.astype(np.uint16) * 257),
                  filters=(4, 3))
    return paths + [str(d / f"{i:03d}.png") for i in (12, 13, 14)]


@pytest.mark.parametrize("n_threads,capacity", [(1, 2), (3, 4), (4, 8)])
def test_prefetcher_ordered_and_matches_cv2(png_dir, n_threads, capacity):
    pf = ImagePrefetcher(png_dir, n_threads=n_threads, capacity=capacity,
                         device="cpu")
    seen = []
    for idx, img in pf:
        ref = cv2.imread(png_dir[idx], cv2.IMREAD_GRAYSCALE).astype(
            np.float32)
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, ref)
        seen.append(idx)
    pf.close()
    assert seen == list(range(len(png_dir)))


def test_prefetcher_single_thread(png_dir):
    pf = ImagePrefetcher(png_dir[:5], n_threads=1, capacity=2, device="cpu")
    assert [i for i, _ in pf] == list(range(5))
    pf.close()


def test_prefetcher_unchanged_mode(png_dir):
    pf = ImagePrefetcher(png_dir[-1:], device="cpu", modes="unchanged")
    (_, img), = list(pf)
    np.testing.assert_array_equal(
        img, cv2.imread(png_dir[-1], cv2.IMREAD_UNCHANGED).astype(np.float32))
    pf.close()


def test_prefetcher_raises_ioerror_in_order(png_dir, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    paths = png_dir[:3] + [str(bad), str(tmp_path / "missing.png")]
    pf = ImagePrefetcher(paths, n_threads=2, capacity=2, device="cpu")
    assert [next(pf)[0] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(IOError, match="bad.png"):
        next(pf)
    with pytest.raises(IOError, match="missing.png"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetcher_bounded_and_closes(png_dir):
    """At most ``capacity`` images are decoded ahead of the consumer, and
    ``close`` stops the workers with images still queued."""
    pf = ImagePrefetcher(png_dir, n_threads=4, capacity=3, device="cpu")
    next(pf)
    import time
    time.sleep(0.2)
    with pf._cv:
        assert pf._next_take <= 1 + 3
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_default_device_is_the_card(monkeypatch, png_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImagePrefetcher(png_dir[:1])
