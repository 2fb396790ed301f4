"""The port's contracts: it never imports JAX, CPU tensors never reach a
kernel, and a CUDA kernel that cannot run raises. (Kernel-vs-plain tests on
a card are in test_torch_kernels_cuda.py.)"""

import ast
import pathlib

import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch import device as device_mod
from orbslam3_byzyh_tpu_torch.kernels import _build
from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match, fast_orb
from orbslam3_byzyh_tpu_torch.pipeline import tracking
from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "orbslam3_byzyh_tpu_torch"
KERNELS = {"K1": cuda_brief.KERNEL, "K2": cuda_match.KERNEL,
           "K3": cuda_pose_opt.KERNEL}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


RUNNER_SCRIPTS = sorted((REPO / "scripts").glob("run_*_torch.py"))
PORT_SOURCES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
                + RUNNER_SCRIPTS)


def test_static_checks_cover_the_runners():
    """The six runner scripts and the dataset path's modules are among the
    checked sources."""
    names = {p.name for p in RUNNER_SCRIPTS}
    assert names == {f"run_{k}_torch.py" for k in (
        "euroc_mono", "euroc_mono_inertial", "euroc_stereo_inertial",
        "kitti", "tum_rgbd", "tumvi")}, names
    checked = {str(p.relative_to(PORT)) for p in PORT_SOURCES
               if p.is_relative_to(PORT)}
    for rel in ("runners.py", "io/png.py", "io/prefetch.py", "io/euroc.py",
                "io/kitti.py", "io/tum_rgbd.py", "io/rectify.py",
                "ops/cuda_png.py", "ops/clahe.py"):
        assert rel in checked, rel


def test_static_checks_cover_the_system():
    """The monocular system's modules are among the checked sources."""
    checked = {str(p.relative_to(PORT)) for p in PORT_SOURCES
               if p.is_relative_to(PORT)}
    for rel in ("pipeline/system.py", "pipeline/trajectory_log.py",
                "models/atlas.py", "io/trajectory.py", "io/checkpoint.py",
                "io/settings.py", "utils/evaluate.py", "utils/verbose.py",
                "utils/chessboard.py", "utils/timers.py"):
        assert rel in checked, rel


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    """Static check (the environment imports jax at start-up, so a
    subprocess cannot show it): no module of the port, nor the chip smoke
    script, imports jax or the JAX package."""
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "orbslam3_byzyh_tpu"), (path, mod)


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_host_library_imports(path):
    """The card's machine has no OpenCV, matplotlib, PyYAML or Pillow: no
    module of the port, nor the chip smoke script, nor a port runner script
    imports ``cv2``, ``matplotlib``, ``yaml`` or ``PIL`` (the port has its
    own chessboard detector, planar PnP, reader of OpenCV's YAML 1.0, PNG
    codec, rectification and CLAHE)."""
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("cv2", "matplotlib", "yaml",
                                         "PIL"), (path, mod)


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_reads_no_jax_package_file(path):
    """No module of the port builds a path into the JAX package's
    directory: the port keeps its own copies of such files."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value.strip("/") != "orbslam3_byzyh_tpu", path


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_raises_name_no_waiting_merge(path):
    """The atlas merge and the checkpoints are ported: no module raises an
    error naming ROADMAP item 12c."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Raise):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                                str):
                    assert "12c" not in sub.value, (path, sub.value)


def test_brief_pattern_is_the_ports_own_copy():
    pattern = pathlib.Path(fast_orb._PATTERN_PATH).resolve()
    assert pattern.is_relative_to(PORT)
    jax_copy = REPO / "orbslam3_byzyh_tpu" / "ops" / "orb_pattern.npy"
    assert pattern.read_bytes() == jax_copy.read_bytes()


def test_default_device_is_the_card(monkeypatch):
    """Without a device the entry points select CUDA, and raise when there
    is no card; the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.to_torch(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tree_to_torch((x, x))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.example_tracking_args(48, 64, 32)
    assert device_mod.resolve("cpu") == torch.device("cpu")
    assert convert.to_torch(x, "cpu").device == torch.device("cpu")
    args = graft.example_tracking_args(48, 64, 32, device="cpu")
    assert all(a.device == torch.device("cpu") for a in args)
    # With a card present, None is the card (and TF32 goes off).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert device_mod.resolve() == torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32


def test_cpu_slice_launches_no_kernel():
    for k in KERNELS.values():
        k.launches = 0
    img = t(graft.example_arrays(96, 128, 64)[0])
    f = fast_orb.extract(img, n_features=64)
    scene = convert.tree_to_torch(graft.lifted_scene(
        n(f.xy), n(f.level), n(f.desc), n(f.valid), h=96, w=128, n_lm=64),
        "cpu")
    _, R0, t0, *lm, cam = scene
    bind = torch.full((64,), -1, dtype=torch.int32)
    res = tracking.track_local_map(R0, t0, bind, *lm, f.xy, f.level, f.desc,
                                   f.valid, cam, 128, 96)
    assert int(res.n_inliers) > 0
    assert {n_: k.launches for n_, k in KERNELS.items()} == \
        {"K1": 0, "K2": 0, "K3": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel entry points take CUDA tensors only: no silent CPU run."""
    z = torch.zeros
    with pytest.raises(ValueError):
        cuda_brief.brief_descriptors_kernel(
            [z(10, 10)], z(4, 2), z(4, dtype=torch.int32), z(4))
    with pytest.raises(ValueError):
        cuda_match.hamming_best2_kernel(
            z(4, 8, dtype=torch.int32), z(5, 8, dtype=torch.int32),
            z(4, dtype=torch.bool), z(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_pose_opt.pose_optimization_kernel(
            torch.eye(3), z(3), z(8, 3), z(8, 2), z(8),
            z(8, dtype=torch.bool), z(4))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    k = _build.Kernel("brief", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        k.build()
    assert k.launches == 0


def test_convert_round_trip(rng):
    desc = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    td = convert.to_torch(desc, "cpu")
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(convert.desc_to_uint32(td), desc)
    assert convert.to_torch(np.arange(3, dtype=np.int64), "cpu").dtype == torch.int32
    assert convert.to_torch(np.ones(3), "cpu").dtype == torch.float32
    assert convert.to_torch(np.ones(3, bool), "cpu").dtype == torch.bool


def test_static_checks_cover_the_stereo_slice():
    """The stereo slice's modules are among the checked sources."""
    checked = {str(p.relative_to(PORT)) for p in PORT_SOURCES
               if p.is_relative_to(PORT)}
    for rel in ("ops/stereo.py", "pipeline/stereo_system.py",
                "solver/cuda_pose_opt.py", "solver/ba.py"):
        assert rel in checked, rel


def test_k3s_wrapper_rejects_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError):
        cuda_pose_opt.pose_optimization_stereo_kernel(
            torch.eye(3), z(3), z(8, 3), z(8, 2), z(8), 40.0, z(8),
            z(8, dtype=torch.bool), z(4))
    assert set(cuda_pose_opt.KERNEL.fn_launches) >= {
        cuda_pose_opt.MONO_FN, cuda_pose_opt.STEREO_FN}


# The KITTI stereo rig cut for the CPU: a third of the image and focal
# length, 256 features, 64 keyframe / 2048 landmark slots, a 512-landmark
# window; the baseline is KITTI's (bf = 0.53716 x fx).
SMALL_RIG = graft.RigConfig(
    mono=graft.MonoConfig(width=416, height=128, fx=240.0, fy=240.0,
                          cx=208.0, cy=62.0, dist=None, n_features=256,
                          max_kf=64, max_lm=2048, n_local_lm=512),
    bf=0.53716 * 240.0)


def test_stereo_frame_step_on_the_cpu():
    """``graft.stereo_frame_step`` on the CPU on the shifted pair (a plane
    at bf / 32): the level-0 disparities within 0.5 px of 32, back to the
    identity with most features inliers, close points counted, and no
    kernel launched (the plain versions run)."""
    for k in KERNELS.values():
        k.launches = 0
        k.fn_launches = dict.fromkeys(k.fn_launches, 0)
    m = SMALL_RIG.mono
    left, right = (t(a) for a in graft.kitti_stereo_pair(SMALL_RIG))
    cam = t(np.array([m.fx, m.fy, m.cx, m.cy], np.float32))
    f, _, s = graft.stereo_extract(left, right, cam, None, SMALL_RIG)
    disp = n(f.xy[:, 0] - s.u_right)
    lvl0 = n(s.valid & (f.level == 0))
    assert lvl0.sum() > 20
    assert np.abs(disp[lvl0] - graft.KITTI_PAIR_SHIFT).max() <= 0.5
    feats = [n(a) for a in (f.xy, f.level, f.desc, f.angle, f.valid)]
    scene = graft.kitti_stereo_scene(*feats, n(s.depth), rig=SMALL_RIG)
    args = graft.StereoFrameArgs(*convert.tree_to_torch(scene, "cpu"))
    res, info, _, _, _ = graft.stereo_frame_step(*args, rig=SMALL_RIG)
    assert int(res.n_inliers) >= 0.8 * int(f.valid.sum())
    np.testing.assert_allclose(n(res.R), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(n(res.t), 0.0, atol=1e-3)
    assert n(info)[2] > 0                     # tracked close points
    assert all(k.launches == 0 for k in KERNELS.values())
