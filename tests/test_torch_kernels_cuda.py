"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Marked ``cuda`` and skipped without a CUDA device: the kernels have no CPU
mode. The file imports neither JAX nor the conftest's fixtures, so on a
machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match, fast_orb, lie
from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(11)


def _t(x, dev):
    return convert.to_torch(x, dev)


def _k1_case(dev, gen, h, w, k):
    """The blurred levels of the example frame at h x w and k keypoints on
    random levels, some at the image edge."""
    img = _t(graft.example_arrays(h, w, 16)[0], dev)
    blurred = [fast_orb.gaussian_blur(p)
               for p in fast_orb.build_pyramid(img, 8, 1.2)]
    lvl = gen.integers(0, 8, k).astype(np.int32)
    xy = np.stack([gen.integers(0, w, k), gen.integers(0, h, k)], -1)
    xy = np.floor(xy / 1.2 ** lvl[:, None]).astype(np.float32)
    ang = gen.uniform(-np.pi, np.pi, k).astype(np.float32)
    return blurred, _t(xy, dev), _t(lvl, dev), _t(ang, dev)


def test_k1_kernel_matches_plain(dev, gen):
    img = _t(graft.example_arrays(240, 320, 16)[0], dev)
    pyr = fast_orb.build_pyramid(img, 4, 1.2)
    blurred = [fast_orb.gaussian_blur(p) for p in pyr]
    k = 200
    lvl = gen.integers(0, 4, k).astype(np.int32)
    xy = np.stack([gen.integers(0, 320, k), gen.integers(0, 240, k)], -1)
    xy = np.floor(xy / 1.2 ** lvl[:, None]).astype(np.float32)
    ang = _t(gen.uniform(-np.pi, np.pi, k).astype(np.float32), dev)
    args = (blurred, _t(xy, dev), _t(lvl, dev), ang)
    out = cuda_brief.brief_descriptors_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_brief.brief_descriptors_plain(*args))


@pytest.mark.parametrize("h,w", [(480, 640), (480, 752)])
@pytest.mark.parametrize("k", [1, 31, 1201])
def test_k1_kernel_sizes_match_plain(dev, gen, h, w, k):
    """Both frame sizes of the port's entry points, ragged keypoint
    counts: bit-identical words."""
    args = _k1_case(dev, gen, h, w, k)
    out = cuda_brief.brief_descriptors_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_brief.brief_descriptors_plain(*args))


def test_k1_sincos_equals_torch(dev):
    """K1 takes the angle and computes its cosine and sine with sincosf:
    bit-equal to torch.cos / torch.sin on the card over 2^20 angles in
    [-pi, pi], the range of atan2."""
    ang = torch.linspace(-np.pi, np.pi, 1 << 20, device=dev)
    s, c = cuda_brief.sincos_on_card(ang)
    torch.cuda.synchronize()
    assert torch.equal(s, torch.sin(ang)) and torch.equal(c, torch.cos(ang))


def _k2_case(gen, dev, mode, na, nb):
    """Descriptors with duplicate columns (ties), validity and the mode's
    gate data, as the kernel takes them."""
    db = gen.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
    db[1::2] = db[0:nb - nb % 2:2]            # duplicate columns: ties
    da = db[gen.integers(0, nb, na)].copy()
    da[::3] ^= np.uint32(5)
    va, vb = gen.random(na) > 0.1, gen.random(nb) > 0.1
    gates = {}
    if mode == "window":
        gates = dict(xy_a=gen.uniform(0, 640, (na, 2)),
                     xy_b=gen.uniform(0, 640, (nb, 2)),
                     radius=gen.uniform(20, 200, na),
                     level_a=gen.integers(0, 8, na),
                     level_b=gen.integers(0, 8, nb))
    elif mode == "epipolar":
        gates = dict(xy_b=gen.uniform(0, 640, (nb, 2)),
                     lines=gen.normal(0, 100, (na, 3)),
                     line_th=gen.uniform(1e3, 1e5, nb))
    gates = {k: _t(v, dev) for k, v in gates.items()}
    if mode == "window":
        gates["level_window"] = (-1, 1)
    return tuple(_t(a, dev) for a in (da, db, va, vb)), gates


def _k2_check(args, gates):
    out = cuda_match.hamming_best2_kernel(*args, **gates)
    ref = cuda_match.hamming_best2_plain(*args, **gates)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    return out


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_k2_kernel_matches_plain(dev, gen, mode):
    out = _k2_check(*_k2_case(gen, dev, mode, 700, 300))
    assert bool((out[0] == out[1]).any())


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
@pytest.mark.parametrize("na,nb", [(4095, 1023), (4095, 7)])
def test_k2_kernel_ragged_matches_plain(dev, gen, mode, na, nb):
    """Rows and columns that fill no whole 16-row block or 8-column tile."""
    _k2_check(*_k2_case(gen, dev, mode, na, nb))


def test_k2_kernel_main_path_shape(dev, gen):
    """Window mode at the tracking step's 4096 landmarks x 1024 keypoints,
    with one radius for all rows as a 0-d tensor."""
    args, gates = _k2_case(gen, dev, "window", 4096, 1024)
    out = _k2_check(args, gates)
    assert int((out[0] < 1024).sum()) > 1000
    gates["radius"] = torch.tensor(60.0, device=dev)
    _k2_check(args, gates)


def test_k2_sass_has_integer_tensor_instructions(dev):
    """The distances run on the tensor cores: the 1-bit AND-popc products
    are BMMA instructions in the kernel's SASS."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    cuda_match.KERNEL.build()
    sass = subprocess.run([tool, "-sass", str(cuda_match.KERNEL.library_path())],
                          capture_output=True, text=True, check=True).stdout
    assert "BMMA" in sass


def test_k2_frame_step_shapes(dev, gen):
    """The frame step's K2 calls at EuRoC-mono widths: the motion model's
    two tries stacked as 2400 rows x 1200 keypoints (radius 15 for the
    first half, 30 for the second, level window +-8), each half equal to
    its own launch; the reference-keyframe match, 1200 x 1200 without a
    gate, with duplicate descriptors."""
    args, gates = _k2_case(gen, dev, "window", 1200, 1200)
    xy_a = torch.cat([gates["xy_a"], gates["xy_a"] + 9.0])
    radius = torch.cat([torch.full((1200,), 15.0, device=dev),
                        torch.full((1200,), 30.0, device=dev)])
    lvl = torch.zeros(2400, dtype=torch.int32, device=dev)
    stacked = dict(xy_a=xy_a, xy_b=gates["xy_b"], radius=radius,
                   level_a=lvl, level_b=gates["level_b"],
                   level_window=(-8, 8))
    da = args[0].repeat(2, 1)
    va = args[2].repeat(2)
    out = _k2_check((da, args[1], va, args[3]), stacked)
    for half in range(2):
        rows = slice(1200 * half, 1200 * (half + 1))
        one = dict(stacked, xy_a=xy_a[rows].contiguous(),
                   radius=radius[rows].contiguous(), level_a=lvl[rows])
        alone = cuda_match.hamming_best2_kernel(
            da[rows].contiguous(), args[1], va[rows].contiguous(), args[3],
            **one)
        for a, b in zip(out, alone):
            assert torch.equal(a[rows], b)
    out = _k2_check(*_k2_case(gen, dev, "none", 1200, 1200))
    assert bool((out[0] == out[1]).any())


def test_k3_kernel_matches_plain(dev, gen):
    """The pose-opt test problem: noisy projections with outliers."""
    n = 700
    pts = np.stack([gen.uniform(-4, 4, n), gen.uniform(-3, 3, n),
                    gen.uniform(4, 12, n)], -1).astype(np.float32)
    R_gt = lie.so3_exp(torch.tensor(gen.normal(0, 0.05, 3))).float()
    t_gt = torch.tensor([0.3, -0.1, 0.2])
    cam = np.array([420.0, 420.0, 320.0, 240.0], np.float32)
    pc = pts @ R_gt.numpy().T + t_gt.numpy()
    uv = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                   cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], -1)
    uv += gen.normal(0, 0.5, uv.shape)
    uv[gen.choice(n, 60, replace=False)] += gen.uniform(20, 80, (60, 2))
    inv_s2 = 1.0 / 1.2 ** (2.0 * gen.integers(0, 4, n))
    valid = np.ones(n, bool)
    valid[gen.choice(n, 30, replace=False)] = False
    R0 = lie.so3_exp(torch.tensor([0.01, -0.02, 0.015])) @ R_gt
    t0 = t_gt + torch.tensor([0.05, -0.03, 0.08])
    args = (R0.to(dev), t0.to(dev)) + tuple(
        _t(a, dev) for a in (pts, uv, inv_s2, valid, cam))
    Rk, tk, ck = cuda_pose_opt.pose_optimization_kernel(*args)
    Rp, tp, cp = cuda_pose_opt.pose_optimization_plain(*args)
    torch.cuda.synchronize()
    # Gram-Schmidt + LDL^T against SVD + linalg.solve, float32.
    assert float((Rk - Rp).abs().max()) <= 1e-4
    assert float((tk - tp).abs().max()) <= 1e-4
    nk = int(((ck <= cuda_pose_opt.CHI2_MONO) & args[5]).sum())
    npl = int(((cp <= cuda_pose_opt.CHI2_MONO) & args[5]).sum())
    assert abs(nk - npl) <= 2
    # A batch of two problems is one launch, each block its own problem.
    Rb, tb, cb = cuda_pose_opt.pose_optimization_kernel(
        torch.stack([args[0], args[0]]), torch.stack([args[1], args[1]]),
        *(torch.stack([a, a]) for a in args[2:6]), args[6])
    assert torch.equal(Rb[0], Rk) and torch.equal(Rb[1], Rk)
    assert torch.equal(cb[1], ck)


def test_k3_batch_rows_equal_single_runs(dev, gen):
    """N = 1500 points, a batch of 3 different problems in one launch: each
    row is bit-equal to its problem run alone, and within 1e-4 of plain."""
    n, b = 1500, 3
    cam = _t(np.array([420.0, 420.0, 320.0, 240.0], np.float32), dev)
    probs = []
    for _ in range(b):
        pts = np.stack([gen.uniform(-4, 4, n), gen.uniform(-3, 3, n),
                        gen.uniform(4, 12, n)], -1).astype(np.float32)
        R_gt = lie.so3_exp(torch.tensor(gen.normal(0, 0.05, 3))).float()
        t_gt = torch.tensor(gen.normal(0, 0.2, 3)).float()
        pc = pts @ R_gt.numpy().T + t_gt.numpy()
        uv = np.stack([420.0 * pc[:, 0] / pc[:, 2] + 320.0,
                       420.0 * pc[:, 1] / pc[:, 2] + 240.0], -1)
        uv += gen.normal(0, 0.5, uv.shape)
        uv[gen.choice(n, 100, replace=False)] += gen.uniform(20, 80, (100, 2))
        R0 = lie.so3_exp(torch.tensor(gen.normal(0, 0.01, 3)).float()) @ R_gt
        t0 = t_gt + torch.tensor(gen.normal(0, 0.05, 3)).float()
        probs.append((R0.to(dev), t0.to(dev)) + tuple(_t(a, dev) for a in (
            pts, uv, 1.0 / 1.2 ** (2.0 * gen.integers(0, 8, n)),
            gen.random(n) > 0.03)))
    batch = [torch.stack(a) for a in zip(*probs)]
    Rb, tb, cb = cuda_pose_opt.pose_optimization_kernel(*batch, cam)
    for i, p in enumerate(probs):
        Rs, ts, cs = cuda_pose_opt.pose_optimization_kernel(*p, cam)
        assert torch.equal(Rb[i], Rs) and torch.equal(tb[i], ts)
        assert torch.equal(cb[i], cs)
        Rp, tp, _ = cuda_pose_opt.pose_optimization_plain(*p, cam)
        assert float((Rs - Rp).abs().max()) <= 1e-4
        assert float((ts - tp).abs().max()) <= 1e-4


def test_k3_two_tries_of_the_motion_model(dev, gen):
    """B = 2 at N = 1200, as frame_step runs the motion model and its
    retry: each row bit-equal to its single run."""
    n = 1200
    cam = _t(np.array([458.654, 457.296, 367.215, 248.375], np.float32), dev)
    pts = np.stack([gen.uniform(-4, 4, n), gen.uniform(-3, 3, n),
                    gen.uniform(3, 12, n)], -1).astype(np.float32)
    pc = pts
    uv = np.stack([458.654 * pc[:, 0] / pc[:, 2] + 367.215,
                   457.296 * pc[:, 1] / pc[:, 2] + 248.375], -1)
    probs = []
    for k in range(2):
        R0 = lie.so3_exp(torch.tensor(gen.normal(0, 0.01 * (k + 1), 3))
                         ).float()
        t0 = torch.tensor(gen.normal(0, 0.03, 3)).float()
        obs = uv + gen.normal(0, 0.5, uv.shape)
        valid = gen.random(n) > 0.05 * (k + 1)
        probs.append((R0.to(dev), t0.to(dev)) + tuple(_t(a, dev) for a in (
            pts, obs, 1.0 / 1.2 ** (2.0 * gen.integers(0, 8, n)), valid)))
    batch = [torch.stack(a) for a in zip(*probs)]
    Rb, tb, cb = cuda_pose_opt.pose_optimization_kernel(*batch, cam)
    for i, p in enumerate(probs):
        Rs, ts, cs = cuda_pose_opt.pose_optimization_kernel(*p, cam)
        assert torch.equal(Rb[i], Rs) and torch.equal(tb[i], ts)
        assert torch.equal(cb[i], cs)


def test_frame_step_makes_no_host_read(dev):
    """The EuRoC-mono frame step on the card under
    torch.cuda.set_sync_debug_mode("error"): no operation of frame_step
    synchronises with the host (the retry is chosen on the device)."""
    from orbslam3_byzyh_tpu_torch.pipeline import tracking
    cfg = graft.EUROC_MONO
    img = _t(graft.example_image(cfg.height, cfg.width), dev)
    cam = _t(np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], np.float32), dev)
    dist = _t(np.array(cfg.dist, np.float32), dev)
    f = graft.mono_extract(img, cam, dist)
    sc = graft.euroc_mono_scene(*(convert.to_numpy(a) for a in (
        f.xy, f.level, f.desc, f.angle, f.valid)), case="retry")
    a = graft.MonoFrameArgs(*convert.tree_to_torch(sc, dev))

    def step():
        return tracking.frame_step(
            a.R_pred, a.t_pred, a.R_last, a.t_last, a.lm_pos, a.lm_desc,
            a.lm_normal, a.lm_min_d, a.lm_max_d, a.lm_valid, a.last_bind,
            a.last_desc, a.last_angle, f.xy, f.level, f.desc, f.valid,
            f.angle, torch.full((cfg.n_features,), -1.0, device=dev),
            torch.zeros((), device=dev), torch.zeros((), device=dev),
            a.obs_kf, a.obs_valid, a.ref_kf, cfg.kf_ref_min_obs, a.n_kf,
            a.n_found, a.n_visible, a.cam_params, cfg.width, cfg.height,
            max_kf=cfg.max_kf)

    step()                    # first call: builds and one-time constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, info, _, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(info[0]) >= 0.9 * int(f.valid.sum())


def test_k2_keyframe_step_shapes(dev, gen):
    """The keyframe step's K2 calls at EuRoC-mono widths: the epipolar
    search of the new keyframe's 1200 keypoints against a neighbour's 1200
    (``graft.euroc_mono_map``'s views, lines from the poses), and the
    fusion search's window mode over all 65536 landmark slots with sparse
    candidate rows (the first launch above 4096 rows)."""
    from orbslam3_byzyh_tpu_torch.pipeline import mapping, tracking

    m = graft.euroc_mono_map(seed=3)
    nb = m.kf_id - 2
    k = m.state.kfs
    cam = _t(m.cam_params, dev)
    F = mapping.fundamental_from_poses(_t(m.R, dev), _t(m.t, dev),
                                       _t(k.R[nb], dev), _t(k.t[nb], dev), cam)
    xy_a = _t(m.feats.xy, dev)
    lines = (torch.cat([xy_a, torch.ones_like(xy_a[:, :1])], -1)
             @ F.T).contiguous()
    th = 3.84 * tracking.SIGMA2.to(dev)[_t(k.kp_level[nb], dev).long()]
    args = (_t(m.feats.desc, dev), _t(k.kp_desc[nb], dev),
            _t(m.feats.valid & (m.bindings < 0), dev), _t(k.kp_valid[nb], dev))
    out = _k2_check(args, dict(xy_b=_t(k.kp_xy[nb], dev), lines=lines,
                               line_th=th))
    assert int((out[0] <= 50).sum()) >= 100

    args, gates = _k2_case(gen, dev, "window", 65536, 1200)
    va = torch.from_numpy(gen.random(65536) < 0.05).to(dev)
    gates["radius"] = _t(gen.uniform(3, 12, 65536), dev)
    gates["xy_a"] = gates["xy_b"][_t(gen.integers(0, 1200, 65536), dev).long()] \
        + _t(gen.normal(0, 2, (65536, 2)), dev)
    out = _k2_check((args[0], args[1], va, args[3]), gates)
    hits = out[0] < 1024
    assert int(hits.sum()) > 1000 and not bool(hits[~va].any())


def test_keyframe_step_on_the_card_matches_cpu(dev):
    """The small map's keyframe step on the card against the plain versions
    on the CPU: the same culled keyframe and new-landmark count (within
    1 %, or one row), bindings within 1 %, the pose within 1e-3."""
    from torch_port_util import small_map, small_map_config

    cfg = small_map_config()
    m = small_map("full")
    out_c = graft.mono_keyframe_step(*graft.mono_map_args(m, "cpu"), cfg=cfg)
    out_g = graft.mono_keyframe_step(*graft.mono_map_args(m, dev), cfg=cfg)
    st_c, b_c, info_c, cul_c = out_c
    st_g, b_g, info_g, cul_g = out_g
    assert torch.equal(cul_g.cpu(), cul_c) and bool(cul_c[m.cull_kf])
    new_c = int(((st_c.lms.first_kf == m.kf_id) & st_c.lms.valid).sum())
    new_g = int(((st_g.lms.first_kf == m.kf_id) & st_g.lms.valid).sum())
    assert abs(new_g - new_c) <= max(1, 0.01 * new_c)
    nb_c, nb_g = int((b_c >= 0).sum()), int((b_g >= 0).sum())
    assert abs(nb_g - nb_c) <= max(1, 0.01 * nb_c)
    assert float((info_g.cpu()[3:] - info_c[3:]).abs().max()) <= 1e-3


def test_mono_initialize_on_the_card_matches_cpu(dev):
    """The two-view init (K2's window mode, the RANSAC, the full-map BA with
    the scatter assembly) on the card against the plain versions on the CPU
    with the indices the card drew, at EuRoC-mono's camera with 640
    features and 16 keyframe / 1024 landmark slots: the same success and
    model, the same landmarks (within 1 %) and bindings, R within 1e-3."""
    from orbslam3_byzyh_tpu_torch.models import map_state

    cfg = graft.EUROC_MONO._replace(n_features=640, max_kf=16, max_lm=1024,
                                    max_obs=8, min_init_matches=60)
    cam = np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy], np.float32)
    img = _t(graft.example_image(cfg.height, cfg.width), dev)
    f = graft.mono_extract(img, _t(cam, dev),
                           _t(np.array(cfg.dist, np.float32), dev), cfg)
    scene = graft.euroc_mono_two_view(f, cfg, "general")

    def run(d, **kw):
        return graft.mono_initialize(
            map_state.empty_map(cfg.max_kf, cfg.max_lm, cfg.max_obs,
                                cfg.n_features, device=d),
            fast_orb.FrameFeatures(*convert.tree_to_torch(scene.ref, d)),
            fast_orb.FrameFeatures(*convert.tree_to_torch(scene.cur, d)),
            0.0, 0.05, _t(cam, d), cfg=cfg, **kw)

    g = run(dev, generator=torch.Generator(dev).manual_seed(0))
    c = run("cpu", idx=g.info["idx"].cpu())
    assert g.success and c.success and not g.info["used_h"]
    assert c.info["used_h"] == g.info["used_h"]
    n_g = int(g.state.lms.valid.sum())
    n_c = int(c.state.lms.valid.sum())
    assert abs(n_g - n_c) <= 0.01 * n_c and n_c >= 50
    if n_g == n_c:
        assert torch.equal(g.bindings.cpu(), c.bindings)
    assert float((g.R.cpu() - c.R).abs().max()) <= 1e-3
    assert map_state.check_invariants(g.state, 2, cfg.max_lm) == []


def _stereo_problem(gen, dev, n, bf, stereo_share=0.6, outliers=80):
    """A mixed mono / stereo pose problem: noisy projections and right-image
    u (u - bf / z) on a share of the rows, outliers in both."""
    pts = np.stack([gen.uniform(-6, 6, n), gen.uniform(-2, 2, n),
                    gen.uniform(4, 30, n)], -1).astype(np.float32)
    R_gt = lie.so3_exp(torch.tensor(gen.normal(0, 0.05, 3))).float()
    t_gt = torch.tensor(gen.normal(0, 0.3, 3)).float()
    cam = np.array([718.856, 718.856, 607.1928, 185.2157], np.float32)
    pc = pts @ R_gt.numpy().T + t_gt.numpy()
    uv = np.stack([cam[0] * pc[:, 0] / pc[:, 2] + cam[2],
                   cam[1] * pc[:, 1] / pc[:, 2] + cam[3]], -1)
    uv += gen.normal(0, 0.5, uv.shape)
    ur = uv[:, 0] - bf / pc[:, 2] + gen.normal(0, 0.5, n)
    bad = gen.choice(n, outliers, replace=False)
    uv[bad[:outliers // 2]] += gen.uniform(20, 80, (outliers // 2, 2))
    ur[bad[outliers // 2:]] += gen.uniform(10, 40, outliers - outliers // 2)
    ur = np.where(gen.random(n) < stereo_share, ur, -1.0).astype(np.float32)
    R0 = lie.so3_exp(torch.tensor(gen.normal(0, 0.01, 3)).float()) @ R_gt
    t0 = t_gt + torch.tensor(gen.normal(0, 0.05, 3)).float()
    pts, uv, ur, inv_s2, valid, cam = (_t(a, dev) for a in (
        pts, uv.astype(np.float32), ur,
        1.0 / 1.2 ** (2.0 * gen.integers(0, 8, n)), gen.random(n) > 0.03,
        cam))
    return R0.to(dev), t0.to(dev), pts, uv, ur, bf, inv_s2, valid, cam


def test_k3s_kernel_matches_plain(dev, gen):
    """K3s at KITTI's 2000 points (about 60 % stereo rows, outliers in both
    coordinates) within 1e-4 of its plain version, inliers within 2; a batch
    of three problems is one launch, each row bit-equal to its single run."""
    n, bf = 2000, 386.1448
    probs = [_stereo_problem(gen, dev, n, bf) for _ in range(3)]
    for p in probs:
        before = cuda_pose_opt.KERNEL.fn_launches[cuda_pose_opt.STEREO_FN]
        Rk, tk, ck = cuda_pose_opt.pose_optimization_stereo_kernel(*p)
        assert (cuda_pose_opt.KERNEL.fn_launches[cuda_pose_opt.STEREO_FN]
                == before + 1)
        R0, t0, pts, uv, ur, bf_, inv_s2, valid, cam = p
        Rp, tp, cp = cuda_pose_opt.pose_optimization_plain(
            R0, t0, pts, uv, inv_s2, valid, cam, obs_ur=ur, bf=bf_)
        torch.cuda.synchronize()
        assert float((Rk - Rp).abs().max()) <= 1e-4
        assert float((tk - tp).abs().max()) <= 1e-4
        gate = torch.where(ur >= 0, cuda_pose_opt.CHI2_STEREO,
                           cuda_pose_opt.CHI2_MONO)
        nk = int(((ck <= gate) & valid).sum())
        npl = int(((cp <= gate) & valid).sum())
        assert abs(nk - npl) <= 2
    stacked = [torch.stack(a) for a in zip(*(
        p[:5] + p[6:8] for p in probs))]
    Rb, tb, cb = cuda_pose_opt.pose_optimization_stereo_kernel(
        *stacked[:5], bf, *stacked[5:], probs[0][8])
    for i, p in enumerate(probs):
        Rs, ts, cs = cuda_pose_opt.pose_optimization_stereo_kernel(*p)
        assert torch.equal(Rb[i], Rs) and torch.equal(tb[i], ts)
        assert torch.equal(cb[i], cs)


def test_k3s_all_mono_rows_match_k3(dev, gen):
    """With no stereo row K3s computes K3's schedule: within 1e-5 (the
    third row's zero terms change only the compiler's fused multiply-adds)."""
    p = _stereo_problem(gen, dev, 1500, 386.1448, stereo_share=0.0)
    R0, t0, pts, uv, ur, bf, inv_s2, valid, cam = p
    Rs, ts, cs = cuda_pose_opt.pose_optimization_stereo_kernel(*p)
    Rm, tm, cm = cuda_pose_opt.pose_optimization_kernel(
        R0, t0, pts, uv, inv_s2, valid, cam)
    torch.cuda.synchronize()
    assert float((Rs - Rm).abs().max()) <= 1e-5
    assert float((ts - tm).abs().max()) <= 1e-5
    assert cuda_pose_opt.pose_max_points_stereo() < \
        cuda_pose_opt.pose_max_points()


def test_stereo_frame_step_on_the_card(dev):
    """graft.stereo_frame_step at KITTI size on the shifted pair: one K3
    and one K3s launch, back to the identity, no synchronisation inside
    frame_step, the same inliers as the CPU plain path within 1 %."""
    rig = graft.KITTI_STEREO
    left, right = graft.kitti_stereo_pair()
    cam = torch.tensor([rig.mono.fx, rig.mono.fy, rig.mono.cx, rig.mono.cy],
                       device=dev)
    f, _, m = graft.stereo_extract(_t(left, dev), _t(right, dev), cam, None)
    feats = [convert.to_numpy(a) for a in (f.xy, f.level, f.desc, f.angle,
                                           f.valid)]
    scene = graft.kitti_stereo_scene(*feats, convert.to_numpy(m.depth))
    args = graft.StereoFrameArgs(*convert.tree_to_torch(scene, dev))
    graft.stereo_frame_step(*args)   # first call: caches its constants
    k = cuda_pose_opt.KERNEL.fn_launches
    before = dict(k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, info, _, _, _ = graft.stereo_frame_step(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert k[cuda_pose_opt.MONO_FN] == before[cuda_pose_opt.MONO_FN] + 1
    assert k[cuda_pose_opt.STEREO_FN] == before[cuda_pose_opt.STEREO_FN] + 1
    n_gpu = int(info[0])
    assert n_gpu >= 0.9 * int(f.valid.sum())
    assert float((res.R - torch.eye(3, device=dev)).abs().max()) <= 1e-3
    assert float(res.t.abs().max()) <= 1e-3
    _, info_cpu, _, _, _ = graft.stereo_frame_step(*(
        None if a is None else a.cpu() for a in args))
    assert abs(int(info_cpu[0]) - n_gpu) <= 0.01 * n_gpu


def _vi_frame(dev, case):
    """graft.vi_frame_step's arguments at the EuRoC stereo-inertial size, on
    the card and on the CPU."""
    cfg = graft.EUROC_STEREO_INERTIAL
    ctx = graft.vi_context(cfg, dev)
    left, right = graft.euroc_vi_pair(cfg)
    f, _, m = graft.stereo_extract(_t(left, dev), _t(right, dev),
                                   ctx.cam_params, None, cfg.rig)
    feats = [convert.to_numpy(a) for a in (f.xy, f.level, f.desc, f.angle,
                                           f.valid)]
    scene = graft.euroc_vi_scene(*feats, convert.to_numpy(m.depth),
                                 case=case, cfg=cfg)
    return cfg, ctx, scene, int(f.valid.sum())


@pytest.mark.parametrize("case", ["keyframe", "prior", "fallback"])
def test_vi_frame_step_on_the_card(dev, case):
    """graft.vi_frame_step at the EuRoC stereo-inertial size: K1 twice, K2
    twice, K3 once (the motion model from the IMU prediction) and K3s once
    (the local map); the one read of info (and with a carried prior the
    eigendecomposition of its projection) and no other synchronisation; the
    same inliers and pose as the CPU plain path; the IMU prediction taken
    in the fallback case only."""
    cfg, ctx, scene, n_valid = _vi_frame(dev, case)
    args = graft.vi_frame_args(scene, dev)
    graft.vi_frame_step(args, ctx, cfg)        # first call: the captures
    fns = (cuda_brief.KERNEL.fn_launches, cuda_match.KERNEL.fn_launches,
           cuda_pose_opt.KERNEL.fn_launches)
    before = [dict(k) for k in fns]
    import warnings
    torch.cuda.synchronize()
    # The mode is set outside the recording: setting it first warns that
    # the mode is a prototype, which is no synchronisation of the step.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res, _, _ = graft.vi_frame_step(args, ctx, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = sorted(os.path.basename(w.filename) for w in caught
                   if "synchroniz" in str(w.message))
    assert sites == sorted(["device.py"] + (["inertial.py"]
                                            if case == "prior" else []))
    launched = [sum(k.values()) - sum(b.values())
                for k, b in zip(fns, before)]
    assert launched == [2, 2, 2]
    k3 = cuda_pose_opt.KERNEL.fn_launches
    assert k3[cuda_pose_opt.STEREO_FN] - before[2][cuda_pose_opt.STEREO_FN] \
        == 1
    info = res.info
    assert int(info[0]) >= 0.75 * n_valid
    assert np.abs(info[2:11].reshape(3, 3) - np.eye(3)).max() <= 2e-3
    assert bool(res.used_prediction) == (case == "fallback")
    res_c, _, _ = graft.vi_frame_step(graft.vi_frame_args(scene, "cpu"),
                                      graft.vi_context(cfg, "cpu"), cfg)
    assert abs(int(res_c.info[0]) - int(info[0])) <= max(2, 0.01 * info[0])
    assert np.abs(res_c.info[2:14] - info[2:14]).max() <= 1e-3


@pytest.mark.parametrize("na,nb", [(1000, 1000), (999, 1000), (1000, 7),
                                   (13, 1000)])
def test_k2_fisheye_match_shape(dev, gen, na, nb):
    """The fisheye stereo match's launch: none mode, the left frame's
    descriptors against the right frame's (1000 x 1000 at TUM-VI 512's
    features) with validity only, and ragged sizes; bit-identical to the
    plain version, ties (duplicate columns) included."""
    args, gates = _k2_case(gen, dev, "none", na, nb)
    out = _k2_check(args, gates)
    assert int((out[0] < 1024).sum()) > 0


def test_fisheye_stereo_extract_on_the_card(dev):
    """graft.fisheye_stereo_extract at TUM-VI 512 on the stereo-inertial
    fixture's first pair warped to the Kannala-Brandt pair: K1 twice and
    K2 once; the match equals the CPU plain path's on the card's features
    (bar rows within 1e-4 of a float gate, none on this pair so far)."""
    from orbslam3_byzyh_tpu_torch.ops import stereo
    g = graft.vi_stereo_frames()
    left, right = graft.tumvi_kb8_pair(g.left[0], g.right[0])
    rig = graft.fisheye_rig_config(graft.tumvi_vi_golden_config().config)
    t = graft.fisheye_rig_tensors(rig, dev)
    k1, k2 = cuda_brief.KERNEL.launches, cuda_match.KERNEL.launches
    fl, fr, m = graft.fisheye_stereo_extract(
        _t(left, dev).float(), _t(right, dev).float(), rig, t)
    torch.cuda.synchronize()
    assert cuda_brief.KERNEL.launches == k1 + 2
    assert cuda_match.KERNEL.launches == k2 + 1
    cpu = stereo.fisheye_stereo_match(*(x.cpu() for x in (
        fl.xy, fl.level, fl.desc, fl.valid, fr.xy, fr.level, fr.desc,
        fr.valid, t.cam_l, t.cam_r, t.R_rl, t.t_rl)))
    ok = m.valid.cpu()
    assert int(ok.sum()) > 60
    assert int((ok != cpu.valid).sum()) <= 2
    both = ok & cpu.valid
    torch.testing.assert_close(m.depth.cpu()[both], cpu.depth[both],
                               rtol=1e-4, atol=0)


def test_k2_reloc_match_shape(dev, gen):
    """The relocalization's candidate match: none mode over every landmark
    slot (65536 at the EuRoC-mono capacity), rows masked by the landmarks
    the candidate keyframe sees (a few hundred), against a frame's 1536
    keypoints; duplicate columns; bit-identical to the plain version."""
    args, gates = _k2_case(gen, dev, "none", 65536, 1536)
    seen = torch.zeros(65536, dtype=torch.bool, device=dev)
    rows = torch.from_numpy(gen.choice(65536, 600, replace=False)).to(dev)
    seen[rows] = True
    da, db, _, vb = args
    db[1::2] = db[0::2]
    da[rows[:300]] = db[torch.from_numpy(gen.integers(0, 1536, 300)).to(dev)]
    out = _k2_check((da, db, seen, vb), gates)
    assert int((out[0] == 0).sum()) >= 300
    assert bool((out[0][~seen] == 1024).all())


def test_k3_pnp_refine_shape(dev, gen):
    """The relocalization PnP on the card: one row per keypoint (1536), a
    few hundred with a landmark; its refine is one K3 launch over those
    rows, held against the plain version at float64 (1e-4), and the pose
    is the truth's."""
    from orbslam3_byzyh_tpu_torch.ops import pnp
    n, m = 1536, 400
    rows = gen.choice(n, m, replace=False)
    pts = np.zeros((n, 3), np.float32)
    pts[rows] = np.stack([gen.uniform(-4, 4, m), gen.uniform(-3, 3, m),
                          gen.uniform(4, 12, m)], -1)
    R_gt = lie.so3_exp(torch.tensor(gen.normal(0, 0.2, 3))).float()
    t_gt = torch.tensor([0.4, -0.2, 0.3])
    cam = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    pc = pts @ R_gt.numpy().T + t_gt.numpy()
    uv = np.stack([cam[0] * pc[:, 0] / np.maximum(pc[:, 2], 1e-3) + cam[2],
                   cam[1] * pc[:, 1] / np.maximum(pc[:, 2], 1e-3) + cam[3]],
                  -1).astype(np.float32)
    uv += gen.normal(0, 0.5, uv.shape).astype(np.float32)
    out = rows[:80]
    uv[out] += gen.uniform(30, 150, (80, 2)).astype(np.float32)
    corr = np.zeros(n, bool)
    corr[rows] = True
    inv_s2 = (1.0 / 1.2 ** (2.0 * gen.integers(0, 4, n))).astype(np.float32)
    calls = []
    fn = cuda_pose_opt.pose_optimization_kernel

    def spy(*a, **k):
        calls.append(a)
        return fn(*a, **k)

    cuda_pose_opt.pose_optimization_kernel = spy
    try:
        corr_t = _t(corr, dev)
        idx = pnp.draw_indices(torch.Generator(dev).manual_seed(0), corr_t)
        res = pnp.pnp_ransac(idx, _t(pts, dev), _t(uv, dev),
                             _t(inv_s2, dev), corr_t, _t(cam, dev))
        torch.cuda.synchronize()
    finally:
        cuda_pose_opt.pose_optimization_kernel = fn
    assert len(calls) == 1 and calls[0][2].shape == (n, 3)
    a = calls[0]
    Rk, tk, _ = fn(*a)
    Rp, tp, _ = cuda_pose_opt.pose_optimization_plain(
        *(x.double() if x.is_floating_point() else x for x in a))
    torch.cuda.synchronize()
    assert float((Rk.double() - Rp).abs().max()) <= 1e-4
    assert float((tk.double() - tp).abs().max()) <= 1e-4
    assert bool(res.ok) and int(res.n_inliers) > 250
    assert float((res.t.cpu() - t_gt).abs().max()) < 0.05
    assert not bool(res.inlier.cpu()[torch.from_numpy(out)].any())


# -- P1: the PNG unfilter (a port kernel for cv2.imread's libpng) ----------

def _p1_case(gen, h, w, depth, filters):
    from orbslam3_byzyh_tpu_torch.io import png
    hi = 256 if depth == 8 else 65536
    img = ((gen.integers(0, hi, (h, w)) // 4
            + np.add.outer(np.arange(h), 3 * np.arange(w))) % hi).astype(
                np.uint8 if depth == 8 else np.uint16)
    by = (img if depth == 8 else img.astype(">u2")).view(np.uint8).reshape(
        h, -1)
    raw = png.filter_rows(by, depth // 8, filters)
    return png.Inflated("<case>", w, h, depth // 8,
                        png.GREY8 if depth == 8 else png.GREY16, raw), img


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("h,w", [(480, 752), (1030, 37), (1, 5)])
def test_p1_kernel_matches_plain(dev, gen, filters, depth, h, w):
    """P1 bit-identical to the plain unfilter over every filter, at 8 and
    16 bits, at EuRoC's size, past 1,024 rows (two wavefront chunks) and
    on one row."""
    from orbslam3_byzyh_tpu_torch.ops import cuda_png
    inf, img = _p1_case(gen, h, w, depth, filters)
    raw = torch.from_numpy(inf.raw.copy()).to(dev)
    out = cuda_png.unfilter_kernel(raw, inf.width, inf.bpp, inf.mode)
    torch.cuda.synchronize()
    ref = cuda_png.unfilter_plain(raw.cpu(), inf.width, inf.bpp, inf.mode)
    assert torch.equal(out.cpu(), ref)
    np.testing.assert_array_equal(out.cpu().numpy(), img.astype(np.float32))


@pytest.mark.parametrize("ctype,c", [(2, 3), (6, 4), (4, 2)])
def test_p1_colour_to_grey_matches_plain(dev, gen, ctype, c):
    """RGB, RGBA and grey + alpha: libpng's grey rule fused into P1."""
    from orbslam3_byzyh_tpu_torch.io import png
    from orbslam3_byzyh_tpu_torch.ops import cuda_png
    h, w = 96, 131
    px = gen.integers(0, 256, (h, w * c)).astype(np.uint8)
    raw = png.filter_rows(px, c, (4, 3, 1, 2, 0))
    mode = {2: png.RGB8, 6: png.RGBA8, 4: png.GREYA8}[ctype]
    out = cuda_png.unfilter_kernel(torch.from_numpy(raw).to(dev), w, c, mode)
    ref = cuda_png.unfilter_plain(torch.from_numpy(raw), w, c, mode)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)


def test_p1_prefetcher_on_the_card(dev, gen, tmp_path):
    """The prefetcher's device path: the images arrive on the card, equal
    to the plain decode, in order, and P1 launched once an image."""
    from orbslam3_byzyh_tpu_torch.io import png
    from orbslam3_byzyh_tpu_torch.io.prefetch import ImagePrefetcher
    from orbslam3_byzyh_tpu_torch.ops import cuda_png
    paths = []
    for i in range(6):
        img = gen.integers(0, 256, (48, 64)).astype(np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        png.write_png(paths[-1], img, filters=(i % 5,))
    before = cuda_png.KERNEL.launches
    pf = ImagePrefetcher(paths, n_threads=3, capacity=2, device=dev)
    got = list(pf)
    pf.close()
    assert [i for i, _ in got] == list(range(6))
    assert cuda_png.KERNEL.launches - before == 6
    for (i, im), p in zip(got, paths):
        assert im.is_cuda
        np.testing.assert_array_equal(im.cpu().numpy(), png.read_grey(p))


def _f64(x):
    return (x.double() if isinstance(x, torch.Tensor) and x.is_floating_point()
            else x)


@pytest.mark.parametrize("stereo", [False, True])
def test_k3_kb8_kernel_matches_float64_plain(dev, stereo):
    """K3 and K3s with the KB8 camera (TUM-VI 512's coefficients, 1000
    points out to 85 degrees, ``graft.kb8_pose_problem``): one launch of
    the kernel's own launcher, within 1e-4 of the float64 plain version,
    inliers within 2."""
    from orbslam3_byzyh_tpu_torch.ops import camera as cam
    p = graft.kb8_pose_problem(1000, stereo=stereo)
    args = tuple(a if isinstance(a, float) else _t(a, dev) for a in p)
    fn = cuda_pose_opt.STEREO_FN if stereo else cuda_pose_opt.MONO_FN
    kernel = (cuda_pose_opt.pose_optimization_stereo_kernel if stereo
              else cuda_pose_opt.pose_optimization_kernel)
    plain = (cuda_pose_opt.pose_optimization_stereo_plain if stereo
             else cuda_pose_opt.pose_optimization_plain)
    before = cuda_pose_opt.KERNEL.fn_launches[fn]
    Rk, tk, ck = kernel(*args, model_id=cam.KB8)
    assert cuda_pose_opt.KERNEL.fn_launches[fn] == before + 1
    Rp, tp, cp = plain(*(_f64(a) for a in args), model_id=cam.KB8)
    torch.cuda.synchronize()
    assert float((Rk.double() - Rp).abs().max()) <= 1e-4
    assert float((tk.double() - tp).abs().max()) <= 1e-4
    valid = args[7] if stereo else args[5]
    gate = (torch.where(args[4] >= 0, cuda_pose_opt.CHI2_STEREO,
                        cuda_pose_opt.CHI2_MONO) if stereo
            else cuda_pose_opt.CHI2_MONO)
    nk = int(((ck <= gate) & valid).sum())
    npl = int(((cp <= gate) & valid).sum())
    assert abs(nk - npl) <= 2
    with pytest.raises(ValueError, match="8 parameters"):
        kernel(*(a[:4] if i == len(args) - 1 else a
                 for i, a in enumerate(args)), model_id=cam.KB8)


def test_sharded_global_ba_on_one_card(dev):
    """``mapping.global_ba`` over a 4-shard mesh on cuda:0 against the
    unsharded call (tests/test_dist_ba.py's tolerances: R 5e-4, t 5e-3),
    on ``graft.make_tiny_map_state`` with stereo rows; the dry run."""
    from orbslam3_byzyh_tpu_torch.parallel import dist_ba
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    st, camp, bf = graft.make_tiny_map_state(n_kf=6, n_lm=64, device=dev)
    mesh = dist_ba.make_mesh(4, devices=[dev] * 4)
    assert all(d == torch.device("cuda", 0) for d in mesh.devices)
    a = mapping.global_ba(st, camp, use_stereo=True, bf=bf, mesh=mesh)
    b = mapping.global_ba(st, camp, use_stereo=True, bf=bf)
    assert float((a.kfs.R - b.kfs.R).abs().max()) <= 5e-4
    assert float((a.kfs.t - b.kfs.t).abs().max()) <= 5e-3
    state, res = graft.dryrun_multichip(4)
    assert state.kfs.R.is_cuda and float(res.cost) >= 0.0
