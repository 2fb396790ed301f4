"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

Marked ``cuda`` and skipped without a CUDA device: the kernels have no CPU
mode. The file imports neither JAX nor the conftest's fixtures, so on a
machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

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


def test_k1_kernel_matches_plain(dev, gen):
    img = _t(graft.example_arrays(240, 320, 16)[0], dev)
    pyr = fast_orb.build_pyramid(img, 4, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    blurred = torch.cat([fast_orb.gaussian_blur(p).reshape(-1) for p in pyr])
    k = 200
    lvl = gen.integers(0, 4, k).astype(np.int32)
    xy = np.stack([gen.integers(0, 320, k), gen.integers(0, 240, k)], -1)
    xy = np.floor(xy / 1.2 ** lvl[:, None]).astype(np.float32)
    ang = _t(gen.uniform(-np.pi, np.pi, k).astype(np.float32), dev)
    args = (blurred, shapes, _t(xy, dev), _t(lvl, dev), torch.cos(ang),
            torch.sin(ang))
    out = cuda_brief.brief_descriptors_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_brief.brief_descriptors_plain(*args))


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_k2_kernel_matches_plain(dev, gen, mode):
    na, nb = 700, 300
    db = gen.integers(0, 2 ** 32, (nb, 8), dtype=np.uint32)
    db[1::2] = db[0::2]                       # duplicate columns: ties
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
    args = tuple(_t(a, dev) for a in (da, db, va, vb))
    out = cuda_match.hamming_best2_kernel(*args, **gates)
    ref = cuda_match.hamming_best2_plain(*args, **gates)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
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
    # Gram-Schmidt + scalar Cholesky against SVD + linalg.solve, float32.
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
