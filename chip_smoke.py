#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of the tracking step from
``orbslam3_byzyh_tpu_torch/csrc`` with nvcc, holds each against its plain
PyTorch version on the card, runs ``graft.tracking_step`` on a scene that
tracks (the example image against a map lifted from its own features),
checks the result and that every kernel was launched by that run, and times
the step and each kernel beside its plain version. Any failed check raises
and the script exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_TIMED_FRAMES = 50
N_TIMED_LAUNCHES = 50
# Steps right after start-up ran up to 2x slower than the steady state on an
# H100 80GB HBM3 at 700 W; time only after this many steps.
N_WARMUP_STEPS = 100


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = N_TIMED_LAUNCHES) -> float:
    """Median device time of one call over ``reps`` calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch import device as device_mod
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match, fast_orb
    from orbslam3_byzyh_tpu_torch.ops import matching
    from orbslam3_byzyh_tpu_torch.pipeline import tracking
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    dev = device_mod.resolve("cuda")
    card = card_line()
    phase("0 device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # -- 1: build ---------------------------------------------------------
    kernels = {"K1": cuda_brief.KERNEL, "K2": cuda_match.KERNEL,
               "K3": cuda_pose_opt.KERNEL}
    t0 = time.perf_counter()
    for k in kernels.values():
        k.build()
    phase("1 build", f"{time.perf_counter() - t0:.1f} s total; " + ", ".join(
        f"{n} {k.source.name} {k.build_seconds:.1f} s"
        for n, k in kernels.items()))

    rng = np.random.default_rng(0)
    arrays = graft.example_arrays()
    h, w = arrays[0].shape
    img = torch.from_numpy(arrays[0]).to(dev)
    results = {}

    # -- 2: K1 vs plain at the 8 levels of a 480x640 frame ----------------
    pyr = fast_orb.build_pyramid(img, 8, 1.2)
    budget = fast_orb.level_feature_budget(graft.N_FEATURES, 8, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    blurred = torch.cat([fast_orb.gaussian_blur(p).reshape(-1) for p in pyr])
    xy, lvl = [], []
    for i, ((lh, lw), cap) in enumerate(zip(shapes, budget)):
        # Most keypoints inside the 19 px border, some at the image edge.
        inner = np.stack([rng.integers(19, lw - 19, cap),
                          rng.integers(19, lh - 19, cap)], -1)
        edge = np.stack([rng.integers(0, lw, cap), rng.integers(0, lh, cap)], -1)
        pick = rng.random(cap) < 0.1
        xy.append(np.where(pick[:, None], edge, inner).astype(np.float32))
        lvl.append(np.full(cap, i, np.int32))
    xy = torch.from_numpy(np.concatenate(xy)).to(dev)
    kp_level = torch.from_numpy(np.concatenate(lvl)).to(dev)
    angle = torch.from_numpy(
        rng.uniform(-np.pi, np.pi, xy.shape[0]).astype(np.float32)).to(dev)
    ca, sa = torch.cos(angle), torch.sin(angle)
    k1_args = (blurred, shapes, xy, kp_level, ca, sa)
    d_kernel = cuda_brief.brief_descriptors_kernel(*k1_args)
    d_plain = cuda_brief.brief_descriptors_plain(*k1_args)
    torch.cuda.synchronize()
    k1_err = int((d_kernel.long() - d_plain.long()).abs().max())
    require(torch.equal(d_kernel, d_plain), "K1 descriptors differ from plain")
    results["K1"] = {"max_abs_err": k1_err,
                     "ms": cuda_ms(lambda: cuda_brief.brief_descriptors_kernel(*k1_args)),
                     "plain_ms": cuda_ms(lambda: cuda_brief.brief_descriptors_plain(*k1_args))}
    phase("2 K1", f"K={xy.shape[0]} over {len(shapes)} levels: bit-identical "
          f"descriptors; kernel {results['K1']['ms']:.4f} ms, plain "
          f"{results['K1']['plain_ms']:.4f} ms ({card})")

    # The lifted scene from the card's own features: it feeds K2, K3 and
    # the slice.
    feats = fast_orb.extract(img, n_features=graft.N_FEATURES)
    scene_np = graft.lifted_scene(
        convert.to_numpy(feats.xy), convert.to_numpy(feats.level),
        convert.to_numpy(feats.desc), convert.to_numpy(feats.valid))
    scene = convert.tree_to_torch(scene_np, dev)
    (_, R0, t0_, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
     cam) = scene

    # -- 3: K2 vs plain -----------------------------------------------------
    visible, proj, _, plevel = matching.frustum_cull(
        R0, t0_, lm_pos, lm_normal, lm_min_d, lm_max_d, cam, float(w),
        float(h))
    window = dict(xy_a=proj, xy_b=feats.xy,
                  radius=4.0 * tracking.SCALE ** plevel.float(),
                  level_a=plevel, level_b=feats.level, level_window=(-1, 1))
    k2_cases = {"window": (lm_desc, feats.desc, visible & lm_valid,
                           feats.valid, window)}
    # none / epipolar at 1024 x 1024 with duplicate descriptors (ties).
    n = 1024
    da = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 8),
                                       dtype=np.int64).astype(np.int32))
    db = da[torch.from_numpy(rng.permutation(n))].clone()
    db[1::2] = db[0::2]                       # every column has a twin
    da, db = da.to(dev), db.to(dev)
    va = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    vb = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    lines = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32)).to(dev)
    lines[:, 2] *= 300.0
    kxy = torch.from_numpy(rng.uniform(0, 640, (n, 2)).astype(np.float32)).to(dev)
    th = torch.from_numpy(rng.uniform(50, 5000, n).astype(np.float32)).to(dev)
    k2_cases["none"] = (da, db, va, vb, {})
    k2_cases["epipolar"] = (da, db, va, vb, dict(xy_b=kxy, lines=lines,
                                                 line_th=th))
    k2_err = 0
    for mode, (qa, qb, qva, qvb, gates) in k2_cases.items():
        out_k = cuda_match.hamming_best2_kernel(qa, qb, qva, qvb, **gates)
        out_p = cuda_match.hamming_best2_plain(qa, qb, qva, qvb, **gates)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "second", "best_j"), out_k, out_p):
            k2_err = max(k2_err, int((a.long() - b.long()).abs().max()))
            require(torch.equal(a, b), f"K2 {mode}: {name} differs from plain")
        matched = int((out_k[0] < matching.INVALID_DIST).sum())
        ties = int((out_k[0] == out_k[1]).sum())
        phase("3 K2", f"{mode}: {qa.shape[0]}x{qb.shape[0]} identical "
              f"(rows with a candidate {matched}, best==second {ties})")
    qa, qb, qva, qvb, gates = k2_cases["window"]
    results["K2"] = {
        "max_abs_err": k2_err,
        "ms": cuda_ms(lambda: cuda_match.hamming_best2_kernel(qa, qb, qva, qvb, **gates)),
        "plain_ms": cuda_ms(lambda: cuda_match.hamming_best2_plain(qa, qb, qva, qvb, **gates))}
    phase("3 K2", f"window {qa.shape[0]}x{qb.shape[0]}: kernel "
          f"{results['K2']['ms']:.4f} ms, plain {results['K2']['plain_ms']:.4f} ms "
          f"({card})")

    # -- 4: K3 vs plain on the lifted scene's points ------------------------
    npt = graft.N_FEATURES
    pts = lm_pos[:npt]
    obs_np = convert.to_numpy(feats.xy).astype(np.float64)
    obs_np += rng.normal(0, 0.5, obs_np.shape)
    out_idx = rng.choice(npt, 60, replace=False)
    obs_np[out_idx] += rng.uniform(20, 80, (60, 2))
    obs = torch.from_numpy(obs_np.astype(np.float32)).to(dev)
    inv_s2 = tracking.INV_SIGMA2.to(dev)[feats.level.long()]
    valid_np = np.ones(npt, bool)
    valid_np[rng.choice(npt, 30, replace=False)] = False
    pvalid = torch.from_numpy(valid_np).to(dev) & feats.valid
    k3_args = (R0, t0_, pts, obs, inv_s2, pvalid, cam)
    Rk, tk, chi2k = cuda_pose_opt.pose_optimization_kernel(*k3_args)
    Rp, tp, chi2p = cuda_pose_opt.pose_optimization_plain(*k3_args)
    torch.cuda.synchronize()
    k3_err = max(float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
    n_k = int(((chi2k <= cuda_pose_opt.CHI2_MONO) & pvalid).sum())
    n_p = int(((chi2p <= cuda_pose_opt.CHI2_MONO) & pvalid).sum())
    require(k3_err <= 1e-4, f"K3 pose differs from plain by {k3_err}")
    require(abs(n_k - n_p) <= 2, f"K3 inliers {n_k} vs plain {n_p}")
    results["K3"] = {"max_abs_err": k3_err,
                     "ms": cuda_ms(lambda: cuda_pose_opt.pose_optimization_kernel(*k3_args)),
                     "plain_ms": cuda_ms(lambda: cuda_pose_opt.pose_optimization_plain(*k3_args), reps=10)}
    phase("4 K3", f"N={npt}: max |dR|,|dt| {k3_err:.2e}; inliers kernel {n_k} "
          f"plain {n_p}; kernel {results['K3']['ms']:.4f} ms, plain "
          f"{results['K3']['plain_ms']:.4f} ms ({card})")

    # -- 5: the slice through the kernels -----------------------------------
    for k in kernels.values():
        k.launches = 0
    R, t, n_inl = graft.tracking_step(*scene)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    eye = torch.eye(3, device=dev)
    r_err, t_err = float((R - eye).abs().max()), float(t.abs().max())
    n_gpu = int(n_inl)
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched by the slice: {launches}")
    require(bool(torch.isfinite(R).all() and torch.isfinite(t).all()),
            "non-finite pose")
    require(n_gpu >= 900, f"n_inliers {n_gpu} < 900")
    require(r_err <= 1e-3 and t_err <= 1e-3,
            f"pose error R {r_err} t {t_err} > 1e-3")
    cpu_scene = tuple(a.cpu() for a in scene)
    _, _, n_cpu = graft.tracking_step(*cpu_scene)
    n_cpu = int(n_cpu)
    require(abs(n_cpu - n_gpu) <= 0.01 * n_gpu,
            f"CPU n_inliers {n_cpu} vs card {n_gpu} differ by more than 1%")
    phase("5 slice", f"tracking_step 480x640, {graft.N_FEATURES} features, "
          f"{lm_pos.shape[0]} landmarks: n_inliers {n_gpu} (CPU plain "
          f"versions {n_cpu}); |R-I| {r_err:.2e} |t| {t_err:.2e}; "
          f"launches {launches}")

    # -- 6: times --------------------------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    frames = [img + 0.5 * torch.randn(img.shape, device=dev, generator=gen)
              for _ in range(N_TIMED_FRAMES)]
    for i in range(N_WARMUP_STEPS):
        graft.tracking_step(frames[i % N_TIMED_FRAMES], *scene[1:])
    step_ms = []
    for frame in frames:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        graft.tracking_step(frame, *scene[1:])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_start) * 1e3)
    step_med = statistics.median(step_ms)
    # p80: the highest percentile with ten samples beyond it at 50 frames.
    step_p80 = statistics.quantiles(step_ms, n=5)[-1]
    phase("6 times", f"tracking_step median {step_med:.3f} ms, p80 "
          f"{step_p80:.3f} ms over {N_TIMED_FRAMES} frames (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
          f"{1e3 / step_med:.1f} fps, after {N_WARMUP_STEPS} warm-up steps "
          f"({card})")
    for n, r in results.items():
        phase("6 times", f"{n}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms ({card})")

    sources = {"K1": ("steered-BRIEF sampler", "csrc/brief.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_brief.py:161"),
               "K2": ("masked-Hamming top-2", "csrc/match.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_match.py:106"),
               "K3": ("fused pose optimization", "csrc/pose_opt.cu",
                      "orbslam3_byzyh_tpu/solver/pallas_pose_opt.py:297")}
    print(json.dumps({"kernels": [
        {"name": f"{n} {sources[n][0]}", "route": "cuda",
         "source": f"orbslam3_byzyh_tpu_torch/{sources[n][1]}",
         "replaces": sources[n][2], "launches": launches[n],
         "max_abs_err": results[n]["max_abs_err"],
         "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"]}
        for n in kernels], "step_ms": step_med}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
