#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of the tracking step from
``orbslam3_byzyh_tpu_torch/csrc`` with nvcc (in parallel), holds each
against its plain PyTorch version on the card, runs ``graft.tracking_step``
on a scene that tracks (the example image against a map lifted from its own
features), checks the result and that every kernel was launched once by that
run, and times the step and each kernel. Any failed check raises and the
script exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``. Needs a CUDA device and ``nvcc``.

Per kernel, at the main path's shapes:
  * ``ms``: the launch alone. The wrapper's launch is captured once and its
    C function is called again with the same prepared pointers; a spin kernel
    queued first keeps the host's launch cost out of the CUDA-event pair.
    Median of 50.
  * ``wrapper_ms``: CUDA events around the Python wrapper (its torch ops and
    the host's launch cost included, the device otherwise idle). Median of 50.
  * ``plain_ms``: the same around the plain PyTorch version.
  * ``bound_ms``: the larger of the bytes the function must move over the
    HBM rate and the operations this run's data needs over the peak rate of
    their type (NVIDIA's H100 SXM data sheet, 700 W).
  * ``ptxas``: registers, shared memory and spills from nvcc's report.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
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
# Spin (clock cycles, ~0.5 ms) queued before a launch-alone sample, so that
# the launch is queued before the start event executes.
PRIME_CYCLES = 1_000_000
# Published H100 SXM peaks at 700 W: HBM3 bytes/s, float32 outside the
# tensor cores FLOP/s, int8 tensor-core OP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = N_TIMED_LAUNCHES, primed: bool = False) -> float:
    """Median CUDA-event time of one call over ``reps`` calls, after warm-up.
    ``primed`` queues a spin kernel first, so the events time the device
    work alone and not the host's enqueueing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def captured_launch(kernel, call):
    """Run ``call()`` once and return (its result, a function that repeats
    its kernel's launch alone: the exported C function called with the same
    prepared arguments). Keep the result alive while the launch is repeated:
    it owns the output buffers. Repeats do not count as launches."""
    seen = []
    launch = kernel.launch

    def spy(fn, *args):
        seen.append((fn, args))
        launch(fn, *args)

    kernel.launch = spy
    try:
        out = call()
    finally:
        del kernel.launch
    require(len(seen) == 1, f"{kernel.name}: {len(seen)} launches in one call")
    fn, args = seen[0]
    c_fn = getattr(kernel.build(), fn)

    def again():
        err = c_fn(*args)
        if err != 0:
            raise RuntimeError(f"{kernel.name}.{fn}: CUDA error {err}")

    return out, again


def ptxas_summary(kernel) -> list:
    """Per compiled kernel: registers, shared memory and spill bytes, from
    the build's ``-Xptxas=-v`` report (empty if the build kept none)."""
    log = kernel.library_path().with_suffix(".log")
    if not log.exists():
        return []
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    cxxfilt = shutil.which("c++filt")
    for entry in out:
        if cxxfilt:
            entry["function"] = subprocess.run(
                [cxxfilt, entry["function"]], capture_output=True,
                text=True).stdout.strip() or entry["function"]
    return out


def tensor_instructions(kernel) -> dict | None:
    """Counts of tensor-core instructions (BMMA, IMMA, HMMA) in the kernel's
    SASS, by ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(kernel.library_path())],
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("BMMA", "IMMA", "HMMA")}


def bound(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): ``ops`` maps a peak rate to the
    operations counted at that rate."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = sum(n / rate for rate, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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

    # -- 1: build, one nvcc per source, all started together ----------------
    kernels = {"K1": cuda_brief.KERNEL, "K2": cuda_match.KERNEL,
               "K3": cuda_pose_opt.KERNEL}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(k.build) for k in kernels.values()]:
            f.result()
    phase("1 build", f"{time.perf_counter() - t0:.1f} s wall; " + ", ".join(
        f"{n} {k.source.name} {k.build_seconds:.1f} s"
        for n, k in kernels.items()))
    ptxas = {n: ptxas_summary(k) for n, k in kernels.items()}
    for n, entries in ptxas.items():
        for e in entries:
            phase("1 build", f"{n} ptxas {e}")
    tensor_ops = tensor_instructions(cuda_match.KERNEL)
    phase("1 build", f"K2 SASS tensor-core instructions: {tensor_ops}")

    rng = np.random.default_rng(0)
    arrays = graft.example_arrays()
    h, w = arrays[0].shape
    img = torch.from_numpy(arrays[0]).to(dev)
    results = {}
    repeat = {}

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
    d_kernel, repeat["K1"] = captured_launch(
        cuda_brief.KERNEL, lambda: cuda_brief.brief_descriptors_kernel(*k1_args))
    d_plain = cuda_brief.brief_descriptors_plain(*k1_args)
    torch.cuda.synchronize()
    k1_err = int((d_kernel.long() - d_plain.long()).abs().max())
    require(torch.equal(d_kernel, d_plain), "K1 descriptors differ from plain")
    # Bound: each distinct sampled pixel read once (4 B), the keypoints'
    # xy, level, cos, sin (20 B), the 512 pattern coordinates (2 x 512 x
    # 4 B), the words written (32 B); 6 flops to rotate each sample point.
    n_kp = xy.shape[0]
    offs = np.cumsum([0] + [a * b for a, b in shapes])[:-1]
    table = torch.tensor([[o, a, b] for o, (a, b) in zip(offs, shapes)],
                         dtype=torch.int64, device=dev)[kp_level.long()]
    gy, gx = fast_orb._pattern_positions(xy, ca, sa, table[:, 2:3].float(),
                                         table[:, 1:2].float())
    n_pix = int(torch.unique(table[:, 0:1] + gy.long() * table[:, 2:3]
                             + gx.long()).numel())
    results["K1"] = {"max_abs_err": k1_err}
    results["K1"]["bound_ms"], results["K1"]["bound_by"] = bound(
        4 * n_pix + 20 * n_kp + 2 * 512 * 4 + 32 * n_kp,
        {F32_FLOPS: 6 * 512 * n_kp})
    results["K1"]["bound"] = (
        f"{n_pix} distinct sampled pixels x 4 B + K={n_kp} x (20 B in + 32 B "
        f"out) + 4 KB pattern over {HBM_BPS / 1e12} TB/s; 6 x 512 x K f32 "
        f"flops over {F32_FLOPS / 1e12} TFLOP/s")
    results["K1"]["ms"] = event_ms(repeat["K1"], primed=True)
    results["K1"]["wrapper_ms"] = event_ms(
        lambda: cuda_brief.brief_descriptors_kernel(*k1_args))
    results["K1"]["plain_ms"] = event_ms(
        lambda: cuda_brief.brief_descriptors_plain(*k1_args))
    phase("2 K1", f"K={n_kp} over {len(shapes)} levels: bit-identical "
          f"descriptors; launch alone {results['K1']['ms']:.4f} ms, wrapper "
          f"{results['K1']['wrapper_ms']:.4f} ms, plain "
          f"{results['K1']['plain_ms']:.4f} ms, bound "
          f"{results['K1']['bound_ms']:.5f} ms ({card})")

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
    out_k, repeat["K2"] = captured_launch(
        cuda_match.KERNEL,
        lambda: cuda_match.hamming_best2_kernel(qa, qb, qva, qvb, **gates))
    # Bound: descriptors, validity and window data read once, three int32
    # per row written. Operations: the gate (5 f32 flops) on every pair of
    # a valid row and a valid column, and the distance on every pair that
    # passes it, counted as a +-1 int8 dot product (256 multiply-adds): the
    # kernel's 1-bit AND-popc products have no published H100 rate.
    na, nb = qa.shape[0], qb.shape[0]
    gate = (matching.window_mask(gates["xy_a"], gates["xy_b"], gates["radius"])
            & matching.level_mask(gates["level_a"], gates["level_b"], -1, 1))
    n_gated = int((gate & qva[:, None] & qvb[None, :]).sum())
    n_valid_pairs = int(qva.sum()) * int(qvb.sum())
    results["K2"] = {"max_abs_err": k2_err}
    results["K2"]["bound_ms"], results["K2"]["bound_by"] = bound(
        na * (32 + 1 + 8 + 4 + 4 + 12) + nb * (32 + 1 + 8 + 4),
        {F32_FLOPS: 5 * n_valid_pairs, INT8_OPS: 2 * 256 * n_gated})
    results["K2"]["bound"] = (
        f"N={na} x 61 B + M={nb} x 45 B over {HBM_BPS / 1e12} TB/s; gate 5 "
        f"f32 flops x {n_valid_pairs} valid pairs over {F32_FLOPS / 1e12} "
        f"TFLOP/s + 512 int8 ops x {n_gated} gated pairs over "
        f"{INT8_OPS / 1e12} TOP/s")
    results["K2"]["ms"] = event_ms(repeat["K2"], primed=True)
    results["K2"]["wrapper_ms"] = event_ms(
        lambda: cuda_match.hamming_best2_kernel(qa, qb, qva, qvb, **gates))
    results["K2"]["plain_ms"] = event_ms(
        lambda: cuda_match.hamming_best2_plain(qa, qb, qva, qvb, **gates))
    phase("3 K2", f"window {na}x{nb}: launch alone {results['K2']['ms']:.4f} "
          f"ms, wrapper {results['K2']['wrapper_ms']:.4f} ms, plain "
          f"{results['K2']['plain_ms']:.4f} ms, bound "
          f"{results['K2']['bound_ms']:.5f} ms ({card})")

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
    (Rk, tk, chi2k), repeat["K3"] = captured_launch(
        cuda_pose_opt.KERNEL,
        lambda: cuda_pose_opt.pose_optimization_kernel(*k3_args))
    Rp, tp, chi2p = cuda_pose_opt.pose_optimization_plain(*k3_args)
    torch.cuda.synchronize()
    k3_err = max(float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
    n_k = int(((chi2k <= cuda_pose_opt.CHI2_MONO) & pvalid).sum())
    n_p = int(((chi2p <= cuda_pose_opt.CHI2_MONO) & pvalid).sum())
    require(k3_err <= 1e-4, f"K3 pose differs from plain by {k3_err}")
    require(abs(n_k - n_p) <= 2, f"K3 inliers {n_k} vs plain {n_p}")
    # Bound: 25 B per point in (xyz, uv, 1/sigma^2, valid) and 4 B out, the
    # poses and camera. Operations: 45 passes (the first of round 0, one per
    # LM iteration, the three re-markings fused with the next round's first
    # pass, the final chi2). Round 0's 11 passes cover every valid point;
    # the 34 later ones are counted over the final inliers, the mask the
    # later rounds converge to. A pass costs 31 flops per point for the
    # residual and chi2, plus 159 for the Jacobian, the 21 H and 6 g terms
    # and the cost where the point is in the mask.
    n_valid = int(pvalid.sum())
    flops = (11 * n_valid + 34 * n_k) * 190 + 4 * n_valid * 31
    results["K3"] = {"max_abs_err": k3_err}
    results["K3"]["bound_ms"], results["K3"]["bound_by"] = bound(
        npt * (25 + 4) + 2 * 48 + 16, {F32_FLOPS: flops})
    results["K3"]["bound"] = (
        f"N={npt} x 29 B over {HBM_BPS / 1e12} TB/s; (11 x {n_valid} valid + "
        f"34 x {n_k} inliers) x 190 + 4 x {n_valid} x 31 = {flops} f32 flops "
        f"over {F32_FLOPS / 1e12} TFLOP/s")
    results["K3"]["ms"] = event_ms(repeat["K3"], primed=True)
    results["K3"]["wrapper_ms"] = event_ms(
        lambda: cuda_pose_opt.pose_optimization_kernel(*k3_args))
    results["K3"]["plain_ms"] = event_ms(
        lambda: cuda_pose_opt.pose_optimization_plain(*k3_args), reps=10)
    phase("4 K3", f"N={npt}: max |dR|,|dt| {k3_err:.2e}; inliers kernel {n_k} "
          f"plain {n_p}; launch alone {results['K3']['ms']:.4f} ms, wrapper "
          f"{results['K3']['wrapper_ms']:.4f} ms, plain "
          f"{results['K3']['plain_ms']:.4f} ms, bound "
          f"{results['K3']['bound_ms']:.5f} ms ({card})")

    # -- 5: the slice through the kernels -----------------------------------
    for k in kernels.values():
        k.launches = 0
    R, t, n_inl = graft.tracking_step(*scene)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    eye = torch.eye(3, device=dev)
    r_err, t_err = float((R - eye).abs().max()), float(t.abs().max())
    n_gpu = int(n_inl)
    require(all(v == 1 for v in launches.values()),
            f"each kernel must launch once in the slice: {launches}")
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
        phase("6 times", f"{n}: launch alone {r['ms']:.4f} ms, wrapper "
              f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({card})")

    sources = {"K1": ("steered-BRIEF sampler", "csrc/brief.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_brief.py:161",
                      "none: no single PyTorch call gathers rotated sample "
                      "pairs and packs their bits"),
               "K2": ("masked-Hamming top-2", "csrc/match.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_match.py:106",
                      "none: torch has no popcount op and no masked top-2 "
                      "with this tie rule"),
               "K3": ("fused pose optimization", "csrc/pose_opt.cu",
                      "orbslam3_byzyh_tpu/solver/pallas_pose_opt.py:297",
                      "none: torch has no fused Levenberg-Marquardt solver")}
    print(json.dumps({"kernels": [
        {"name": f"{n} {sources[n][0]}", "route": "cuda",
         "source": f"orbslam3_byzyh_tpu_torch/{sources[n][1]}",
         "replaces": sources[n][2], "launches": launches[n],
         "max_abs_err": results[n]["max_abs_err"],
         "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"],
         "bound_ms": results[n]["bound_ms"],
         "bound_by": results[n]["bound_by"], "library_ms": None,
         "library": sources[n][3], "wrapper_ms": results[n]["wrapper_ms"],
         "bound": results[n]["bound"], "ptxas": ptxas[n]}
        for n in kernels], "k2_sass_tensor_instructions": tensor_ops,
        "step_ms": step_med, "step_p80_ms": step_p80, "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
