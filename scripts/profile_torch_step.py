#!/usr/bin/env python3
"""Where the time of the port's per-frame steps goes, on one CUDA device.

    python scripts/profile_torch_step.py [--entry all] [--frames 20] [--out DIR]

``--entry tracking``: ``graft.tracking_step`` on the lifted scene (480x640,
1024 features, 4096 landmarks). ``--entry mono``: ``graft.mono_frame_step``
on the EuRoC-mono scene (752x480 + radtan, 1200 features, 65536 landmark
slots, normal case), with the caller's read of ``info`` as the system does
it. ``--entry keyframe``: ``graft.mono_keyframe_step`` on
``graft.euroc_mono_map`` (1024 keyframe and 65536 landmark slots, 200 live
keyframes, normal case), every call from the same input map, ending in the
caller's read of ``info``; its stages are the bundle's stage functions
re-run on the inputs the step gave them. ``both`` runs tracking and mono,
``all`` (the default) the three in turn. For each it reports, with the
card's name and power limit:
  * the step and its stages by host clock around synchronised calls,
    median over the frames (each a different noisy copy of the image),
    after 100 warm-up steps;
  * a ``torch.profiler`` trace of a few steps: device time by kernel, the
    device's busy share of the traced wall time, the number of kernel
    launches per step, and K1-K3 by name. The table and a Chrome trace go
    to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entry", choices=("tracking", "mono", "keyframe", "both",
                                        "all"), default="all")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch import device as device_mod
    from orbslam3_byzyh_tpu_torch.ops import fast_orb
    from orbslam3_byzyh_tpu_torch.pipeline import tracking

    dev = device_mod.resolve("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(dev).manual_seed(0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def noisy(img):
        return [img + 0.5 * torch.randn(img.shape, device=dev, generator=gen)
                for _ in range(args.frames)]

    def report(label, frames, step, stages):
        """Warm up, time the stages and the step, then profile 5 steps.
        ``stages`` maps a stage name to fn(frame) -> time in ms."""
        # Steps right after start-up run slower than the steady state.
        for i in range(100):
            step(frames[i % len(frames)])
        times = {name: [] for name in stages}
        times["step"] = []
        for frame in frames:
            for name, fn in stages.items():
                times[name].append(fn(frame))
            times["step"].append(timed(lambda: step(frame))[1])
        med = {k: statistics.median(v) for k, v in times.items()}
        parts = " + ".join(f"{k} {med[k]:.3f} ms" for k in stages)
        print(f"[{label} stages] step {med['step']:.3f} ms = {parts} "
              f"(median of {args.frames}; {card})")

        from torch.profiler import ProfilerActivity, profile
        n_prof = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for frame in frames[:n_prof]:
                step(frame)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        print(f"[{label} profile] {n_prof} steps: wall "
              f"{wall_us / n_prof / 1e3:.3f} ms/step, device busy "
              f"{busy_us / n_prof / 1e3:.3f} ms/step "
              f"({100 * busy_us / wall_us:.1f}% busy, "
              f"{100 - 100 * busy_us / wall_us:.1f}% idle), "
              f"{launches / n_prof:.0f} kernel launches/step ({card})")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:15]:
            print(f"[{label} profile] {e.self_device_time_total / n_prof:9.1f} "
                  f"us/step x{e.count // n_prof:4d}  {e.key[:90]}")
        # The port's own kernels by name, wherever they rank.
        for kname, name in (("K1", "brief_kernel"), ("K2", "match_kernel"),
                            ("K3", "pose_opt_kernel")):
            mine = [e for e in events if name in e.key]
            us = sum(e.self_device_time_total for e in mine) / n_prof
            count = sum(e.count for e in mine) / n_prof
            print(f"[{label} kernel] {kname} {name}: {us:.1f} us/step device "
                  f"time, {count:.0f} launches/step ({card})")
        out = os.path.join(args.out, label)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "key_averages.txt"), "w") as fh:
            fh.write(f"{card}\n")
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    if args.entry in ("tracking", "both", "all"):
        img = convert.to_torch(graft.example_arrays()[0], dev)
        f = fast_orb.extract(img, n_features=graft.N_FEATURES)
        scene = convert.tree_to_torch(graft.lifted_scene(
            *(convert.to_numpy(a) for a in (f.xy, f.level, f.desc,
                                            f.valid))), dev)
        h, w = img.shape
        bind = torch.full((graft.N_FEATURES,), -1, dtype=torch.int32,
                          device=dev)
        held = {}

        def extract(frame):
            held["f"], ms = timed(lambda: fast_orb.extract(
                frame, n_features=graft.N_FEATURES))
            return ms

        def local_map(_):
            f = held["f"]
            return timed(lambda: tracking.track_local_map(
                scene[1], scene[2], bind, *scene[3:9], f.xy, f.level, f.desc,
                f.valid, scene[9], w, h))[1]

        report("tracking", noisy(img),
               lambda fr: graft.tracking_step(fr, *scene[1:]),
               {"extract": extract, "track_local_map": local_map})

    if args.entry in ("mono", "both", "all"):
        cfg = graft.EUROC_MONO
        img = convert.to_torch(graft.example_image(cfg.height, cfg.width), dev)
        cam = convert.to_torch([cfg.fx, cfg.fy, cfg.cx, cfg.cy], dev)
        dist = convert.to_torch(list(cfg.dist), dev)
        f = graft.mono_extract(img, cam, dist)
        a = graft.MonoFrameArgs(*convert.tree_to_torch(graft.euroc_mono_scene(
            *(convert.to_numpy(x) for x in (f.xy, f.level, f.desc, f.angle,
                                            f.valid))), dev))
        held = {}

        def mono_extract(frame):
            held["f"], ms = timed(lambda: graft.mono_extract(frame, cam, dist))
            return ms

        def frame_step(_):
            f = held["f"]
            return timed(lambda: tracking.frame_step(
                a.R_pred, a.t_pred, a.R_last, a.t_last, a.lm_pos, a.lm_desc,
                a.lm_normal, a.lm_min_d, a.lm_max_d, a.lm_valid, a.last_bind,
                a.last_desc, a.last_angle, f.xy, f.level, f.desc, f.valid,
                f.angle, torch.full((cfg.n_features,), -1.0, device=dev),
                torch.zeros((), device=dev), torch.zeros((), device=dev),
                a.obs_kf, a.obs_valid, a.ref_kf, cfg.kf_ref_min_obs, a.n_kf,
                a.n_found, a.n_visible, a.cam_params, cfg.width, cfg.height,
                max_kf=cfg.max_kf)[1].cpu())[1]

        def step(frame):
            return graft.mono_frame_step(frame, *a[1:])[1].cpu()

        report("mono", noisy(img), step,
               {"mono_extract": mono_extract, "frame_step": frame_step})

    if args.entry in ("keyframe", "all"):
        from orbslam3_byzyh_tpu_torch.pipeline import mapping
        kargs = graft.mono_map_args(graft.euroc_mono_map(), dev)
        # Capture the inputs the step gives each stage function.
        names = ("landmark_overflow_valve", "triangulate_pair",
                 "fuse_duplicates", "windowed_local_ba", "cull_landmarks",
                 "cull_keyframes")
        calls = {name: [] for name in names}
        originals = {name: getattr(mapping, name) for name in names}

        def spy(name):
            def fn(*a, **kw):
                calls[name].append((a, kw))
                return originals[name](*a, **kw)
            return fn

        for name in names:
            setattr(mapping, name, spy(name))
        try:
            graft.mono_keyframe_step(*kargs)
        finally:
            for name, fn in originals.items():
                setattr(mapping, name, fn)

        def stage(name):
            return lambda _: timed(lambda: [originals[name](*a, **kw)
                                            for a, kw in calls[name]])[1]

        report("keyframe", [None] * args.frames,
               lambda _: graft.mono_keyframe_step(*kargs)[2].cpu(),
               {name: stage(name) for name in names})
    return 0


if __name__ == "__main__":
    sys.exit(main())
