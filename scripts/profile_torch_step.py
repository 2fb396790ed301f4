#!/usr/bin/env python3
"""Where the time of the port's tracking step goes, on one CUDA device.

    python scripts/profile_torch_step.py [--frames 20] [--out DIR]

Runs ``orbslam3_byzyh_tpu_torch.graft.tracking_step`` on the lifted scene
(480x640, 1024 features, 4096 landmarks) and reports, each with the card's
name and power limit:
  * the step and its two stages (``fast_orb.extract``, ``track_local_map``)
    by host clock around synchronised calls, median over the frames;
  * a ``torch.profiler`` trace of a few steps: device time by kernel, the
    device's busy share of the traced wall time, and the number of kernel
    launches per step. The table and a Chrome trace go to ``--out``.
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
    img = convert.to_torch(graft.example_arrays()[0], dev)
    f = fast_orb.extract(img, n_features=graft.N_FEATURES)
    scene = convert.tree_to_torch(graft.lifted_scene(
        *(convert.to_numpy(a) for a in (f.xy, f.level, f.desc, f.valid))), dev)
    h, w = img.shape
    gen = torch.Generator(dev).manual_seed(0)
    frames = [img + 0.5 * torch.randn(img.shape, device=dev, generator=gen)
              for _ in range(args.frames)]
    # Steps right after start-up run slower than the steady state.
    for i in range(100):
        graft.tracking_step(frames[i % len(frames)], *scene[1:])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    ext, loc, step = [], [], []
    bind = torch.full((graft.N_FEATURES,), -1, dtype=torch.int32, device=dev)
    for frame in frames:
        feats, t_ext = timed(lambda: fast_orb.extract(
            frame, n_features=graft.N_FEATURES))
        _, t_loc = timed(lambda: tracking.track_local_map(
            scene[1], scene[2], bind, *scene[3:9], feats.xy, feats.level,
            feats.desc, feats.valid, scene[9], w, h))
        _, t_step = timed(lambda: graft.tracking_step(frame, *scene[1:]))
        ext.append(t_ext)
        loc.append(t_loc)
        step.append(t_step)
    med = statistics.median
    print(f"[stages] step {med(step):.3f} ms = extract {med(ext):.3f} ms + "
          f"track_local_map {med(loc):.3f} ms (median of {args.frames}; "
          f"{card})")

    from torch.profiler import ProfilerActivity, profile
    n_prof = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames[:n_prof]:
            graft.tracking_step(frame, *scene[1:])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"[profile] {n_prof} steps: wall {wall_us / n_prof / 1e3:.3f} ms/step, "
          f"device busy {busy_us / n_prof / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle), "
          f"{launches / n_prof:.0f} kernel launches/step ({card})")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print(f"[profile] {e.self_device_time_total / n_prof:9.1f} us/step "
              f"x{e.count // n_prof:4d}  {e.key[:90]}")
    # The port's own kernels by name, wherever they rank.
    for label, name in (("K1", "brief_kernel"), ("K2", "match_kernel"),
                        ("K3", "pose_opt_kernel")):
        mine = [e for e in events if name in e.key]
        us = sum(e.self_device_time_total for e in mine) / n_prof
        count = sum(e.count for e in mine) / n_prof
        print(f"[kernel] {label} {name}: {us:.1f} us/step device time, "
              f"{count:.0f} launches/step ({card})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(f"{card}\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
