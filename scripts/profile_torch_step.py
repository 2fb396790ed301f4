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
re-run on the inputs the step gave them. ``--entry init``:
``graft.mono_initialize`` from the empty EuRoC-mono map (1024 keyframe and
65536 landmark slots) against ``graft.euroc_mono_two_view``'s general case,
every call with the same sample indices; its stages are timed inside the
call, each function synchronised before and after it: the matching, the
RANSAC, the decompositions and ``check_rt``, the map writes and
``local_ba``, split into the problem's build, the Schur assembly, the solve,
the back-substitution and the retraction. It then runs one ``schur_pieces``
call in each form (one-hot and scatter) on the full-map problem at K = 1024,
L = 65536, O = 12, and the scatter form on a problem with every slot live,
with each call's time, peak memory and largest difference. ``--entry
system``: ``MonoSlam.track`` over the golden frames at the EuRoC-mono
capacity (``graft.euroc_golden_config()``, the frames padded to 752x480),
one warm-up sequence, then per frame kind (uninitialised, init, tracked,
keyframe) the mean host-clock time of ``track`` and of its stages, each
stage function synchronised before and after it (extraction, the frame
step, the fallback, the init, the keyframe bundle, the previous bundle's
read, the rest of ``track``), over ``--sequences`` sequences; then one
sequence under the profiler (device busy share, launches per frame, K1-K3
by name; the table goes to ``--out``, no trace). ``--entry stereo``: the
same for ``StereoSlam`` at the KITTI stereo capacity on the stereo frames
(``graft.kitti_golden_config()``, ``graft.kitti_frames``) and for
``RgbdSlam`` at TUM1's settings (``graft.tum_rgbd_golden_config()``), with
the stereo extraction and the depth landmarks as stages. ``--entry
vi-system``: the same for ``StereoInertialSlam`` at the EuRoC
stereo-inertial capacity on the stereo VI frames
(``graft.euroc_vi_golden_config()``), each frame with its IMU batch, by
the kinds of ``chip_smoke.py`` phase 13 (uninitialised, init, visual,
inertial, keyframe, the keyframe that runs the IMU init or VIBA1), with the
inertial frame step, the preintegrations, the local BA, the IMU init's
refit and full VI-BA and the cull's read as stages. ``--entry vi``:
``graft.vi_frame_step`` at the EuRoC stereo-inertial configuration on
``graft.euroc_vi_scene`` (its "keyframe" and "prior" cases), split by stage,
each stage function synchronised before and after it: the prior's square
root (the prior case), the stereo extraction, the frame window's
preintegration, the IMU prediction, the motion model, the local map, the
pose-inertial optimization, and the epilogue (the rest of the step, its read
included); then a few steps under the profiler (device busy and idle share,
device operations per step, K1-K3s by name), and the keyframe step
(``graft.vi_keyframe_step`` on ``graft.euroc_vi_map``) the same way, split
into the window's build, the VI-BA and the write-back. ``both`` runs
tracking and mono, ``all`` (the default) tracking, mono and keyframe in
turn. For each it reports, with the card's name and power limit:
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
    ap.add_argument("--entry", choices=("tracking", "mono", "keyframe", "init",
                                        "system", "stereo", "vi",
                                        "vi-system", "both", "all"),
                    default="all")
    ap.add_argument("--sequences", type=int, default=2)
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

    def report(label, frames, step, stages, warmup=100):
        """Warm up, time the stages and the step, then profile 5 steps.
        ``stages`` maps a stage name to fn(frame) -> time in ms."""
        # Steps right after start-up run slower than the steady state.
        for i in range(warmup):
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
        n_prof = min(5, len(frames))
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
        for kname, name in KERNEL_NAMES:
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
        prof.export_chrome_trace(os.path.join(out, "trace.json.gz"))

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

    if args.entry == "init":
        profile_init(args, dev, card, timed, report)
    if args.entry == "system":
        profile_system(args, dev, card, timed)
    if args.entry == "stereo":
        for cell in ("kitti", "rgbd"):
            profile_system(args, dev, card, timed, cell)
    if args.entry == "vi":
        profile_vi(args, dev, card)
    if args.entry == "vi-system":
        profile_system(args, dev, card, timed, "euroc_vi")
    return 0


def _device_share(label, card, n, step):
    """``n`` calls of ``step`` under the profiler: the device's busy and
    idle share of the wall time, device operations per call, the top items
    and K1-K3s by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = sum(e.count for e in events)
    print(f"[{label} profile] {n} calls: wall {wall_us / n / 1e3:.3f} ms, "
          f"device busy {busy_us / n / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle), {ops / n:.0f} device "
          f"operations a call ({card})")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        print(f"[{label} profile] {e.self_device_time_total / n:9.1f} us x"
              f"{e.count // n:5d}  {e.key[:90]}")
    for kname, name in KERNEL_NAMES:
        mine = [e for e in events if name in e.key]
        print(f"[{label} kernel] {kname}: "
              f"{sum(e.self_device_time_total for e in mine) / n:.1f} us, "
              f"{sum(e.count for e in mine) / n:.0f} launches a call")


def profile_vi(args, dev, card) -> None:
    """``--entry vi``: the stereo-inertial frame and keyframe steps by
    stage."""
    import contextlib

    import torch
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import imu
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as vi
    from orbslam3_byzyh_tpu_torch.pipeline import tracking
    from orbslam3_byzyh_tpu_torch.solver import inertial, inertial_ba

    cfg = graft.EUROC_STEREO_INERTIAL
    ctx = graft.vi_context(cfg, dev)
    left, right = (torch.from_numpy(a).to(dev)
                   for a in graft.euroc_vi_pair(cfg))
    f, _, m = graft.stereo_extract(left, right, ctx.cam_params, None,
                                   cfg.rig)
    feats = [convert.to_numpy(a) for a in (f.xy, f.level, f.desc, f.angle,
                                           f.valid)]

    @contextlib.contextmanager
    def staged(targets, acc):
        """Time each (module, name) call, synchronised around it."""
        saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

        def wrap(label, fn):
            def timed_fn(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                acc[label] = acc.get(label, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                return out
            return timed_fn
        for mod, name, fn in saved:
            setattr(mod, name, wrap(name, fn))
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    frame_stages = ((inertial, "prior_sqrt"), (graft, "stereo_extract"),
                    (vi, "preintegrate"), (imu, "predict_state"),
                    (tracking, "track_motion_model"),
                    (tracking, "track_local_map_windowed"),
                    (inertial, "pose_inertial_optimization"))
    for case in ("keyframe", "prior"):
        a = graft.vi_frame_args(graft.euroc_vi_scene(
            *feats, convert.to_numpy(m.depth), case=case, cfg=cfg), dev)

        def step():
            return graft.vi_frame_step(a, ctx, cfg)

        for _ in range(10):
            step()
        totals, sums = [], {}
        for _ in range(args.frames):
            acc = {}
            with staged(frame_stages, acc):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            acc["epilogue"] = total - sum(acc.values())
            totals.append(total)
            for k, v in acc.items():
                sums.setdefault(k, []).append(v)
        med = {k: statistics.median(v) for k, v in sums.items()}
        print(f"[vi {case} stages] step {statistics.median(totals):.3f} ms "
              f"= " + " + ".join(f"{k} {v:.3f}" for k, v in med.items())
              + f" ms (medians of {args.frames}, each stage synchronised; "
              f"{card})")
        _device_share(f"vi {case}", card, 5, step)

    mp = graft.euroc_vi_map(cfg)
    imap = graft.vi_map_args(mp, dev)

    def kf_step():
        return graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)

    for _ in range(5):
        kf_step()
    kf_stages = ((vi, "build_viba"), (inertial_ba, "vi_bundle_adjust"),
                 (vi, "apply_viba"))
    totals, sums = [], {}
    for _ in range(args.frames):
        acc = {}
        with staged(kf_stages, acc):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kf_step()
            torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        for k, v in acc.items():
            sums.setdefault(k, []).append(v)
    med = {k: statistics.median(v) for k, v in sums.items()}
    print(f"[vi keyframe stages] step {statistics.median(totals):.3f} ms = "
          + " + ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f" ms (medians of {args.frames}; {card})")
    _device_share("vi keyframe", card, 5, kf_step)


# The port's kernels as the profiler names them: K3 and K3s are the two
# instantiations of one template.
KERNEL_NAMES = (("K1", "brief_kernel"), ("K2", "match_kernel"),
                ("K3", "pose_opt_kernel<false>"),
                ("K3s", "pose_opt_kernel<true>"))


def profile_system(args, dev, card, timed, cell: str = "mono") -> None:
    """A system's frames by kind: stage times and a profile. ``cell``:
    "mono" (MonoSlam at EuRoC capacity), "kitti" (StereoSlam at KITTI
    capacity), "rgbd" (RgbdSlam at TUM1's settings) or "euroc_vi"
    (StereoInertialSlam at the EuRoC stereo-inertial capacity)."""
    import torch

    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as vi
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_system, system
    from orbslam3_byzyh_tpu_torch.pipeline import tracking

    stages = [("extract", graft, "mono_extract"),
              ("frame step", tracking, "frame_step"),
              ("fallback", tracking, "track_reference_keyframe"),
              ("init", graft, "mono_initialize"),
              ("keyframe bundle", graft, "mono_keyframe_step"),
              ("bundle read", system.MonoSlam, "_drain_pending")]
    imus = None
    make = None
    if cell == "mono":
        gold = graft.golden_frames()
        stamps, frames = gold.stamps, graft.pad_frames(gold.frames)
        cls, cfg = system.MonoSlam, graft.euroc_golden_config()
    elif cell == "euroc_vi":
        vs = graft.vi_stereo_frames()
        stamps = vs.stamps
        imus = [vs.imu(i) for i in range(len(stamps))]
        frames = list(zip(graft.pad_frames(vs.left),
                          graft.pad_frames(vs.right)))
        setup = graft.euroc_vi_golden_config()
        cls = stereo_inertial.StereoInertialSlam
        make = lambda: cls(setup.config, setup.imu, **setup.viba,
                           device=dev)
        stages = [("stereo extract", graft, "stereo_extract"),
                  ("visual frame step", tracking, "frame_step"),
                  ("inertial frame step", vi, "track_inertial"),
                  ("init", stereo_system.StereoSlam, "_stereo_initialize"),
                  ("keyframe preintegration", vi.MonoInertialSlam,
                   "_preintegrate"),
                  ("keyframe bundle", graft, "mono_keyframe_step"),
                  ("local BA", vi.MonoInertialSlam, "_local_refine"),
                  ("imu init refit", vi.MonoInertialSlam, "_inertial_refit"),
                  ("full VI-BA", vi.MonoInertialSlam, "_full_inertial_ba"),
                  ("cull read", vi.MonoInertialSlam, "_apply_pending_cull"),
                  ("bundle read", system.MonoSlam, "_drain_pending")]
    else:
        sf = graft.stereo_frames()
        stamps = sf.stamps
        if cell == "kitti":
            cls, cfg = stereo_system.StereoSlam, graft.kitti_golden_config()
            frames = list(zip(graft.kitti_frames(sf.left),
                              graft.kitti_frames(sf.right)))
            stages[0] = ("stereo extract", graft, "stereo_extract")
        else:
            cls, cfg = stereo_system.RgbdSlam, graft.tum_rgbd_golden_config()
            frames = list(zip(sf.left, sf.depth))
        stages[3] = ("init", stereo_system.StereoSlam, "_stereo_initialize")
    spent = {}

    def wrap(label, fn):
        def timed_fn(*a, **kw):
            out, ms_ = timed(lambda: fn(*a, **kw))
            spent[label] = spent.get(label, 0.0) + ms_
            return out
        return timed_fn

    def sequence(staged):
        """One sequence: per frame (kind, track ms, stage ms)."""
        slam = make() if make is not None else cls(cfg, device=dev)
        originals = [(o, n, getattr(o, n)) for _, o, n in stages]
        if staged:
            for (label, _, _), (o, n, fn) in zip(stages, originals):
                setattr(o, n, wrap(label, fn))
        bundles = []
        step = graft.mono_keyframe_step
        graft.mono_keyframe_step = lambda *a, **kw: (bundles.append(1),
                                                     step(*a, **kw))[1]
        out = []
        try:
            for i, (img, stamp) in enumerate(zip(frames, stamps)):
                uninit = slam.status == system.NOT_INITIALIZED
                n_b = len(bundles)
                ready = getattr(slam, "imu_ready", False)
                stage = getattr(slam, "viba_stage", 0)
                spent.clear()
                args_ = ((img if isinstance(img, tuple) else (img,))
                         + (float(stamp),)
                         + (() if imus is None else (imus[i],)))
                _, total = timed(lambda: slam.track(*args_))
                if uninit:
                    kind = ("uninitialised"
                            if slam.status == system.NOT_INITIALIZED
                            else "init")
                elif imus is not None:
                    kind = ("imu_keyframe" if len(bundles) > n_b
                            and slam.viba_stage != stage
                            else "keyframe" if len(bundles) > n_b
                            else "inertial" if ready else "visual")
                else:
                    kind = "keyframe" if len(bundles) > n_b else "tracked"
                out.append((kind, total, dict(spent)))
            slam.trajectory
        finally:
            graft.mono_keyframe_step = step
            for o, n, fn in originals:
                setattr(o, n, fn)
        return out

    sequence(False)
    rows = []
    for _ in range(args.sequences):
        rows += sequence(True)
    for kind in ("uninitialised", "init", "tracked", "visual", "inertial",
                 "keyframe", "imu_keyframe"):
        rs = [r for r in rows if r[0] == kind]
        if not rs:
            continue
        mean = statistics.fmean(r[1] for r in rs)
        parts = {label: statistics.fmean(r[2].get(label, 0.0) for r in rs)
                 for label, _, _ in stages}
        parts = {k: v for k, v in parts.items() if v > 0}
        rest = mean - sum(parts.values())
        text = " + ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        print(f"[{cell} system stages] {kind} ({len(rs)} frames): track() "
              f"{mean:.3f} ms = {text} + rest {rest:.3f} ms (means, each "
              f"stage synchronised; median track() "
              f"{statistics.median(r[1] for r in rs):.3f} ms; {card})")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kinds = [r[0] for r in sequence(False)]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    n = len(kinds)
    print(f"[{cell} system profile] one sequence of {n} frames ("
          f"{', '.join(f'{k} {kinds.count(k)}' for k in sorted(set(kinds)))}"
          f"): wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} "
          f"ms ({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle), "
          f"{launches / n:.0f} device operations/frame ({card})")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print(f"[{cell} system profile] {e.self_device_time_total / n:9.1f} "
              f"us/frame x{e.count:6d}  {e.key[:90]}")
    for kname, name in KERNEL_NAMES:
        mine = [e for e in events if name in e.key]
        us = sum(e.self_device_time_total for e in mine)
        count = sum(e.count for e in mine)
        print(f"[{cell} system kernel] {kname} {name}: {us / n:.1f} us/frame "
              f"device time, {count} launches in the sequence ({card})")
    if imus is not None:
        from orbslam3_byzyh_tpu_torch.utils import cuda_graph
        print(f"[{cell} system profile] {len(cuda_graph._GRAPHS)} CUDA graphs "
              f"kept, {cuda_graph.CAPTURES[0]} captured in the process")
    out = os.path.join(args.out, "system" if cell == "mono" else cell)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "key_averages.txt"), "w") as fh:
        fh.write(f"{card}\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=60))


def profile_init(args, dev, card, timed, report) -> None:
    """The init step's stages inside the call, its profile, and the two
    Schur assemblies at full capacity."""
    import torch

    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.models import map_state as ms
    from orbslam3_byzyh_tpu_torch.ops import fast_orb, geometry
    from orbslam3_byzyh_tpu_torch.pipeline import mapping, tracking
    from orbslam3_byzyh_tpu_torch.solver import ba, lm

    cfg = graft.EUROC_MONO
    cam = convert.to_torch([cfg.fx, cfg.fy, cfg.cx, cfg.cy], dev)
    img = convert.to_torch(graft.example_image(cfg.height, cfg.width), dev)
    f = graft.mono_extract(img, cam, convert.to_torch(list(cfg.dist), dev),
                           cfg)
    scene = graft.euroc_mono_two_view(f, cfg, "general")
    ref = fast_orb.FrameFeatures(*convert.tree_to_torch(scene.ref, dev))
    cur = fast_orb.FrameFeatures(*convert.tree_to_torch(scene.cur, dev))
    empty = ms.empty_map(cfg.max_kf, cfg.max_lm, cfg.max_obs, cfg.n_features,
                         device=dev)
    first = graft.mono_initialize(empty, ref, cur, 0.0, 0.05, cam,
                                  generator=torch.Generator(dev).manual_seed(0),
                                  cfg=cfg)
    idx = first.info["idx"]

    def step(_):
        return graft.mono_initialize(empty, ref, cur, 0.0, 0.05, cam,
                                     idx=idx, cfg=cfg).R.cpu()

    # Stages inside the call: each function synchronised before and after.
    stages = [
        ("matching", tracking, "match_for_initialization"),
        ("ransac", geometry, "ransac_two_models"),
        ("decompose", geometry, "decompose_homography"),
        ("decompose", geometry, "decompose_fundamental"),
        ("check_rt", geometry, "check_rt"),
        ("map writes", ms, "add_keyframe"),
        ("map writes", ms, "add_landmarks"),
        ("local_ba", mapping, "local_ba"),
        ("ba build", mapping, "_full_ba_problem"),
        ("ba build", ba, "_build_system"),
        ("ba assembly", ba, "schur_pieces_scatter"),
        ("ba solve", ba, "schur_solve"),
        ("ba back-substitution", ba, "back_substitute"),
        ("ba retraction", ba, "_retract"),
    ]
    spent = {}

    def wrap(label, fn):
        def timed_fn(*a, **kw):
            out, ms_ = timed(lambda: fn(*a, **kw))
            spent[label] = spent.get(label, 0.0) + ms_
            return out
        return timed_fn

    originals = [(mod, name, getattr(mod, name)) for _, mod, name in stages]
    per_call = []
    for _ in range(args.frames):
        for (label, _, _), (mod, name, fn) in zip(stages, originals):
            setattr(mod, name, wrap(label, fn))
        try:
            spent.clear()
            _, total = timed(lambda: step(None))
        finally:
            for mod, name, fn in originals:
                setattr(mod, name, fn)
        per_call.append(dict(spent, call=total))
    med = {k: statistics.median(c[k] for c in per_call) for k in per_call[0]}
    print(f"[init stages] mono_initialize {med.pop('call'):.3f} ms with each "
          f"stage synchronised: " + ", ".join(f"{k} {v:.3f} ms"
                                              for k, v in med.items())
          + f" (median of {args.frames}; {card})")

    report("init", [None] * args.frames, step, {}, warmup=3)

    # One Schur assembly in each form on the full-map problem the init's BA
    # solves, then the scatter form with every slot live.
    pre = {}
    local_ba = mapping.local_ba

    def grab(state, *a, **kw):
        pre["state"] = state
        return local_ba(state, *a, **kw)

    mapping.local_ba = grab
    try:
        step(None)
    finally:
        mapping.local_ba = local_ba
    free = torch.arange(pre["state"].kfs.valid.shape[0], device=dev) == 1
    prob = mapping._full_ba_problem(pre["state"], free, cam)
    L, O = prob.obs_kf.shape
    K = prob.R.shape[0]
    lam = torch.full((), 1e-4, device=dev)

    def system(p):
        return ba._build_system(p, p.R, p.t, p.points,
                                torch.ones_like(p.obs_valid), 0, True,
                                lm.CHI2_MONO)

    def one(form, p, sys_):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, ms_ = timed(lambda: form(p.obs_kf, sys_, lam, K))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return out, ms_, peak

    sys_ = system(prob)
    scat, s_ms, s_gb = one(ba.schur_pieces_scatter, prob, sys_)
    scat, s_ms, s_gb = one(ba.schur_pieces_scatter, prob, sys_)  # warm
    # The one-hot form's largest tensors: E (L, O, K), U and V (L, K, 6, 3)
    # and the cross einsum's permuted copies of U and V.
    need = 4 * (L * O * K + 4 * L * K * 18)
    free_b, total_b = torch.cuda.mem_get_info()
    print(f"[init schur] K={K} L={L} O={O}, {int(prob.lm_valid.sum())} live "
          f"landmarks: scatter {s_ms:.3f} ms, peak {s_gb:.3f} GiB above the "
          f"inputs ({card})")
    if need < free_b:
        hot, h_ms, h_gb = one(ba.schur_pieces, prob, sys_)
        diff = {k: float((hot[k].float() - scat[k].float()).abs().max()
                         / hot[k].float().abs().max().clamp_min(1e-30))
                for k in ("Hpp", "bp", "cross", "corr", "Hll_inv")}
        print(f"[init schur] one-hot {h_ms:.3f} ms, peak {h_gb:.3f} GiB above "
              f"the inputs; largest difference relative to the one-hot "
              f"piece's largest entry {diff} ({card})")
        del hot
    else:
        print(f"[init schur] one-hot skipped: its largest tensors need "
              f"{need / 2 ** 30:.1f} GiB, {free_b / 2 ** 30:.1f} of "
              f"{total_b / 2 ** 30:.1f} GiB free ({card})")
    # Every slot live: each landmark seen by O distinct random keyframes.
    g = torch.Generator(dev).manual_seed(0)
    kf = torch.argsort(torch.rand((L, K), generator=g, device=dev), 1)[:, :O]
    dense = prob._replace(
        obs_kf=kf.to(torch.int32), obs_valid=torch.ones_like(prob.obs_valid),
        lm_valid=torch.ones_like(prob.lm_valid),
        points=torch.randn((L, 3), generator=g, device=dev) * 0.3
        + torch.tensor([0.0, 0.0, 1.0], device=dev),
        obs_uv=torch.rand((L, O, 2), generator=g, device=dev) * 400)
    sys_d = system(dense)
    one(ba.schur_pieces_scatter, dense, sys_d)
    _, d_ms, d_gb = one(ba.schur_pieces_scatter, dense, sys_d)
    print(f"[init schur] scatter with every slot live ({L * O} observations, "
          f"{L * O * O} pairs): {d_ms:.3f} ms, peak {d_gb:.3f} GiB above the "
          f"inputs ({card})")


if __name__ == "__main__":
    sys.exit(main())
