#!/usr/bin/env python3
"""The port's inertial system and the JAX package's, each run freely on
the CPU over the same committed frames, side by side.

    JAX_PLATFORMS=cpu python scripts/vi_compare_cpu.py mono
    JAX_PLATFORMS=cpu python scripts/vi_compare_cpu.py stereo
    JAX_PLATFORMS=cpu python scripts/vi_compare_cpu.py tumvi

``mono`` is cell (e): ``MonoInertialSlam`` at
``graft.mono_inertial_golden_config()`` on ``graft.vi_mono_frames()``;
``stereo`` is cell (d): ``StereoInertialSlam`` at
``graft.stereo_inertial_golden_config()`` on ``graft.vi_stereo_frames()``
(the JAX systems as ``scripts/vi_reference_jax.py`` configures them);
``tumvi`` is cell (h) cut to the CPU's slots:
``FisheyeStereoInertialSlam`` at ``graft.tumvi_vi_golden_config()`` with
``graft.TUMVI_VI_CPU_SLOTS`` / ``TUMVI_VI_CPU_VIBA`` on
``graft.tumvi_vi_frames()`` (as ``scripts/fisheye_reference_jax.py vi``).
Unlike the frame-by-frame parity tests, neither run is reset to the
other's state, so drift shows. Prints one JSON line: each package's
``graft.vi_gates`` measures (the ATE, for mono the Horn scale after 3 s),
and where the two runs first part: the first frame whose status, keyframe
count or live landmark count differ, and the first whose camera centres
lie more than 1 mm apart (with that distance and the frame's stamp).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PART_M = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("stereo", "mono", "tumvi"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    import torch

    from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
    from orbslam3_byzyh_tpu.pipeline import system as jsys
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
        StereoInertialSlam as JStereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import StereoConfig

    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.pipeline.inertial_system import \
        MonoInertialSlam
    from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
        StereoInertialSlam

    torch.set_num_threads(4)
    if args.kind == "tumvi":
        js, ts, g, images = _tumvi(graft)
        return _compare(args.kind, js, ts, g, images, graft)
    stereo = args.kind == "stereo"
    g = graft.vi_stereo_frames() if stereo else graft.vi_mono_frames()
    s = (graft.stereo_inertial_golden_config() if stereo
         else graft.mono_inertial_golden_config())
    fields = {k: getattr(s.config, k) for k in (
        "fx", "fy", "cx", "cy", "width", "height", "fps", "kf_ref_min_obs",
        "max_kf", "max_lm", "max_obs", "n_features", "min_init_matches")}
    common = dict(fields, use_loop_closing=False, background_gba=False,
                  device_mesh=False)
    imu = jvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32))
    if stereo:
        js = JStereoInertialSlam(StereoConfig(
            **common, bf=s.config.bf, th_depth=s.config.th_depth), imu,
            **s.viba)
        ts = StereoInertialSlam(s.config, s.imu, **s.viba, device="cpu")
        images = list(zip(g.left, g.right))
    else:
        js = jvi.MonoInertialSlam(jsys.SlamConfig(**common), imu, **s.viba)
        ts = MonoInertialSlam(s.config, s.imu, **s.viba, device="cpu")
        images = [(f,) for f in g.left]
    return _compare(args.kind, js, ts, g, images, graft)


def _tumvi(graft):
    """Cell (h) at the CPU's slots in both packages."""
    import dataclasses

    from orbslam3_byzyh_tpu.pipeline import inertial_system as jvi
    from orbslam3_byzyh_tpu.pipeline.stereo_inertial import \
        FisheyeStereoInertialSlam as JFisheyeStereoInertialSlam
    from orbslam3_byzyh_tpu.pipeline.stereo_system import \
        FisheyeStereoConfig as JFisheyeStereoConfig

    from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
        FisheyeStereoInertialSlam

    g = graft.tumvi_vi_frames()
    s = graft.tumvi_vi_golden_config(**graft.TUMVI_VI_CPU_SLOTS)
    jcfg = JFisheyeStereoConfig(**dict(
        dataclasses.asdict(s.config), use_loop_closing=False,
        background_gba=False, device_mesh=False))
    js = JFisheyeStereoInertialSlam(
        jcfg, jvi.ImuConfig(**dataclasses.asdict(s.imu)),
        **graft.TUMVI_VI_CPU_VIBA)
    ts = FisheyeStereoInertialSlam(s.config, s.imu,
                                   **graft.TUMVI_VI_CPU_VIBA, device="cpu")
    return js, ts, g, list(zip(g.left, g.right))


def _compare(kind, js, ts, g, images, graft):
    part_state, part_pose, per_frame = None, None, []
    t_start = time.perf_counter()
    for i, (imgs, stamp) in enumerate(zip(images, g.stamps)):
        pj = js.track(*imgs, float(stamp), g.imu(i))
        pt = ts.track(*imgs, float(stamp), g.imu(i))
        sj = (js.status, js.n_kf, int(np.asarray(js.state.lms.valid).sum()))
        st = (ts.status, ts.n_kf, int(ts.state.lms.valid.sum()))
        gap = None
        if pj is not None and pt is not None:
            cj = -np.asarray(pj[0], np.float64).T @ np.asarray(pj[1])
            ct = -np.asarray(pt[0], np.float64).T @ np.asarray(pt[1])
            gap = float(np.linalg.norm(cj - ct))
        per_frame.append({"frame": i, "jax": sj, "port": st, "gap_m": gap})
        if part_state is None and sj != st:
            part_state = {"frame": i, "stamp": float(stamp), "jax": sj,
                          "port": st}
        if part_pose is None and gap is not None and gap > PART_M:
            part_pose = {"frame": i, "stamp": float(stamp), "gap_m": gap}
    out = {"kind": kind, "seconds": time.perf_counter() - t_start,
           "first_state_part": part_state, "first_pose_part": part_pose}
    for name, slam, v in (("jax", js, lambda: np.asarray(js._body[2])),
                          ("port", ts, lambda: ts._body[2].numpy())):
        out[name] = graft.vi_gates("mono" if kind == "mono" else "stereo",
                                   slam.trajectory, slam.t0, g, v())
        out[name].update(imu_ready=bool(slam.imu_ready),
                         viba_stage=int(slam.viba_stage))
    out["per_frame"] = per_frame
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
