#!/usr/bin/env python3
"""The JAX package's ``MonoSlam`` on the atlas-merge cells: the reference
results the PyTorch port's runs are held to.

    JAX_PLATFORMS=cpu python scripts/merge_reference_jax.py l
    JAX_PLATFORMS=cpu python scripts/merge_reference_jax.py m
    JAX_PLATFORMS=cpu python scripts/merge_reference_jax.py s
    JAX_PLATFORMS=cpu python scripts/merge_reference_jax.py l --vocabulary PATH

Runs ``orbslam3_byzyh_tpu``'s ``MonoSlam`` with a vocabulary (default
``vocabulary/synthetic_voc_10k.npz``) at ``graft.merge_golden_config()``
(loop closing on, cross-map relocalisation off, a RECENTLY_LOST budget of 2
frames; the background GBA off: the JAX system runs it inline) with the map
cut to ``graft.MERGE_CPU_SLOTS``, on the port's ``graft.merge_sequence()``.
Cell ``l`` plays the whole sequence into one system: map A, a blackout that
starts map B, the revisit on which the merge branch welds A into B. Cell
``m`` plays the first ``graft.MERGE_TRACKED`` frames, saves the atlas with
``save_atlas_checkpoint``, loads it into a fresh system with
``load_atlas_checkpoint`` and plays the revisit frames. Prints one JSON
line: each frame's status, active map, map count and keyframe count; each
merge (the frame, the keyframe, the other map, the candidate, the Sim3's
scale, each map's keyframe count before the weld); the merged
trajectory's ATE against the golden truth (Horn with scale). Frames and
merges are numbered by their index in the sequence. For ``m`` the
checkpoint's bytes and the save and load seconds. Cell ``s`` is the CPU
tests' small live cell: ``graft.MERGE_SMALL_TIMES`` of ``SynthWorld(seed=3)``
at 320x240 (``tests/synth_world.py``) at ``graft.merge_small_config()``,
played as ``l`` is.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time


ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def small_sequence(graft) -> list:
    """Cell ``s``'s frames as ``graft.RelocFrame`` s (world -1 for noise;
    ``world`` otherwise the render time in tenths of a second)."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth_world import SynthWorld
    cfg = graft.merge_small_config()
    world = SynthWorld(seed=3, w=cfg.width, h=cfg.height, fx=cfg.fx,
                       fy=cfg.fy)
    rng = np.random.default_rng(graft.RELOC_NOISE_SEED)
    out = []
    for i, t in enumerate(graft.MERGE_SMALL_TIMES):
        img = (rng.uniform(0, 30, (cfg.height, cfg.width)).astype(np.float32)
               if t is None else world.render(t))
        out.append(graft.RelocFrame(img, round(0.1 * i, 6),
                                    -1 if t is None else round(10 * t)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=("l", "m", "s"))
    ap.add_argument("--vocabulary", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.ops import bow
    from orbslam3_byzyh_tpu.pipeline import system as jsys

    from orbslam3_byzyh_tpu_torch import graft

    voc_path = args.vocabulary or str(graft.RELOC_VOCABULARY)
    if args.cell == "s":
        fields = dataclasses.asdict(graft.merge_small_config())
        seq = small_sequence(graft)
    else:
        fields = dataclasses.asdict(graft.merge_golden_config())
        fields.update(**graft.MERGE_CPU_SLOTS)
        seq = graft.merge_sequence()
    fields.update(vocabulary=bow.load_vocabulary(voc_path),
                  background_gba=False, device_mesh=False)
    cfg = jsys.SlamConfig(**fields)
    records, merges, at = [], [], [0]

    def spied(slam):
        inner = slam._merge_maps

        def spy(kf_id, other_idx, cand, corr):
            before = [int(m.n_kf) for m in slam.atlas.meta]
            inner(kf_id, other_idx, cand, corr)
            merges.append(dict(
                frame=at[0], kf_id=int(kf_id), other=int(other_idx),
                cand=int(cand), scale=float(corr[2]),
                n_inliers=int(corr[3]), n_kf_maps=before,
                n_kf_after=int(slam.n_kf)))

        slam._merge_maps = spy
        return slam

    def play(slam, lo, hi):
        for i in range(lo, hi):
            f = seq[i]
            at[0] = i
            was = slam.status
            slam.track(f.image, f.stamp)
            records.append(dict(
                index=i, stamp=f.stamp, world=f.world, before=int(was),
                status=int(slam.status), map=int(slam.atlas.current),
                n_maps=len(slam.atlas.maps), n_kf=int(slam.n_kf)))

    t_start = time.perf_counter()
    out = dict(cell=args.cell, vocabulary=os.path.basename(voc_path),
               slots=dict(max_kf=cfg.max_kf, max_lm=cfg.max_lm))
    slam = spied(jsys.MonoSlam(cfg))
    if args.cell != "m":
        play(slam, 0, len(seq))
    else:
        play(slam, 0, graft.MERGE_TRACKED)
        out["n_kf_saved"] = int(slam.n_kf)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "atlas")
            t0 = time.perf_counter()
            slam.save_atlas_checkpoint(path)
            out["save_s"] = time.perf_counter() - t0
            out["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                               for f in os.listdir(path))
            slam = spied(jsys.MonoSlam(cfg))
            t0 = time.perf_counter()
            slam.load_atlas_checkpoint(path)
            out["load_s"] = time.perf_counter() - t0
        play(slam, graft.MERGE_TRACKED + graft.MERGE_NOISE, len(seq))
    traj = slam.trajectory
    ate, n_assoc = (graft.merge_ate(traj, slam.t0, seq) if args.cell != "s"
                    else (None, 0))
    out.update(frames=records, merges=merges,
               merge_index=merges[0]["frame"] if merges else None,
               n_maps=len(slam.atlas.maps), n_kf=int(slam.n_kf),
               traj_frames=len(traj), ate_m=ate, n_assoc=n_assoc,
               seconds=time.perf_counter() - t_start)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
