#!/usr/bin/env python3
"""The JAX package's ``MonoSlam`` on the relocalisation cells: the reference
results the PyTorch port's runs are held to.

    JAX_PLATFORMS=cpu python scripts/reloc_reference_jax.py i
    JAX_PLATFORMS=cpu python scripts/reloc_reference_jax.py j
    JAX_PLATFORMS=cpu python scripts/reloc_reference_jax.py i --vocabulary PATH

Runs ``orbslam3_byzyh_tpu``'s ``MonoSlam`` with a vocabulary (default
``vocabulary/synthetic_voc_10k.npz``, the runners' default) on the port's
``graft.reloc_sequence(cell)``: the golden frames 0-24 padded to 752x480,
a blackout of noise frames, the revisit frames and two more, at
``graft.reloc_golden_config(cell)`` (loop closing and the background GBA
off) with the map cut to ``graft.RELOC_CPU_SLOTS``. Prints one JSON line:
each frame's status, active map, map count, keyframe count and pose; each
relocalisation attempt (the map it searched, the candidate that passed,
its inliers); the frame that relocalised (its golden frame, its index in
the sequence, the map it landed in, its pose) and ``graft.reloc_gates``'s
measures of that pose.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=("i", "j"))
    ap.add_argument("--vocabulary", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.ops import bow
    from orbslam3_byzyh_tpu.pipeline import system as jsys

    from orbslam3_byzyh_tpu_torch import graft

    voc_path = args.vocabulary or str(graft.RELOC_VOCABULARY)
    fields = dataclasses.asdict(graft.reloc_golden_config(args.cell))
    fields.update(vocabulary=bow.load_vocabulary(voc_path),
                  background_gba=False, device_mesh=False,
                  **graft.RELOC_CPU_SLOTS)
    slam = jsys.MonoSlam(jsys.SlamConfig(**fields))
    attempts = []
    inner = slam._relocalize_in_map

    def spy(feats, map_idx):
        hit = inner(feats, map_idx)
        attempts.append(dict(
            frame=len(records), map=int(map_idx),
            cand=None if hit is None else hit[1],
            n_inliers=None if hit is None else int(hit[0].n_inliers)))
        return hit

    slam._relocalize_in_map = spy
    seq = graft.reloc_sequence(args.cell)
    records = []
    t_start = time.perf_counter()
    for f in seq:
        was = slam.status
        pose = slam.track(f.image, f.stamp)
        records.append(dict(
            stamp=f.stamp, world=f.world, before=int(was),
            status=int(slam.status), map=int(slam.atlas.current),
            n_maps=len(slam.atlas.maps), n_kf=int(slam.n_kf),
            pose=None if pose is None else [np.asarray(pose[0]).tolist(),
                                            np.asarray(pose[1]).tolist()]))
    revisit = graft.RELOC_TRACKED + graft.RELOC_CELLS[args.cell]["noise"]
    hit = next((i for i in range(revisit, len(seq))
                if records[i]["status"] == jsys.OK
                and records[i]["before"] != jsys.OK), None)
    out = dict(cell=args.cell, vocabulary=os.path.basename(voc_path),
               slots=graft.RELOC_CPU_SLOTS, frames=records,
               attempts=attempts, reloc_index=hit,
               seconds=time.perf_counter() - t_start)
    if hit is not None:
        r = records[hit]
        out.update(reloc_world=r["world"], reloc_map=r["map"],
                   reloc_pose=r["pose"],
                   **graft.reloc_gates(slam.trajectory, slam.t0, seq,
                                       r["stamp"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
