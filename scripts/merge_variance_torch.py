#!/usr/bin/env python3
"""The spread of the merge cells between identical runs on the card.

    python scripts/merge_variance_torch.py [RUNS] [--no-guard]

Plays the port's merge cells (``graft.merge_sequence`` at
``graft.merge_golden_config`` with the runners' 10k-word vocabulary:
``chip_smoke.py`` phase 17's (l) and (m), alternately) RUNS times (8 by
default) through fresh ``MonoSlam`` systems on the card, and prints one
JSON line a run: at the weld, the Horn scale of each map's live keyframe
centres against the golden truth (``scale_B_before``,
``scale_A_before``; their ratio is the true weld scale; A's is for (l)
only, whose stamps are the sequence's), the weld (frame, keyframe,
candidate, the Sim3's scale), the loops closed after it, the merged
trajectory's ATE (``graft.merge_ate``), the frames over 1 s and every
frame's host-clock ms (synchronised). ``--no-guard`` turns off the
verification ladder's hold of a runaway OptimizeSim3 scale
(``loop_closing.SCALE_RUNAWAY``), as the JAX package runs it.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.ops import bow
    from orbslam3_byzyh_tpu_torch.pipeline import loop_closing
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.utils import evaluate

    if not torch.cuda.is_available():
        print("merge_variance_torch: no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != "--no-guard"]
    n_runs = int(args[0]) if args else 8
    if "--no-guard" in sys.argv:
        loop_closing.SCALE_RUNAWAY = float("inf")
    voc = bow.load_vocabulary(graft.RELOC_VOCABULARY)
    cfg = graft.merge_golden_config(voc)
    g = graft.golden_frames()
    seq = graft.merge_sequence(g)
    world = {round(f.stamp, 1): f.world for f in seq}

    def kf_scale(slam, m):
        st = slam.atlas.maps[m]
        valid = st.kfs.valid.cpu().numpy()
        R = st.kfs.R.cpu().double().numpy()
        t = st.kfs.t.cpu().double().numpy()
        stamp = st.kfs.stamp.cpu().double().numpy() + slam.t0
        est, true = [], []
        for k in np.flatnonzero(valid):
            w = world.get(round(float(stamp[k]), 1), -1)
            if w >= 0:
                est.append(-R[k].T @ t[k])
                true.append(g.centres[w])
        if len(est) < 3:
            return None
        s, _, _, ate = evaluate.horn_align(np.stack(est), np.stack(true))
        return dict(scale=float(s), ate=float(ate), n=len(est))

    def attach(slam, info, cur):
        inner = slam._merge_maps

        def spy(kf_id, other, cand, corr):
            info["scale_B_before"] = kf_scale(slam, slam.atlas.current)
            info["scale_A_before"] = kf_scale(slam, other)
            inner(kf_id, other, cand, corr)
            info["merges"].append(dict(index=cur[0], kf_id=kf_id, cand=cand,
                                       scale=float(corr[2]), n=int(corr[3])))

        slam._merge_maps = spy

    for run in range(n_runs):
        cell = "l" if run % 2 == 0 else "m"
        info = dict(run=run, cell=cell, merges=[], loops=[], slow=[], ms=[],
                    guard=loop_closing.SCALE_RUNAWAY)
        cur = [0]

        def play(slam, lo, hi):
            for i in range(lo, hi):
                cur[0] = i
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slam.track(seq[i].image, seq[i].stamp)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                info["ms"].append(round(ms, 1))
                lc = slam.loop_closer
                if lc.info.get("fired") and not lc.info.get("merge"):
                    info["loops"].append(dict(index=i,
                                              query=lc.info["query"]))
                if ms > 1000:
                    info["slow"].append(dict(index=i, ms=ms,
                                             n_kf=slam.n_kf))

        slam = system_mod.MonoSlam(cfg)
        attach(slam, info, cur)
        play(slam, 0, graft.MERGE_TRACKED)
        if cell == "m":
            with tempfile.TemporaryDirectory() as tmp:
                slam.save_atlas_checkpoint(os.path.join(tmp, "atlas"))
                slam = system_mod.MonoSlam(cfg)
                attach(slam, info, cur)
                slam.load_atlas_checkpoint(os.path.join(tmp, "atlas"))
            play(slam, graft.MERGE_TRACKED + graft.MERGE_NOISE, len(seq))
        else:
            play(slam, graft.MERGE_TRACKED, len(seq))
        info["ate"] = graft.merge_ate(slam.trajectory, slam.t0, seq, g)[0]
        info["n_kf_end"] = slam.n_kf
        print(json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
