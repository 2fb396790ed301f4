#!/usr/bin/env python3
"""The JAX package's ``MonoSlam`` with loop closing on: the reference
decisions the PyTorch port's loop closer is held to.

    JAX_PLATFORMS=cpu python scripts/loop_reference_jax.py k
    JAX_PLATFORMS=cpu python scripts/loop_reference_jax.py k --vocabulary PATH

Cell (k), the runners' default configuration (``scripts/run_euroc_mono.py``
with no flag): ``orbslam3_byzyh_tpu``'s ``MonoSlam`` with a vocabulary
(default ``vocabulary/synthetic_voc_10k.npz``), ``use_loop_closing`` and
``background_gba`` on, at ``graft.loop_golden_config()`` (the golden frames
padded to 752x480, 1536 features) with the map cut to
``graft.RELOC_CPU_SLOTS`` (the JAX init's one-hot Schur needs about
21 GiB at the EuRoC-mono capacity). Prints one JSON line: each frame's
status and keyframe count; each call of ``LoopCloser.detect`` (the
keyframe, the keyframe count, the candidates, each verified candidate's
ladder counts and the stage it failed at, whether a loop fired); the
trajectory's ATE against the golden truth (Horn with scale).
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
    ap.add_argument("cell", choices=("k",))
    ap.add_argument("--vocabulary", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from orbslam3_byzyh_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    from orbslam3_byzyh_tpu.ops import bow, matching, sim3_solve
    from orbslam3_byzyh_tpu.pipeline import loop_closing
    from orbslam3_byzyh_tpu.pipeline import system as jsys

    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.utils import evaluate

    voc_path = args.vocabulary or str(graft.RELOC_VOCABULARY)
    fields = dataclasses.asdict(graft.loop_golden_config())
    fields.update(vocabulary=bow.load_vocabulary(voc_path), device_mesh=False,
                  **graft.RELOC_CPU_SLOTS)
    slam = jsys.MonoSlam(jsys.SlamConfig(**fields))
    lc = slam.loop_closer
    cfg = lc.cfg
    calls, tried = [], []

    # The ladder's counts, recorded from the functions it calls.
    match, ransac, opt = (matching.match, sim3_solve.sim3_ransac,
                          sim3_solve.optimize_sim3)
    guided = lc._guided_projection

    def spy_match(*a, **kw):
        mj, d = match(*a, **kw)
        tried[-1]["bow"] = int((np.asarray(mj) >= 0).sum())
        return mj, d

    def spy_ransac(key, pa, *a, **kw):
        res = ransac(key, pa, *a, **kw)
        tried[-1].update(pairs=int(pa.shape[0]), ransac_ok=bool(res.ok),
                         ransac_inliers=int(res.n_inliers))
        return res

    def spy_guided(*a, **kw):
        mj = guided(*a, **kw)
        key = "projection" if "projection" not in tried[-1] else \
            "projection_opt"
        tried[-1][key] = int((np.asarray(mj) >= 0).sum())
        return mj

    def spy_opt(*a, **kw):
        res = opt(*a, **kw)
        tried[-1]["sim3_inliers"] = int(res.n_inliers)
        return res

    verify = lc._verify

    def spy_verify(state_q, q, state_c, c, db, words):
        tried.append({"cand": int(c)})
        # The ladder's own calls are recorded (the modules are shared with
        # tracking, so the spies are in place for this call alone).
        loop_closing.matching.match = spy_match
        loop_closing.sim3_solve.sim3_ransac = spy_ransac
        loop_closing.sim3_solve.optimize_sim3 = spy_opt
        try:
            m = verify(state_q, q, state_c, c, db, words)
        finally:
            loop_closing.matching.match = match
            loop_closing.sim3_solve.sim3_ransac = ransac
            loop_closing.sim3_solve.optimize_sim3 = opt
        r = tried[-1]
        gates = (("bow", cfg.min_bow_matches),
                 ("pairs", cfg.min_ransac_inliers),
                 ("ransac", None), ("projection", cfg.min_proj_matches),
                 ("sim3", cfg.min_sim3_inliers),
                 ("projection_opt", cfg.min_proj_opt_matches))
        r["failed"] = None
        if m is None:
            for stage, lim in gates:
                key = {"sim3": "sim3_inliers", "ransac": "ransac_ok"}.get(
                    stage, stage)
                if stage == "pairs" and "pairs" not in r:
                    r["failed"] = "pairs"
                    break
                v = r.get(key)
                if (stage == "ransac" and v is False) or (
                        lim is not None and v is not None and v < lim):
                    r["failed"] = stage
                    break
        else:
            r["s"] = float(m[2])
        return m

    detect = lc.detect

    def spy_detect(state, kf_id, n_kf):
        start = len(tried)
        ids = []
        query = lc.db.query_groups

        def spy_query(*a, **kw):
            out = query(*a, **kw)
            # A dead candidate is skipped by the caller: -1, as the port's
            # query reports it.
            live = np.asarray(state.kfs.valid)
            ids.extend(int(c) if c >= 0 and live[c] else -1 for c in out[0])
            return out

        lc.db.query_groups = spy_query
        try:
            det = detect(state, kf_id, n_kf)
        finally:
            del lc.db.query_groups
        calls.append(dict(
            frame=len(records), query=int(kf_id), n_kf=int(n_kf),
            candidates=ids, tried=tried[start:],
            streak=None if lc._streak is None else lc._streak["count"],
            fired=det is not None,
            cand=None if det is None else int(det[0])))
        return det

    lc._guided_projection = spy_guided
    lc._verify = spy_verify
    lc.detect = spy_detect

    g = graft.golden_frames()
    frames = graft.pad_frames(g.frames)
    records = []
    t_start = time.perf_counter()
    for img, s in zip(frames, g.stamps):
        was = slam.status
        slam.track(img, float(s))
        records.append(dict(stamp=float(s), before=int(was),
                            status=int(slam.status), n_kf=int(slam.n_kf)))
    traj = slam.trajectory
    seconds = time.perf_counter() - t_start
    idx = [int(round((float(st) - slam.t0) * 10)) for st, _, _ in traj]
    est = evaluate.camera_centers(np.stack([np.asarray(R) for _, R, _ in traj]),
                                  np.stack([np.asarray(t) for _, _, t in traj]))
    ate = evaluate.horn_align(est, g.centres[idx])[3]
    print(json.dumps(dict(
        cell=args.cell, vocabulary=os.path.basename(voc_path),
        slots=graft.RELOC_CPU_SLOTS, frames=records, detect=calls,
        n_frames=len(traj), ate_m=float(ate),
        loops=len(lc.loop_edges.get(lc.active, [])), seconds=seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
