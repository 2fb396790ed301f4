#!/usr/bin/env python3
"""How far the global BA's poses are determined on a closed loop, sharded
and unsharded, in float32 and float64.

    python scripts/gba_spread_torch.py [--cpu] [--repeats N] [--shards S]
                                       [--plant] [--out FILE]

Closes the loop of ``graft.euroc_loop_map`` (``chip_smoke.py`` phase 20
(a)'s map: 160 keyframes and 1024 / 65,536 / 12 slots on the card; with
``--cpu`` a cut circuit, 40 keyframes and 64 / 12,288 slots, on the CPU)
without its global BA, then runs ``mapping.global_ba`` on the closed map:
in float64 once unsharded and once over an S-shard mesh (4 by default,
every shard on the one device), and in float32 N times each (8 by
default). Prints one JSON object: each pair's largest keyframe rotation
entry gap (``R``) and translation gap (``t``, m), the scale about
keyframe 0's centre that best maps the second set of centres onto the
first (``scale``: the monocular gauge that keyframe 0 leaves free) and the
translation gap with that scale taken out (``t_gauged``); as min, median
and max over the pairs of: the unsharded float32 runs, the sharded ones,
sharded against unsharded, and float32 against the float64 result.
``--plant`` adds a planted sharding fault, the first shard left out of
every sum (``solver.ba.sum_on``; the live landmarks fill the first slots,
so the last shards may hold none), in float32 (against the unsharded runs
and the float64 result) and float64: the gap a gate must tell from the
honest ones.
"""

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import bow
    from orbslam3_byzyh_tpu_torch.parallel import dist_ba
    from orbslam3_byzyh_tpu_torch.pipeline import loop_closing, mapping
    from orbslam3_byzyh_tpu_torch.solver import ba

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--plant", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    if a.cpu:
        dev = torch.device("cpu")
        cfg = graft.EUROC_MONO._replace(max_kf=64, max_lm=12288)
        m = graft.euroc_loop_map(cfg, n_kf=40)
    else:
        if not torch.cuda.is_available():
            print("gba_spread_torch: no CUDA device (pass --cpu)",
                  file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        cfg = graft.EUROC_MONO
        m = graft.euroc_loop_map(cfg)
    voc = bow.load_vocabulary(graft.RELOC_VOCABULARY, dev)
    cam = convert.to_torch(m.cam_params, dev)
    state0 = convert.map_state_to_torch(m.state, dev)
    n = m.n_kf
    lc = loop_closing.LoopCloser(voc, cfg.max_kf, cfg.n_features,
                                 cam_params=m.cam_params)
    for k in range(n):
        lc.add_keyframe(state0, k)
    for q in m.revisit:
        closed, info = graft.loop_closing_step(
            state0, lc, q, n, cam, kf_parent=m.kf_parent, cfg=cfg,
            gba="none")
    if not info["fired"]:
        print("gba_spread_torch: the loop did not close", file=sys.stderr)
        return 1

    def f64(st):
        return type(st)(*(type(g)(*(x.double() if x.is_floating_point()
                                    else x for x in g)) for g in st))

    def poses(st):
        return (st.kfs.R[:n].double().cpu().numpy(),
                st.kfs.t[:n].double().cpu().numpy())

    def gap(a_, b_):
        (Ra, ta), (Rb, tb) = a_, b_
        ca = -np.einsum("kji,kj->ki", Ra, ta)
        cb = -np.einsum("kji,kj->ki", Rb, tb)
        da, db = ca - ca[0], cb - cb[0]
        s = float((da * db).sum() / (db * db).sum())
        tb_s = -np.einsum("kij,kj->ki", Rb, ca[0] + s * db)
        return dict(R=float(np.abs(Ra - Rb).max()),
                    t=float(np.abs(ta - tb).max()), scale=s,
                    t_gauged=float(np.abs(ta - tb_s).max()))

    def summary(gaps):
        return {k: [min(g[k] for g in gaps),
                    float(np.median([g[k] for g in gaps])),
                    max(g[k] for g in gaps)] for k in gaps[0]}

    mesh = dist_ba.make_mesh(a.shards, devices=[dev] * a.shards)
    st64, cam64 = f64(closed), cam.double()
    ref = poses(mapping.global_ba(st64, cam64))
    out = {"device": str(dev), "keyframes": n, "slots": [
        cfg.max_kf, cfg.max_lm, cfg.max_obs], "shards": a.shards,
        "repeats": a.repeats,
        "float64_sharded": gap(poses(mapping.global_ba(st64, cam64,
                                                       mesh=mesh)), ref)}
    un = [poses(mapping.global_ba(closed, cam)) for _ in range(a.repeats)]
    sh = [poses(mapping.global_ba(closed, cam, mesh=mesh))
          for _ in range(a.repeats)]
    pairs = [(i, j) for i in range(a.repeats) for j in range(i + 1,
                                                             a.repeats)]
    if pairs:
        out["float32_unsharded_repeats"] = summary([gap(un[i], un[j])
                                                    for i, j in pairs])
        out["float32_sharded_repeats"] = summary([gap(sh[i], sh[j])
                                                  for i, j in pairs])
    out["float32_sharded_vs_unsharded"] = summary([gap(x, y) for x in sh
                                                   for y in un])
    out["float32_vs_float64"] = summary([gap(x, ref) for x in un + sh])
    if a.plant:
        honest = ba.sum_on
        ba.sum_on = lambda xs, d: honest(xs[1:], d)
        try:
            bad32 = poses(mapping.global_ba(closed, cam, mesh=mesh))
            bad64 = poses(mapping.global_ba(st64, cam64, mesh=mesh))
        finally:
            ba.sum_on = honest
        out["planted_float32_vs_unsharded"] = summary([gap(bad32, y)
                                                       for y in un])
        out["planted_float32_vs_float64"] = gap(bad32, ref)
        out["planted_float64_vs_unsharded"] = gap(bad64, ref)
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
