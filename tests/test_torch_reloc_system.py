"""Port parity: relocalization in the monocular system (``MonoSlam`` with a
vocabulary: the keyframe database, ``graft.relocalize``, the cross-map
re-entry) against the JAX package's ``MonoSlam``, frame by frame.

One JAX system and one port system, both with the runners' 10k-word
vocabulary and loop closing off, run a ``SynthWorld(seed=3)`` sequence
rendered here at 320x240 (fx = fy = 200, 1024 features, 16 keyframe and
2048 landmark slots): frames t = 0.4-2.4 s (the map fills its slots, so
the keyframes are compacted and the databases remapped), a blackout of 4
noise frames within the RECENTLY_LOST budget, the revisit of t =
1.0-1.2 s (relocalization into the active map at its first frame, as
``tests/test_reloc_localization.py``'s first case); then, with the budget
cut to 2 frames, a blackout of 6 noise frames (the mature map is kept and
a new one spawned) and the revisit of t = 1.5-1.7 s (relocalization into
the old map at its first frame, which becomes the active one again: the
test's cross-map case). About 190 s in one process (both systems run
every frame; the JAX ones compile).

Each frame starts from the same state in both systems: before it, the port
system is given the JAX system's maps, host state and keyframe databases
(``convert.carry_loop_closer``). Both get the port's extracted features.
The port's RANSACs take the JAX system's draws: the initialisation's as
``tests/test_torch_system.py`` replays them, the PnP's from the JAX
system's key (one split per candidate), mapped from landmark slots to
keypoint rows (the port runs the PnP over one row per matched keypoint;
``tests/test_torch_pnp.py``). The port's PnP also takes the JAX
function's DLT hypotheses for those samples: the hypotheses themselves
differ in float32 ``eigh`` and in the sign the JAX function does not fix
(``tests/test_torch_pnp.py`` states both), and the PnP's refine only
keeps inliers of the winning hypothesis. On a frame that hosts a keyframe
the port runs its own keyframe bundle and then takes the JAX bundle's
outputs, as ``tests/test_torch_stereo_system.py`` does: over this
sequence's 20-odd keyframes the windowed BA's float32 decisions part the
maps by up to 0.2 m on a few landmarks (1.3 px), the bundle being held to
the JAX package in ``test_torch_keyframe_step.py`` and
``test_torch_system.py``.

Each frame must agree: the status, the active map and the map count, the
keyframe and landmark counters, the reference keyframe, the pose (1e-4),
the bindings, the maps (``assert_states_close``) and the databases (words
and validity equal, vectors 1e-6). Each relocalization attempt must
agree: the database's candidates and their scores (1e-6), each tried
candidate's PnP (``ok`` and inliers; the pose within 1e-4 where ``ok``:
a failed PnP's pose is not used) and its local-map track's inliers, and
the candidate that passed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synth_world import SynthWorld
from test_torch_pnp import _jax_indices
from test_torch_system import _feats_np, _np_state, _pose, _snapshot, _sync
from torch_port_util import jax_feats, n

from orbslam3_byzyh_tpu.ops import bow as jbow
from orbslam3_byzyh_tpu.ops import geometry as jgeo
from orbslam3_byzyh_tpu.ops import pnp as jpnp
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import system as jsys
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import bow as tbow
from orbslam3_byzyh_tpu_torch.ops import pnp as tpnp
from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db as tkdb
from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as tlc
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

W, H, F = 320, 240, 200.0
CFG = dict(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H,
           n_features=1024, max_kf=16, max_lm=2048, max_obs=8, fps=10,
           min_init_matches=40, kf_ref_min_obs=1, local_window=2,
           ba_window=6, local_lm_window=512, ba_lm_window=512,
           lost_grace_frames=30)
CAM = np.array([F, F, W / 2, H / 2], np.float32)
# (world time or None for noise, stamp, the RECENTLY_LOST budget from it)
TRACK = [(round(t, 3), round(t, 3)) for t in np.arange(0.4, 2.45, 0.1)]


def _sequence():
    seq = [(w, s, None) for w, s in TRACK]
    s = TRACK[-1][1]
    for w in [None] * 4 + [1.0, 1.1, 1.2]:
        s = round(s + 0.1, 3)
        seq.append((w, s, None))
    for i, w in enumerate([None] * 6 + [1.5, 1.6, 1.7]):
        s = round(s + 0.1, 3)
        seq.append((w, s, 2 if i == 0 else None))
    return seq


SEQ = _sequence()
BLACKOUT_1 = len(TRACK)
REVISIT_1 = BLACKOUT_1 + 4
BLACKOUT_2 = REVISIT_1 + 3
REVISIT_2 = BLACKOUT_2 + 6


@functools.cache
def _vocabularies():
    return (jbow.load_vocabulary(str(graft.RELOC_VOCABULARY)),
            tbow.load_vocabulary(graft.RELOC_VOCABULARY, device="cpu"))


@functools.cache
def _run():
    """Both systems through the sequence, the port from the JAX system's
    state at every frame: per frame a record of each side, with its
    databases and relocalization attempts."""
    jv, tv = _vocabularies()
    world = SynthWorld(seed=3, w=W, h=H, fx=F, fy=F)
    js = jsys.MonoSlam(jsys.SlamConfig(**CFG, vocabulary=jv,
                                       use_loop_closing=False,
                                       background_gba=False,
                                       device_mesh=False))
    ts = tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=tv,
                                       use_loop_closing=False), device="cpu")
    key = [None]

    def split():
        key[0], sub = jax.random.split(key[0])
        return sub

    def init_indices(matched):
        w = jnp.asarray(n(matched).astype(np.float32)) + 1e-9
        return torch.from_numpy(np.array(
            jgeo._sample_indices(split(), 200, 8, w))).long()

    def pnp_indices(corr, kp_lm):
        corr, kp_lm = n(corr), n(kp_lm)
        lm_valid = np.zeros(CFG["max_lm"], bool)
        lm_valid[kp_lm[corr]] = True
        slots = _jax_indices(split(), lm_valid)
        kp_of = np.full(CFG["max_lm"], -1, np.int64)
        kp_of[kp_lm[corr]] = np.flatnonzero(corr)
        rows = kp_of[slots]
        # A slot without a match (weight 1e-9: drawn only when a candidate
        # has almost no match) has no keypoint row: either package's
        # hypothesis from it is garbage, and a PnP without enough matches
        # fails in both.
        spare = np.flatnonzero(~corr)
        rows[rows < 0] = spare[0] if len(spare) else 0
        return torch.from_numpy(rows)

    jax_dlt = jax.jit(jax.vmap(jpnp._dlt_pose))

    def dlt_from_jax(X, x):
        return tuple(torch.from_numpy(np.array(a))
                     for a in jax_dlt(jnp.asarray(n(X)), jnp.asarray(n(x))))

    ts._ransac_indices = init_indices
    ts._pnp_indices = pnp_indices
    attempts = {"jax": [], "port": []}

    def spy_db(store, cls):
        fn = cls.query_groups

        def wrapped(self, *a, **k):
            out = fn(self, *a, **k)
            store.append({"ids": np.array(out[0]),
                          "scores": np.array(out[1], np.float64),
                          "pnp": [], "tracks": []})
            return out
        return fn, wrapped

    def spy_pnp(store, mod):
        fn = mod.pnp_ransac

        def wrapped(*a, **k):
            out = fn(*a, **k)
            store[-1]["pnp"].append(
                (bool(out.ok), int(out.n_inliers), n(out.R), n(out.t)))
            return out
        return fn, wrapped

    from orbslam3_byzyh_tpu.pipeline import keyframe_db as jkdb
    from orbslam3_byzyh_tpu.pipeline import tracking as jtr
    from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

    def spy_track(store, mod):
        fn = mod.track_local_map

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if store and len(store[-1]["tracks"]) < len(store[-1]["pnp"]):
                store[-1]["tracks"].append(int(out.n_inliers))
            return out
        return fn, wrapped

    patches = []
    for mod, name, (orig, new) in (
            (jkdb.KeyframeDatabase, "query_groups",
             spy_db(attempts["jax"], jkdb.KeyframeDatabase)),
            (tkdb.KeyframeDatabase, "query_groups",
             spy_db(attempts["port"], tkdb.KeyframeDatabase)),
            (jpnp, "pnp_ransac", spy_pnp(attempts["jax"], jpnp)),
            (tpnp, "pnp_ransac", spy_pnp(attempts["port"], tpnp)),
            (jtr, "track_local_map", spy_track(attempts["jax"], jtr)),
            (ttr, "track_local_map", spy_track(attempts["port"], ttr))):
        patches.append((mod, name, orig, new))
    bundles = []
    jax_bundle, port_bundle = jmap.keyframe_bundle, graft.mono_keyframe_step

    def jax_bundle_kept(*a, **k):
        out = jax_bundle(*a, **k)
        bundles.append(out)
        return out

    def port_bundle_then_jax(*a, **k):
        """The port's own bundle runs; the frame goes on with the JAX
        bundle's outputs of the same frame."""
        port_bundle(*a, **k)
        st, b, info, culled = bundles[-1]
        return (convert.map_state_to_torch(_np_state(st), "cpu"),
                *(convert.to_torch(np.asarray(x), "cpu")
                  for x in (b, info, culled)))

    patches += [(jgeo, "two_view_reconstruct", jgeo.two_view_reconstruct,
                 jax.jit(jgeo.two_view_reconstruct)),
                (tpnp, "_dlt_pose", tpnp._dlt_pose, dlt_from_jax),
                (jmap, "keyframe_bundle", jax_bundle, jax_bundle_kept),
                (graft, "mono_keyframe_step", port_bundle,
                 port_bundle_then_jax)]
    records = []
    try:
        for mod, name, _, new in patches:
            setattr(mod, name, new)
        for i, (w, stamp, grace) in enumerate(SEQ):
            if grace is not None:
                js.lost_grace = ts.lost_grace = grace
            img = (world.render(float(w)) if w is not None else
                   np.random.default_rng(100 + i).uniform(
                       0, 30, (H, W)).astype(np.float32))
            f = graft.mono_extract(torch.from_numpy(img).float(),
                                   ts.cam_params, None, ts.mcfg)
            jf = jax_feats(_feats_np(f))
            ts._extract = lambda _, f=f: f
            js._extract = lambda *_, jf=jf, **__: jf
            _sync(ts, js)
            ts.n_cross_map_relocs = js.n_cross_map_relocs
            convert.carry_loop_closer(js.loop_closer, ts.loop_closer)
            rec = {"stamp": stamp, "world": w}
            k0 = js.rng_key
            for name, slam in (("jax", js), ("port", ts)):
                key[0] = k0
                n_att = len(attempts[name])
                pose = _pose(slam.track(img, float(stamp)))
                snap = _snapshot(slam, pose, name == "jax")
                snap.update(
                    current=slam.atlas.current,
                    n_cross=slam.n_cross_map_relocs,
                    dbs={m: (convert.keyframe_db_to_numpy(db)
                             if name == "port" else tuple(
                                 np.asarray(x) for x in
                                 (db.vecs, db.words, db.valid)))
                         for m, db in slam.loop_closer.dbs.items()},
                    active=slam.loop_closer.active,
                    attempts=attempts[name][n_att:])
                rec[name] = snap
            records.append(rec)
    finally:
        for mod, name, orig, _ in patches:
            setattr(mod, name, orig)
    return records


def _assert_same_attempts(ref, got):
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        close = np.sort(a["scores"][a["scores"] > 1e-6])
        for j in np.flatnonzero(np.diff(close) < 1e-6):
            print(f"candidates' scores {close[j]:.9f} and {close[j + 1]:.9f}"
                  " within 1e-6; their order may flip")
        np.testing.assert_array_equal(b["ids"], a["ids"])
        np.testing.assert_allclose(b["scores"], a["scores"], atol=1e-6)
        assert len(b["pnp"]) == len(a["pnp"])
        for (ok1, n1, R1, t1), (ok2, n2, R2, t2) in zip(a["pnp"], b["pnp"]):
            assert (ok2, n2) == (ok1, n1)
            if ok1:           # a failed PnP's pose is not used
                np.testing.assert_allclose(R2, R1, atol=1e-4)
                np.testing.assert_allclose(t2, t1, atol=1e-4)
        assert b["tracks"] == a["tracks"]


def _assert_same(ref, got):
    for k in ("status", "n_kf", "n_lm", "last_kf_id", "frames_since_kf",
              "n_maps", "refs", "current", "n_cross", "active"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    np.testing.assert_array_equal(got["kf_parent"], ref["kf_parent"])
    assert (got["pose"] is None) == (ref["pose"] is None)
    if ref["pose"] is not None:
        for a, b in zip(got["pose"], ref["pose"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    assert (got["bindings"] is None) == (ref["bindings"] is None)
    if ref["bindings"] is not None:
        np.testing.assert_array_equal(got["bindings"], ref["bindings"])
    from torch_port_util import assert_states_close
    assert_states_close(ref["state"], got["state"], CAM)
    assert sorted(got["dbs"]) == sorted(ref["dbs"])
    for m in ref["dbs"]:
        (jv, jw, jok), (pv, pw, pok) = ref["dbs"][m], got["dbs"][m]
        np.testing.assert_array_equal(pok, jok)
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_allclose(pv, jv, atol=1e-6)
    _assert_same_attempts(ref["attempts"], got["attempts"])


def test_sequence_does_its_work():
    """The reference run fills and compacts its map, goes RECENTLY_LOST in
    the first blackout and relocalizes in the active map during the first
    revisit; loses the map in the second blackout (a second map is made)
    and re-enters the first map during the second revisit."""
    ref = [r["jax"] for r in _run()]
    status = [r["status"] for r in ref]
    assert status[BLACKOUT_1 - 1] == tsys.OK
    assert ref[BLACKOUT_1 - 1]["n_kf"] >= 10
    assert tsys.RECENTLY_LOST in status[BLACKOUT_1:REVISIT_1]
    hit1 = next(i for i in range(REVISIT_1, BLACKOUT_2)
                if status[i] == tsys.OK)
    assert any(a["tracks"] for a in ref[hit1]["attempts"])
    assert ref[hit1]["n_maps"] == 1 and ref[hit1]["current"] == 0
    assert all(s == tsys.OK for s in status[hit1:BLACKOUT_2])
    assert tsys.NOT_INITIALIZED in status[BLACKOUT_2:REVISIT_2]
    assert ref[REVISIT_2 - 1]["n_maps"] == 2
    hit2 = next(i for i in range(REVISIT_2, len(SEQ))
                if status[i] == tsys.OK)
    assert ref[hit2]["current"] == 0 and ref[hit2]["n_cross"] == 1
    assert ref[hit2]["n_kf"] >= 10 and ref[hit2]["active"] == 0
    assert all(s == tsys.OK for s in status[hit2:])
    print(f"relocalized at frames {hit1} (world t {SEQ[hit1][0]}) and "
          f"{hit2} (world t {SEQ[hit2][0]}, into map 0)")


@pytest.mark.parametrize("i", range(len(SEQ)))
def test_frame_matches_jax(i):
    rec = _run()[i]
    _assert_same(rec["jax"], rec["port"])


def test_options():
    """A vocabulary with loop closing is ported (ROADMAP item 12b): the
    system builds its loop closer with the intrinsics; the loop closer's
    merge branch (item 12c) mines no map of a one-map atlas and an empty
    weld leaves its databases and loop edges; a vocabulary that is not
    the port's is refused."""
    _, tv = _vocabularies()
    slam = tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=tv), device="cpu")
    assert slam.cfg.use_loop_closing and slam.cfg.background_gba
    np.testing.assert_array_equal(n(slam.loop_closer.cam_params), CAM)
    with pytest.raises(TypeError, match="ops.bow.Vocabulary"):
        tsys.MonoSlam(tsys.SlamConfig(**CFG, vocabulary=np.zeros(4),
                                      use_loop_closing=False), device="cpu")
    lc = tlc.LoopCloser(tv, 8, 32)
    at = slam.atlas
    assert lc.detect_merge(at.state, 0, at) is None
    lc.on_maps_merged(0, 1, at.state, 0, 0)
    assert sorted(lc.dbs) == [0] and lc.active == 0
    assert lc.loop_edges == {0: []} and lc.inertial_4dof is False
    assert lc._streak is None and lc.cam_params is None


def test_systems_take_a_vocabulary():
    """Every system accepts a port vocabulary with loop closing off and
    keeps its keyframe database; the stereo systems store keyframe 0 at
    their one-frame init and set the fixed scale, as the JAX classes do;
    the inertial systems set it too, and a re-entry into an older map
    restarts their IMU machinery with a fresh chain."""
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as tvi
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_inertial as tsi
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_system as tst
    _, tv = _vocabularies()
    voc = dict(vocabulary=tv, use_loop_closing=False)
    g = graft.stereo_frames()
    fx, fy, cx, cy, w, h = (float(x) for x in g.camera)
    st = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=int(w), height=int(h),
              n_features=1024, max_kf=8, max_lm=4096, max_obs=8, fps=10,
              bf=0.2 * fx, th_depth=35.0, kf_ref_min_obs=1)
    imu = tvi.ImuConfig(T_bc=np.eye(4, dtype=np.float32))
    systems = {
        "mono": tsys.MonoSlam(tsys.SlamConfig(**CFG, **voc), device="cpu"),
        "stereo": tst.StereoSlam(tst.StereoConfig(**st, **voc),
                                 device="cpu"),
        "rgbd": tst.RgbdSlam(tst.RgbdConfig(**st, **voc), device="cpu"),
        "fisheye": tst.FisheyeStereoSlam(tst.FisheyeStereoConfig(
            **st, **voc, R_rl=np.eye(3, dtype=np.float32),
            t_rl=np.array([-0.2, 0, 0], np.float32)), device="cpu"),
        "mono_inertial": tvi.MonoInertialSlam(
            tsys.SlamConfig(**CFG, **voc), imu, device="cpu"),
        "stereo_inertial": tsi.StereoInertialSlam(
            tst.StereoConfig(**st, **voc), imu, device="cpu"),
        "fisheye_inertial": tsi.FisheyeStereoInertialSlam(
            tst.FisheyeStereoConfig(
                **st, **voc, R_rl=np.eye(3, dtype=np.float32),
                t_rl=np.array([-0.2, 0, 0], np.float32)), imu,
            device="cpu")}
    for name, slam in systems.items():
        lc = slam.loop_closer
        assert lc is not None and lc.db.vecs.shape[1] == tv.n_words, name
        assert lc.cfg.fix_scale == (name != "mono"), name
    slam = systems["stereo"]
    for left, right, s in zip(g.left[:2], g.right[:2], g.stamps[:2]):
        slam.track(left, right, float(s))
    assert slam.status == tsys.OK
    assert bool(slam.loop_closer.db.valid[0])
    vi = systems["mono_inertial"]
    vi.imu_ready, vi.kf_prev[:] = True, 0
    kfs = vi.state.kfs
    vi.state = vi.state._replace(kfs=kfs._replace(
        valid=kfs.valid.clone().index_fill_(0, torch.tensor([0, 3]), True),
        stamp=kfs.stamp.clone().index_fill_(0, torch.tensor([3]), 1.25)))
    vi._on_cross_map_reloc(3)
    assert vi._fresh_chain and not vi.imu_ready and (vi.kf_prev == -1).all()
    # The re-entered map's keyframe stamps are back on the host.
    assert vi.kf_stamp[3] == 1.25 and vi.kf_stamp[0] == 0.0
    assert np.isnan(vi.kf_stamp[1])
