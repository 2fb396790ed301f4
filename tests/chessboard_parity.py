"""The lockstep run of ``test_torch_chessboard_system.py``: the port's
``MonoSlam`` and the JAX package's on the committed chessboard frames at
640x512, recorded once on the JAX side and replayed on the port's.

:func:`record` runs both systems frame by frame (the port from the JAX
system's state at every frame up to the rebase, the JAX system from the
port's after it), with the JAX system's stage timers on, and keeps what the
tests need of the JAX side: each frame's JAX snapshot, the JAX context the
port was synced from before each frame, the JAX two-view RANSAC draws the
port was handed, the rebase's M, the map right after the JAX rebase, and
the stages the JAX system timed. ``scripts/chessboard_parity_jax.py``
writes it to :data:`FIXTURE` (it compiles and runs the JAX system: about 2
minutes on the CPU). :func:`replay` runs the port's side alone from that
record, as the lockstep run ran it, and returns the same (records, events)
as :func:`record`: the tests then compare both sides without running JAX.
"""

import dataclasses
import functools
import lzma
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from test_torch_system import _feats_np, _pose, _snapshot, _sync
from torch_port_util import jax_feats, jax_map_state, n

from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.pipeline import system as tsys

FIXTURE = (Path(__file__).resolve().parent / "golden"
           / "chessboard_parity_jax.pkl.xz")
N_FRAMES = 9
CFG = graft.chessboard_golden_config(half=True, **graft.CHESS_CPU_SLOTS)


def moved(R, t, R_m, t_m):
    R = np.asarray(R, np.float32) @ R_m.T
    return R, np.asarray(t, np.float32) - R @ t_m


class Dev:
    """A JAX device value of a recorded context (numpy), made a JAX array
    again on load: ``test_torch_system._port_value`` keeps host values as
    numpy and makes device values tensors."""

    def __init__(self, a):
        self.a = np.asarray(a)


def _jax_config(cfg):
    from orbslam3_byzyh_tpu.pipeline import system as jsys
    from orbslam3_byzyh_tpu.utils import chessboard as jcb
    fields = dataclasses.asdict(dataclasses.replace(cfg, chessboard=None))
    fields.update(chessboard=jcb.ChessboardConfig(
        **dataclasses.asdict(cfg.chessboard)), device_mesh=False,
        use_loop_closing=False, background_gba=False)
    return jsys.SlamConfig(**fields)


def _host(x):
    """A JAX system's value as the record keeps it."""
    if x is None or isinstance(x, (int, float, str, bool)):
        return x
    if isinstance(x, np.ndarray):
        return x.copy()
    return Dev(x)


def _context(js):
    """What ``test_torch_system._sync`` reads of the JAX system, with the
    chessboard fields, as plain host values."""
    last = js._last
    p = js._pending_kf
    c = js._ref_cache
    return SimpleNamespace(
        atlas=SimpleNamespace(
            maps=[type(m)(*(type(g)(*(np.asarray(a) for a in g))
                            for g in m)) for m in js.atlas.maps],
            meta=[(m.n_kf, m.n_lm, None if m.kf_parent is None
                   else np.array(m.kf_parent)) for m in js.atlas.meta],
            current=js.atlas.current),
        scalars={k: getattr(js, k) for k in (
            "status", "lost_frames", "frames_since_kf", "last_kf_id",
            "_ref_cache_gen", "_t0", "_init_stamp")},
        init_feats=(None if js._init_feats is None
                    else [np.asarray(a) for a in js._init_feats]),
        vel=None if js._vel is None else tuple(np.array(v) for v in js._vel),
        last=None if last is None else dict(
            feats=[np.asarray(a) for a in last["feats"]],
            bindings=_host(last["bindings"]), R=_host(last["R"]),
            t=_host(last["t"]), stamp=last["stamp"]),
        traj={k: list(getattr(js._traj, k)) for k in ("stamps", "refs",
                                                     "tags")},
        traj_R=[np.array(r) for r in js._traj.R_cr],
        traj_t=[np.array(t) for t in js._traj.t_cr],
        ref_cache=None if c is None else (c[0], np.array(c[1]),
                                          np.array(c[2])),
        pending=None if p is None else dict(
            kf_id=p["kf_id"], ref_gen=p["ref_gen"],
            info=np.asarray(p["info"]), culled=np.asarray(p["culled"])),
        kf_valid=np.asarray(js.state.kfs.valid),
        chess_pose=(None if js._chess_pose is None
                    else tuple(np.array(a) for a in js._chess_pose)),
        chess_applied=js._chess_applied)


def _as_jax_system(ctx):
    """A stand-in for the JAX system that ``_sync`` reads."""
    import jax.numpy as jnp
    from orbslam3_byzyh_tpu.models import atlas as jatlas

    def dev(x):
        return jnp.asarray(x.a) if isinstance(x, Dev) else x

    last = ctx.last
    return SimpleNamespace(
        atlas=SimpleNamespace(
            maps=ctx.atlas.maps, current=ctx.atlas.current,
            meta=[jatlas.MapMeta(k, l_, p) for k, l_, p in ctx.atlas.meta]),
        **ctx.scalars, _init_feats=ctx.init_feats, _vel=ctx.vel,
        _last=None if last is None else dict(
            feats=last["feats"], bindings=dev(last["bindings"]),
            R=dev(last["R"]), t=dev(last["t"]), stamp=last["stamp"]),
        _traj=SimpleNamespace(**ctx.traj, R_cr=ctx.traj_R,
                              t_cr=ctx.traj_t),
        _ref_cache=ctx.ref_cache,
        _pending_kf=None if ctx.pending is None else dict(
            ctx.pending, info=jnp.asarray(ctx.pending["info"]),
            culled=jnp.asarray(ctx.pending["culled"])),
        state=SimpleNamespace(kfs=SimpleNamespace(valid=ctx.kf_valid)))


def _sync_back(js, ts):
    """Give the JAX system the port system's map and host state (the
    reverse of ``test_torch_system._sync``)."""
    import jax.numpy as jnp
    from orbslam3_byzyh_tpu.models import atlas as jatlas
    js.atlas.maps = [jax_map_state(convert.map_state_to_numpy(m))
                     for m in ts.atlas.maps]
    js.atlas.meta = [jatlas.MapMeta(m.n_kf, m.n_lm, None if m.kf_parent is None
                                    else m.kf_parent.copy())
                     for m in ts.atlas.meta]
    js.atlas.current = ts.atlas.current
    for k in ("status", "lost_frames", "frames_since_kf", "last_kf_id",
              "_ref_cache_gen", "_t0", "_init_stamp", "_chess_applied"):
        setattr(js, k, getattr(ts, k))
    js._vel = None if ts._vel is None else tuple(np.array(v) for v in ts._vel)
    last = ts._last

    def host(x):
        return jnp.asarray(n(x)) if isinstance(x, torch.Tensor) else \
            np.array(x)

    js._last = dict(feats=jax_feats(_feats_np(last["feats"])),
                    bindings=jnp.asarray(n(last["bindings"])),
                    R=host(last["R"]), t=host(last["t"]), stamp=last["stamp"])
    for k in ("stamps", "refs", "tags"):
        setattr(js._traj, k, list(getattr(ts._traj, k)))
    js._traj.R_cr = [np.array(r) for r in ts._traj.R_cr]
    js._traj.t_cr = [np.array(t) for t in ts._traj.t_cr]
    c = ts._ref_cache
    js._ref_cache = None if c is None else (c[0], np.array(c[1]),
                                            np.array(c[2]))
    p = ts._pending_kf
    if p is None:
        js._pending_kf = None
    else:
        out = n(p["out"])
        k = CFG.max_kf
        js._pending_kf = dict(kf_id=p["kf_id"], ref_gen=p["ref_gen"],
                              info=jnp.asarray(out[:15]),
                              culled=jnp.asarray(out[15:15 + k] > 0),
                              valid_before=out[15 + k:] > 0)


def _port_frame(ts, feats, img, stamp, moved_out):
    """One port frame of the lockstep run: its features handed in, the
    rebase spied; returns its snapshot."""
    ts._extract = lambda _: feats
    rebase = ts._apply_chessboard_rebase

    def spy(*a):
        out = rebase(*a)
        moved_out["port"] = _snapshot(ts, None, False)
        return out

    ts._apply_chessboard_rebase = spy
    try:
        pose = _pose(ts.track(img, stamp))
    finally:
        del ts._apply_chessboard_rebase
    rec = _snapshot(ts, pose, False)
    rec["chess_pose"] = ts._chess_pose
    return rec


def record():
    """Both systems through the first frames, as the tests' lockstep run:
    (the record to save, the records and events the tests read)."""
    import jax
    import jax.numpy as jnp
    from orbslam3_byzyh_tpu.ops import geometry as jgeo
    from orbslam3_byzyh_tpu.pipeline import system as jsys
    from orbslam3_byzyh_tpu.utils import chessboard as jcb

    f = graft.chessboard_frames()
    js = jsys.MonoSlam(_jax_config(CFG))
    tj = js.enable_stage_timers()
    ts = tsys.MonoSlam(CFG, device="cpu")
    key = [jax.random.PRNGKey(0)]
    draws = []

    def jax_indices(matched):
        key[0], sub = jax.random.split(key[0])
        w = jnp.asarray(n(matched).astype(np.float32)) + 1e-9
        idx = np.array(jgeo._sample_indices(sub, 200, 8, w))
        draws.append(idx)
        return torch.from_numpy(idx).long()

    ts._ransac_indices = jax_indices
    two_view = jgeo.two_view_reconstruct
    jgeo.two_view_reconstruct = jax.jit(two_view)
    records, events, contexts, jax_side = [], {}, [], []
    try:
        for i in range(N_FRAMES):
            img = f.frames_half[i]
            x = torch.from_numpy(img)
            feats = graft.mono_extract(x.to(torch.float32), ts.cam_params,
                                       ts.dist, ts.mcfg)
            jf = jax_feats(_feats_np(feats))
            js._extract = lambda *_, jf=jf, **__: jf
            if "rebase" in events:
                _sync_back(js, ts)
            else:
                contexts.append(_context(js))
                _sync(ts, js)
                ts._chess_pose = (None if js._chess_pose is None else tuple(
                    np.array(a) for a in js._chess_pose))
                ts._chess_applied = js._chess_applied
            snoop_before = js._chess_pose is None
            applied_before = js._chess_applied
            kf0 = (np.asarray(js.state.kfs.R[0]), np.asarray(js.state.kfs.t[0]))
            rec = {"stamp": float(f.stamps[i])}
            mv = {}
            rebase = js._apply_chessboard_rebase

            def spy(*a, rebase=rebase):
                out = rebase(*a)
                mv["jax"] = _snapshot(js, None, True)
                return out

            js._apply_chessboard_rebase = spy
            try:
                pose = _pose(js.track(img, float(f.stamps[i])))
            finally:
                del js._apply_chessboard_rebase
            rec["jax"] = _snapshot(js, pose, True)
            rec["jax"]["chess_pose"] = (
                None if js._chess_pose is None
                else tuple(np.asarray(a) for a in js._chess_pose))
            rec["port"] = _port_frame(ts, feats, img, float(f.stamps[i]), mv)
            if snoop_before and js._chess_pose is not None:
                events["snoop"] = i
            if not applied_before and js._chess_applied:
                R_m, t_m = jcb.rebase_transform(*js._chess_pose, *kf0)
                events.update(rebase=i, R_m=R_m, t_m=t_m, moved=mv)
                # The JAX system's pose of this frame is in the old frame.
                rec["jax_pose_moved"] = moved(*rec["jax"]["pose"], R_m, t_m)
            records.append(rec)
            jax_side.append(dict(
                jax=rec["jax"], jax_pose_moved=rec.get("jax_pose_moved")))
    finally:
        jgeo.two_view_reconstruct = two_view
    saved = dict(
        frames=jax_side, contexts=contexts, draws=draws,
        events=dict(snoop=events["snoop"], rebase=events["rebase"],
                    R_m=np.asarray(events["R_m"]),
                    t_m=np.asarray(events["t_m"]),
                    moved_jax=events["moved"]["jax"]),
        stages=sorted(tj.samples),
        stage_counts={k: len(v) for k, v in tj.samples.items()})
    return saved, records, events


def save(saved, path=FIXTURE):
    with lzma.open(path, "wb", preset=9) as fh:
        pickle.dump(saved, fh, protocol=4)


@functools.cache
def load(path=FIXTURE):
    """The recorded JAX side (:func:`record`'s first result)."""
    with lzma.open(path, "rb") as fh:
        return pickle.load(fh)


@functools.cache
def replay():
    """The port's side of the lockstep run from the recorded JAX side: the
    port synced from the recorded JAX context before each frame up to the
    rebase and handed the recorded RANSAC draws; per frame a record of each
    side, and the events."""
    saved = load()
    f = graft.chessboard_frames()
    ts = tsys.MonoSlam(CFG, device="cpu")
    draws = iter(saved["draws"])
    ts._ransac_indices = lambda matched: torch.from_numpy(next(draws)).long()
    ev = saved["events"]
    records, port_moved = [], {}
    for i in range(N_FRAMES):
        img = f.frames_half[i]
        if i <= ev["rebase"]:
            ctx = saved["contexts"][i]
            _sync(ts, _as_jax_system(ctx))
            ts._chess_pose = ctx.chess_pose
            ts._chess_applied = ctx.chess_applied
        x = torch.from_numpy(img)
        feats = graft.mono_extract(x.to(torch.float32), ts.cam_params,
                                   ts.dist, ts.mcfg)
        rec = {"stamp": float(f.stamps[i]), **{
            k: v for k, v in saved["frames"][i].items() if v is not None}}
        rec["port"] = _port_frame(ts, feats, img, float(f.stamps[i]),
                                  port_moved)
        records.append(rec)
    events = dict(snoop=ev["snoop"], rebase=ev["rebase"], R_m=ev["R_m"],
                  t_m=ev["t_m"], moved=dict(jax=ev["moved_jax"],
                                            port=port_moved.get("port")))
    return records, events
