"""State carried across from the JAX package's numpy arrays.

The system has no learned weights: the map arrays and the camera are its
state. Descriptors are 256-bit strings stored as (N, 8) ``uint32`` words in
the JAX package; torch has few ``uint32`` ops, so the port keeps the same
bits as ``int32`` (a ``view``, never a value conversion).
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .models import map_state as ms


def to_torch(x, device=None) -> torch.Tensor:
    """One array (numpy, JAX or Python) -> tensor on ``device`` (``None``:
    the card, see :func:`device.resolve`).

    uint32 -> bit-identical int32; other integers -> int32; floats -> f32;
    bool stays bool.
    """
    dev = device_mod.resolve(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(dev)   # a copy


def tree_to_torch(args, device=None) -> tuple:
    """A tuple of arrays (e.g. the tracking-step arguments) -> tensors on
    ``device`` (``None``: the card); a None stays None."""
    dev = device_mod.resolve(device)
    return tuple(None if a is None else to_torch(a, dev) for a in args)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host (no dtype change)."""
    return t.detach().cpu().numpy()


def desc_to_uint32(t: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 descriptor words -> the JAX package's uint32 words."""
    return to_numpy(t).astype(np.int32, copy=False).view(np.uint32)


def map_state_to_torch(state_np, device=None):
    """A map state of numpy (or JAX) arrays, shaped as the JAX package's
    ``MapState``, -> the port's ``MapState`` of tensors on ``device``
    (``None``: the card). Descriptors become bit-identical int32 words."""
    dev = device_mod.resolve(device)
    return ms.MapState(
        kfs=ms.KeyFrames(*(to_torch(a, dev) for a in state_np.kfs)),
        lms=ms.Landmarks(*(to_torch(a, dev) for a in state_np.lms)),
        obs=ms.Observations(*(to_torch(a, dev) for a in state_np.obs)))


def map_state_to_numpy(state):
    """The port's ``MapState`` -> the same NamedTuples of numpy arrays, with
    the JAX package's dtypes (descriptors as uint32 words)."""
    desc = {"kp_desc", "desc"}

    def conv(group):
        return type(group)(*(
            desc_to_uint32(x) if name in desc else to_numpy(x)
            for name, x in zip(group._fields, group)))

    return ms.MapState(kfs=conv(state.kfs), lms=conv(state.lms),
                       obs=conv(state.obs))


def atlas_to_torch(atlas_np, device=None):
    """An atlas with the JAX package's ``Atlas`` attributes (``dims``,
    ``maps`` of numpy or JAX map states, ``meta`` with ``n_kf``, ``n_lm``,
    ``kf_parent``, ``current``) -> the port's ``Atlas`` on ``device``
    (``None``: the card); the spanning trees copied."""
    from .models import atlas as atlas_mod
    dev = device_mod.resolve(device)
    out = atlas_mod.Atlas(*atlas_np.dims, device=dev)
    out.maps = [map_state_to_torch(s, dev) for s in atlas_np.maps]
    out.meta = [atlas_mod.MapMeta(
        n_kf=int(m.n_kf), n_lm=int(m.n_lm),
        kf_parent=(None if m.kf_parent is None
                   else np.asarray(m.kf_parent, np.int32).copy()))
        for m in atlas_np.meta]
    out.current = int(atlas_np.current)
    return out


def atlas_to_numpy(atlas) -> dict:
    """The port's ``Atlas`` -> a dict: ``dims``, ``maps`` (numpy map
    states, the JAX package's dtypes), ``meta`` (``(n_kf, n_lm,
    kf_parent)`` tuples) and ``current``."""
    return dict(dims=tuple(atlas.dims),
                maps=[map_state_to_numpy(s) for s in atlas.maps],
                meta=[(m.n_kf, m.n_lm, None if m.kf_parent is None
                       else m.kf_parent.copy()) for m in atlas.meta],
                current=atlas.current)


def preint_to_torch(p, device=None):
    """A preintegration (any NamedTuple with the JAX package's
    ``PreintState`` fields, numpy or JAX leaves, batched or not) -> the
    port's ``imu.PreintState`` on ``device`` (``None``: the card)."""
    from .ops import imu
    dev = device_mod.resolve(device)
    return imu.PreintState(*(to_torch(getattr(p, f), dev)
                             for f in imu.PreintState._fields))


def preint_to_numpy(p):
    """The port's ``imu.PreintState`` -> the same NamedTuple of numpy
    arrays (feed it to the JAX package's ``PreintState(*...)``)."""
    return type(p)(*(to_numpy(x) for x in p))


def viba_problem_to_torch(p, device=None):
    """A VI-BA problem shaped as the JAX package's ``VIBAProblem`` (numpy or
    JAX leaves) -> the port's ``inertial_ba.VIBAProblem`` on ``device``;
    ``obs_ur`` and ``bf`` may be None."""
    from .solver import inertial_ba
    dev = device_mod.resolve(device)
    return inertial_ba.VIBAProblem(**{
        f: (preint_to_torch(p.preints, dev) if f == "preints"
            else None if getattr(p, f) is None
            else to_torch(getattr(p, f), dev))
        for f in inertial_ba.VIBAProblem._fields})


def viba_problem_to_numpy(p):
    """The port's ``VIBAProblem`` -> a dict of its fields as numpy (the
    preintegrations a numpy ``PreintState``; None stays None)."""
    return {f: (preint_to_numpy(x) if f == "preints"
                else None if x is None else to_numpy(x))
            for f, x in zip(p._fields, p)}


def inertial_map_to_torch(state_np, kf_vel, kf_bg, kf_ba, kf_prev,
                          kf_preint, kf_stamp, device=None):
    """A map state (numpy, the JAX package's dtypes) with its per-keyframe
    inertial arrays -> the port's ``inertial_system.InertialMap``: the
    velocities and biases (max_kf, 3) on ``device``; the chain ``kf_prev``,
    the stamps and the per-slot preintegrations (numpy ``PreintState``s or
    None) as the system keeps them (host arrays, device preintegrations)."""
    from .pipeline import inertial_system as vi
    dev = device_mod.resolve(device)
    return vi.InertialMap(
        state=map_state_to_torch(state_np, dev), kf_vel=to_torch(kf_vel, dev),
        kf_bg=to_torch(kf_bg, dev), kf_ba=to_torch(kf_ba, dev),
        kf_prev=np.asarray(kf_prev, np.int32).copy(),
        kf_preint=[None if q is None else preint_to_torch(q, dev)
                   for q in kf_preint],
        kf_stamp=np.asarray(kf_stamp, np.float64).copy())


def inertial_map_to_numpy(imap) -> dict:
    """The port's ``InertialMap`` -> a dict of numpy: ``state`` (the JAX
    package's dtypes), ``kf_vel``, ``kf_bg``, ``kf_ba``, ``kf_prev``,
    ``kf_preint`` (numpy PreintStates or None) and ``kf_stamp``."""
    return dict(state=map_state_to_numpy(imap.state),
                kf_vel=to_numpy(imap.kf_vel), kf_bg=to_numpy(imap.kf_bg),
                kf_ba=to_numpy(imap.kf_ba), kf_prev=imap.kf_prev.copy(),
                kf_preint=[None if q is None else preint_to_numpy(q)
                           for q in imap.kf_preint],
                kf_stamp=imap.kf_stamp.copy())


def carry_inertial_state(src, dst) -> None:
    """Set an inertial system ``dst`` (the port's ``MonoInertialSlam`` or
    ``StereoInertialSlam``) to the inertial state of ``src``, an object with
    the JAX package's ``MonoInertialSlam`` attributes (numpy or JAX
    values): the chain (``kf_prev``), its preintegrations, stamps (a live
    keyframe's empty host stamp filled from the map's device stamp),
    velocities and biases, the body state, the frame bias, the carried
    prior, the IMU buffer, the schedule's flags, gates and counters,
    ``map_first_kf`` and the dispatched cull. The map, the counters and the
    frame context of ``MonoSlam`` are the caller's to carry."""
    dev = dst.device
    dst.kf_prev = np.asarray(src.kf_prev, np.int32).copy()
    # The port keeps every live keyframe's stamp on the host; the JAX
    # system fills its mirror from the device's float32 stamp when read.
    stamp = np.asarray(src.kf_stamp, np.float64).copy()
    lazy = np.isnan(stamp) & np.asarray(src.state.kfs.valid)
    stamp[lazy] = np.asarray(src.state.kfs.stamp)[lazy]
    dst.kf_stamp = stamp
    dst.kf_preint = [None if q is None else preint_to_torch(q, dev)
                     for q in src.kf_preint]
    for name in ("kf_vel", "kf_bg", "kf_ba"):
        setattr(dst, name, to_torch(getattr(src, name), dev))
    dst._body = (None if src._body is None
                 else tuple(to_torch(x, dev) for x in src._body))
    dst._bias = np.asarray(src._bias, np.float32).copy()
    dst._pose_prior_H = (None if src._pose_prior_H is None
                         else to_torch(src._pose_prior_H, dev))
    pend = getattr(src, "_pending_cull", None)
    dst._pending_cull = None if pend is None else to_torch(pend, dev)
    for name in ("imu_ready", "viba_stage", "_next_scale_refine",
                 "map_first_kf", "imu_init_prior", "imu_init_min_time",
                 "imu_init_min_kf", "imu_fix_scale", "_last_stamp"):
        setattr(dst, name, getattr(src, name))
    dst._imu_init_failures = getattr(src, "_imu_init_failures", 0)
    buf = dst.buf
    buf.n = src.buf.n
    buf.t = np.array(src.buf.t, np.float64)
    buf.gyr = np.array(src.buf.gyr, np.float32)
    buf.acc = np.array(src.buf.acc, np.float32)


# --- Place recognition -------------------------------------------------------

def vocabulary_to_torch(voc, device=None):
    """A vocabulary shaped as the JAX package's ``ops.bow.Vocabulary``
    (numpy or JAX arrays) -> the port's, on ``device`` (``None``: the
    card); node words become bit-identical int32."""
    from .ops import bow
    dev = device_mod.resolve(device)
    return bow.Vocabulary(
        to_torch(voc.node_desc, dev), to_torch(voc.children, dev),
        to_torch(voc.word_id, dev), to_torch(voc.idf, dev), int(voc.k),
        int(voc.depth), int(voc.n_words))


def vocabulary_to_numpy(voc) -> dict:
    """The port's vocabulary -> numpy arrays in the JAX package's dtypes
    (node words uint32), with ``k``, ``depth`` and ``n_words``."""
    return dict(node_desc=desc_to_uint32(voc.node_desc),
                children=to_numpy(voc.children),
                word_id=to_numpy(voc.word_id), idf=to_numpy(voc.idf),
                k=voc.k, depth=voc.depth, n_words=voc.n_words)


def keyframe_db_to_torch(db, voc):
    """A keyframe database with the JAX package's ``KeyframeDatabase``
    arrays (``vecs``, ``words``, ``valid``) -> the port's, on the device of
    ``voc`` (a port vocabulary)."""
    from .pipeline.keyframe_db import KeyframeDatabase
    out = KeyframeDatabase(voc, 1, 1)
    dev = voc.idf.device
    out.vecs, out.words, out.valid = (to_torch(a, dev) for a in
                                      (db.vecs, db.words, db.valid))
    return out


def keyframe_db_to_numpy(db) -> tuple:
    """The port's keyframe database -> (vecs, words, valid) numpy."""
    return to_numpy(db.vecs), to_numpy(db.words), to_numpy(db.valid)


def carry_loop_closer(src, dst) -> None:
    """Set the port's ``LoopCloser`` ``dst`` to the databases, the active
    map, the loop edges (measurements kept as numpy: ``close`` uploads
    them), the temporal streaks (the merge streak's other map, candidate,
    counts and Sim3 as numpy) and the 4-DoF switch of ``src``, an object
    with the JAX package's ``LoopCloser`` attributes."""
    dst.dbs = {m: keyframe_db_to_torch(db, dst.voc)
               for m, db in src.dbs.items()}
    dst.active = src.active
    dst.loop_edges = {m: list(e) for m, e in src.loop_edges.items()}
    dst._streak = (None if getattr(src, "_streak", None) is None
                   else dict(src._streak))
    ms_ = getattr(src, "_merge_streak", None)
    dst._merge_streak = (None if ms_ is None else dict(
        ms_, corr=(np.asarray(ms_["corr"][0], np.float32),
                   np.asarray(ms_["corr"][1], np.float32),
                   float(ms_["corr"][2]), int(ms_["corr"][3]))))
    dst.inertial_4dof = bool(getattr(src, "inertial_4dof", False))
