"""Functional map state: fixed-capacity NamedTuples of tensors.

Port of ``orbslam3_byzyh_tpu/models/map_state.py`` (the parts the
monocular system uses). Keyframes, landmarks and the
landmark-major (L, O) observation table are tensors with liveness masks;
"deletion" clears a mask. Every function returns a new state and never
writes into the tensors it was given, as the JAX package's functions do.
Descriptors are (..., 8) int32 words holding the JAX package's uint32 bits.

The JAX package's drop-mode scatters (a write at an out-of-range index is
dropped) become writes into a copy padded with one spare row, which is then
sliced off (:func:`scatter_rows`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod


class KeyFrames(NamedTuple):
    R: torch.Tensor           # (K, 3, 3) world->cam
    t: torch.Tensor           # (K, 3)
    stamp: torch.Tensor       # (K,)
    kp_xy: torch.Tensor       # (K, N, 2) undistorted level-0 pixels
    kp_level: torch.Tensor    # (K, N) int32
    kp_angle: torch.Tensor    # (K, N)
    kp_desc: torch.Tensor     # (K, N, 8) int32 words
    kp_valid: torch.Tensor    # (K, N) bool
    kp_ur: torch.Tensor       # (K, N) right-image u, -1 = mono
    valid: torch.Tensor       # (K,) liveness


class Landmarks(NamedTuple):
    pos: torch.Tensor         # (L, 3)
    desc: torch.Tensor        # (L, 8) int32 words
    normal: torch.Tensor      # (L, 3) mean viewing direction
    min_dist: torch.Tensor    # (L,) scale-invariance range
    max_dist: torch.Tensor    # (L,)
    n_obs: torch.Tensor       # (L,) int32
    n_found: torch.Tensor     # (L,) int32
    n_visible: torch.Tensor   # (L,) int32
    first_kf: torch.Tensor    # (L,) int32 creating keyframe
    valid: torch.Tensor       # (L,) liveness


class Observations(NamedTuple):
    kf: torch.Tensor          # (L, O) int32 keyframe index, -1 empty
    kp: torch.Tensor          # (L, O) int32 keypoint index within that KF
    valid: torch.Tensor       # (L, O) bool


class MapState(NamedTuple):
    kfs: KeyFrames
    lms: Landmarks
    obs: Observations


def _values(values, like: torch.Tensor, shape) -> torch.Tensor:
    """``values`` as a tensor of ``like``'s dtype broadcast to ``shape``. A
    Python scalar becomes a fill on the device, not a copy from the host
    (which would synchronise the stream)."""
    if isinstance(values, torch.Tensor):
        return values.to(like.dtype).expand(shape)
    return torch.full(shape, values, dtype=like.dtype, device=like.device)


def slot_index(slot, device) -> torch.Tensor:
    """A keyframe slot (a Python int or a 0-d tensor) as a (1,) int64
    index on ``device``, made without a host copy."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(slot), dtype=torch.int64, device=device)


def scatter_rows(x: torch.Tensor, idx: torch.Tensor, values,
                 accumulate: bool = False) -> torch.Tensor:
    """``x.at[idx].set(values, mode="drop")`` (or ``.add``) for indices in
    [0, len(x)]: index ``len(x)`` is the drop sentinel. Returns a new
    tensor; ``x`` is not written."""
    pad = torch.cat([x, x[:1]], 0)
    vals = _values(values, x, idx.shape + x.shape[1:])
    if accumulate:
        # index_add_, not index_put_(accumulate=True): on CUDA the latter
        # sorts the indices first (about 3 ms at 65536 rows on an H100).
        pad.index_add_(0, idx.long(), vals)
    else:
        pad.index_put_((idx.long(),), vals)
    return pad[:-1]


def scatter_cells(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  values) -> torch.Tensor:
    """``x.at[rows, cols].set(values, mode="drop")`` with row ``len(x)`` as
    the drop sentinel."""
    pad = torch.cat([x, x[:1]], 0)
    pad.index_put_((rows.long(), cols.long()),
                   _values(values, x, rows.shape + x.shape[2:]))
    return pad[:-1]


def empty_map(max_kf: int, max_lm: int, max_obs: int, n_feat: int,
              device=None) -> MapState:
    """An empty map of the given capacities on ``device`` (``None``: the
    card; raises without one, see :func:`device.resolve`)."""
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=device_mod.resolve(device))
    kfs = KeyFrames(
        R=torch.eye(3, dtype=f32, **kw).repeat(max_kf, 1, 1),
        t=torch.zeros((max_kf, 3), dtype=f32, **kw),
        stamp=torch.zeros((max_kf,), dtype=f32, **kw),
        kp_xy=torch.zeros((max_kf, n_feat, 2), dtype=f32, **kw),
        kp_level=torch.zeros((max_kf, n_feat), dtype=i32, **kw),
        kp_angle=torch.zeros((max_kf, n_feat), dtype=f32, **kw),
        kp_desc=torch.zeros((max_kf, n_feat, 8), dtype=i32, **kw),
        kp_valid=torch.zeros((max_kf, n_feat), dtype=torch.bool, **kw),
        kp_ur=torch.full((max_kf, n_feat), -1.0, dtype=f32, **kw),
        valid=torch.zeros((max_kf,), dtype=torch.bool, **kw))
    lms = Landmarks(
        pos=torch.zeros((max_lm, 3), dtype=f32, **kw),
        desc=torch.zeros((max_lm, 8), dtype=i32, **kw),
        normal=torch.zeros((max_lm, 3), dtype=f32, **kw),
        min_dist=torch.zeros((max_lm,), dtype=f32, **kw),
        max_dist=torch.full((max_lm,), 1e9, dtype=f32, **kw),
        n_obs=torch.zeros((max_lm,), dtype=i32, **kw),
        n_found=torch.zeros((max_lm,), dtype=i32, **kw),
        n_visible=torch.zeros((max_lm,), dtype=i32, **kw),
        first_kf=torch.zeros((max_lm,), dtype=i32, **kw),
        valid=torch.zeros((max_lm,), dtype=torch.bool, **kw))
    obs = Observations(
        kf=torch.full((max_lm, max_obs), -1, dtype=i32, **kw),
        kp=torch.full((max_lm, max_obs), -1, dtype=i32, **kw),
        valid=torch.zeros((max_lm, max_obs), dtype=torch.bool, **kw))
    return MapState(kfs=kfs, lms=lms, obs=obs)


def _set_row(x: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``x.at[slot].set(value)``; ``idx`` is :func:`slot_index`'s (1,)."""
    return x.index_put((idx,), _values(value, x, (1,) + x.shape[1:]))


def add_keyframe(state: MapState, slot, R, t, stamp, feats,
                 ur=None) -> MapState:
    """Write a keyframe into ``slot`` (a Python int or a 0-d tensor).
    ``feats`` has ``xy``, ``level``, ``angle``, ``desc``, ``valid``; ``ur``
    is the optional (N,) right-image u (-1 = monocular)."""
    kfs = state.kfs
    if ur is None:
        ur = torch.full((kfs.kp_ur.shape[1],), -1.0, device=kfs.kp_ur.device)
    slot = slot_index(slot, kfs.R.device)
    kfs = KeyFrames(
        R=_set_row(kfs.R, slot, R), t=_set_row(kfs.t, slot, t),
        stamp=_set_row(kfs.stamp, slot, stamp),
        kp_xy=_set_row(kfs.kp_xy, slot, feats.xy),
        kp_level=_set_row(kfs.kp_level, slot, feats.level),
        kp_angle=_set_row(kfs.kp_angle, slot, feats.angle),
        kp_desc=_set_row(kfs.kp_desc, slot, feats.desc),
        kp_valid=_set_row(kfs.kp_valid, slot, feats.valid),
        kp_ur=_set_row(kfs.kp_ur, slot, ur),
        valid=_set_row(kfs.valid, slot, True))
    return state._replace(kfs=kfs)


def add_landmarks(state: MapState, slots, pos, desc, kf_a, kp_a, kf_b, kp_b,
                  mask, normal, min_dist, max_dist) -> MapState:
    """Create landmarks at ``slots`` (rows where ``mask``) with two initial
    observations each, (kf_a, kp_a) and (kf_b, kp_b). The whole observation
    row is cleared first: a recycled slot may hold its previous occupant's
    observations. kf_a / kf_b: scalars or (M,)."""
    lms, obs = state.lms, state.obs
    L = lms.pos.shape[0]
    safe = torch.where(mask, slots, L)
    kf_a = _values(kf_a, obs.kf, kp_a.shape)
    kf_b = _values(kf_b, obs.kf, kp_b.shape)
    lms = Landmarks(
        pos=scatter_rows(lms.pos, safe, pos),
        desc=scatter_rows(lms.desc, safe, desc),
        normal=scatter_rows(lms.normal, safe, normal),
        min_dist=scatter_rows(lms.min_dist, safe, min_dist),
        max_dist=scatter_rows(lms.max_dist, safe, max_dist),
        n_obs=scatter_rows(lms.n_obs, safe, 2),
        n_found=scatter_rows(lms.n_found, safe, 1),
        n_visible=scatter_rows(lms.n_visible, safe, 1),
        first_kf=scatter_rows(lms.first_kf, safe, kf_a),
        valid=scatter_rows(lms.valid, safe, True))
    O = obs.kf.shape[1]

    def row(a, b):                     # (M, O): a, b, then -1
        pad = torch.full(safe.shape + (O - 2,), -1, dtype=torch.int32,
                         device=safe.device)
        return torch.cat([a[:, None], b[:, None], pad], 1)

    head = torch.arange(O, device=safe.device) < 2
    obs = Observations(
        kf=scatter_rows(obs.kf, safe, row(kf_a, kf_b)),
        kp=scatter_rows(obs.kp, safe, row(kp_a.to(torch.int32),
                                          kp_b.to(torch.int32))),
        valid=scatter_rows(obs.valid, safe, head.expand(safe.shape + (O,))))
    return state._replace(lms=lms, obs=obs)


def first_true(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool tensor along its last axis: the first True,
    0 where there is none."""
    return torch.argmax(x.to(torch.int8), dim=-1)


def add_observations(state: MapState, lm_idx, kf_id, kp_idx,
                     mask) -> MapState:
    """Append (kf_id, kp_idx) observations to the landmarks ``lm_idx`` at
    the first free slot of each row (rows where ``mask`` and a slot is
    free)."""
    obs = state.obs
    L = state.lms.pos.shape[0]
    free = ~obs.valid[lm_idx]                          # (M, O)
    slot = first_true(free)
    has_free = free.gather(1, slot[:, None])[:, 0]
    ok = mask & has_free
    safe_lm = torch.where(ok, lm_idx, L)
    kf_id = _values(kf_id, obs.kf, kp_idx.shape)
    obs = Observations(
        kf=scatter_cells(obs.kf, safe_lm, slot, kf_id),
        kp=scatter_cells(obs.kp, safe_lm, slot, kp_idx.to(torch.int32)),
        valid=scatter_cells(obs.valid, safe_lm, slot, True))
    ones = torch.ones_like(safe_lm, dtype=torch.int32)
    lms = state.lms._replace(
        n_obs=scatter_rows(state.lms.n_obs, safe_lm, ones, accumulate=True))
    return state._replace(obs=obs, lms=lms)


def covisibility_counts(state: MapState, kf_id, max_kf: int) -> torch.Tensor:
    """(max_kf,) int32: landmarks shared between ``kf_id`` and every other
    keyframe (one segmented count over the observation table)."""
    okf, oval = state.obs.kf, state.obs.valid
    sees_q = (okf == kf_id) & oval
    lm_in_q = sees_q.any(-1) & state.lms.valid
    contrib = lm_in_q[:, None] & oval & (okf != kf_id)
    flat = torch.where(contrib, okf, max_kf).reshape(-1).long()
    counts = torch.zeros(max_kf + 1, dtype=torch.int32, device=okf.device)
    counts = counts.index_add(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[:max_kf]


def covisibility_matrix(state: MapState, lm_valid=None) -> torch.Tensor:
    """(K, K) int32 pairwise shared-landmark counts, zero on the diagonal
    (the JAX package's ``covisibility_matrix``, which builds an (L, K)
    one-hot indicator and multiplies it by itself: 137 GFLOP at 65536 x
    1024). Here each live landmark adds one to the cell of every ordered
    pair of distinct keyframes among its observations: one ``index_add_``
    of L x O x O cells (9.4 M at 65536 x 12 x 12). A keyframe that
    observes a landmark twice counts once, as the indicator's min(., 1)
    makes it. ``lm_valid`` (L,): the landmarks that count (by default the
    live ones)."""
    K = state.kfs.valid.shape[0]
    kf, L, O = state.obs.kf, *state.obs.kf.shape
    dev = kf.device
    if lm_valid is None:
        lm_valid = state.lms.valid
    ov = state.obs.valid & (kf >= 0) & lm_valid[:, None]
    same = (kf[:, :, None] == kf[:, None, :]) & ov[:, None, :]
    earlier = torch.ones(O, O, dtype=torch.bool, device=dev).tril(-1)
    first = ov & ~(same & earlier).any(-1)         # first slot of each kf
    pair = (first[:, :, None] & first[:, None, :]
            & ~torch.eye(O, dtype=torch.bool, device=dev))
    kf64 = kf.to(torch.int64)
    # A cell that is no pair adds 0 at an index of its own (its position,
    # modulo K x K): a shared sentinel bin would serialise the atomics.
    spread = torch.arange(L * O * O, device=dev).reshape(L, O, O) % (K * K)
    cell = torch.where(pair, kf64[:, :, None] * K + kf64[:, None, :], spread)
    counts = torch.zeros(K * K, dtype=torch.int32, device=dev)
    counts.index_add_(0, cell.reshape(-1), pair.reshape(-1).to(torch.int32))
    return counts.reshape(K, K)


def landmarks_seen_by(state: MapState, kf_id):
    """(L,) bool mask and (L,) keypoint index (-1 elsewhere) of the
    landmarks that ``kf_id`` observes."""
    hit = (state.obs.kf == kf_id) & state.obs.valid
    seen = hit.any(-1) & state.lms.valid
    slot = first_true(hit)
    kp = state.obs.kp.gather(1, slot[:, None])[:, 0]
    return seen, torch.where(seen, kp, -1)


def compact_keyframes(state: MapState, n_kf: int):
    """Renumber the live keyframes down to slots [0, n_valid), in id (=
    temporal) order, and remap every keyframe reference in the state: the
    slot recycling of a fixed-capacity map whose culling only clears masks.
    One host read (the keyframes' liveness and the landmarks' creating
    keyframe) and one upload; the keyframe rows move by gathers only.

    Returns ``(state', old2new (K,) int32 numpy array, n_valid)``; dead old
    ids map to -1."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    dev = kfs.valid.device
    max_kf, max_lm = kfs.valid.shape[0], lms.valid.shape[0]
    kf_valid, first_old = device_mod.read(kfs.valid, lms.first_kf,
                                          dtype=torch.int64)
    old_ids = np.flatnonzero(kf_valid)          # ascending == temporal
    m = len(old_ids)
    old2new = np.full(max_kf, -1, np.int32)
    old2new[old_ids] = np.arange(m, dtype=np.int32)
    gather = np.zeros(max_kf, np.int64)
    gather[:m] = old_ids
    # first_kf may name a culled keyframe (its creator died, the landmark
    # lives): it moves to the nearest surviving predecessor.
    first_new = np.clip(np.searchsorted(old_ids, first_old, "right") - 1, 0,
                        None)
    g, o2n, first_kf = torch.split(device_mod.upload(np.concatenate(
        [gather, old2new, first_new]), dev), [max_kf, max_kf, max_lm])
    live = torch.arange(max_kf, device=dev) < m

    def rows(x):
        return x.index_select(0, g)

    kfs = KeyFrames(
        R=rows(kfs.R), t=rows(kfs.t), stamp=rows(kfs.stamp),
        kp_xy=rows(kfs.kp_xy), kp_level=rows(kfs.kp_level),
        kp_angle=rows(kfs.kp_angle), kp_desc=rows(kfs.kp_desc),
        kp_valid=rows(kfs.kp_valid) & live[:, None], kp_ur=rows(kfs.kp_ur),
        valid=rows(kfs.valid) & live)
    okf_new = torch.where(obs.kf >= 0,
                          o2n.to(torch.int32)[obs.kf.clamp_min(0).long()], -1)
    oval = obs.valid & (okf_new >= 0)
    obs = Observations(kf=torch.where(oval, okf_new, -1),
                       kp=torch.where(oval, obs.kp, -1), valid=oval)
    lms = lms._replace(first_kf=first_kf.to(torch.int32),
                       n_obs=oval.sum(-1).to(torch.int32))
    return MapState(kfs=kfs, lms=lms, obs=obs), old2new, m


def compact_landmarks(state: MapState, n_lm: int):
    """Renumber the live landmarks down to [0, n_valid), in creation order,
    so culled landmark slots are recycled; the observation table is
    landmark-major, so this is a row gather. One host read and one upload.
    Returns ``(state', old2new (L,) int32 numpy array, n_valid)``."""
    lms, obs = state.lms, state.obs
    dev = lms.valid.device
    max_lm = lms.valid.shape[0]
    old_ids = np.flatnonzero(device_mod.read(lms.valid)[0])
    m = len(old_ids)
    old2new = np.full(max_lm, -1, np.int32)
    old2new[old_ids] = np.arange(m, dtype=np.int32)
    gather = np.zeros(max_lm, np.int64)
    gather[:m] = old_ids
    g = device_mod.upload(gather, dev)
    live = torch.arange(max_lm, device=dev) < m

    def rows(x):
        return x.index_select(0, g)

    lms = Landmarks(
        pos=rows(lms.pos), desc=rows(lms.desc), normal=rows(lms.normal),
        min_dist=rows(lms.min_dist), max_dist=rows(lms.max_dist),
        n_obs=rows(lms.n_obs), n_found=rows(lms.n_found),
        n_visible=rows(lms.n_visible), first_kf=rows(lms.first_kf),
        valid=rows(lms.valid) & live)
    obs = Observations(kf=torch.where(live[:, None], rows(obs.kf), -1),
                       kp=torch.where(live[:, None], rows(obs.kp), -1),
                       valid=rows(obs.valid) & live[:, None])
    return state._replace(lms=lms, obs=obs), old2new, m


def check_invariants(state: MapState, n_kf: int, n_lm: int) -> list:
    """Consistency checks over the map (host side, for tests and
    post-mortems). Returns a list of violation strings; empty means
    consistent."""
    errs = []
    kfs, lms, obs = state.kfs, state.lms, state.obs

    def np_(x):
        return x.detach().cpu().numpy()

    kf_valid, lm_valid = np_(kfs.valid), np_(lms.valid)
    okf, okp, oval = np_(obs.kf), np_(obs.kp), np_(obs.valid)
    if kf_valid[:n_kf].sum() == 0 and n_kf > 0:
        errs.append(f"no valid keyframes among the first {n_kf} slots")
    if kf_valid[n_kf:].any():
        errs.append("keyframe liveness beyond the host cursor")
    if lm_valid[n_lm:].any():
        errs.append("landmark liveness beyond the host cursor")
    live_obs = oval & (okf >= 0)
    bad_kf = live_obs & ~kf_valid[np.maximum(okf, 0)]
    if bad_kf.any():
        errs.append(f"{int(bad_kf.sum())} observations point at dead "
                    "keyframes")
    n_feat = kfs.kp_valid.shape[1]
    if (live_obs & ((okp < 0) | (okp >= n_feat))).any():
        errs.append("observation keypoint index out of range")
    starved = lm_valid & (live_obs.sum(-1) == 0)
    if starved.any():
        errs.append(f"{int(starved.sum())} live landmarks with zero "
                    "observations")
    R = np_(kfs.R)[kf_valid]
    if len(R):
        rtr = np.einsum("kij,kil->kjl", R, R)
        eye_err = np.abs(rtr - np.eye(3)).max()
        if eye_err > 1e-2:
            errs.append(f"keyframe rotation drifted off SO(3): |R^TR - I| "
                        f"max {eye_err:.2e}")
        if (np.linalg.det(R) < 0.5).any():
            errs.append("keyframe rotation with non-positive determinant")
    if not np.isfinite(np_(lms.pos)[lm_valid]).all():
        errs.append("non-finite landmark positions")
    return errs
