"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

The tier-1 run uses several pytest-xdist workers on one host, and torch
takes every core by default; each worker is capped at 2 threads.
Inputs are made with numpy and handed to both packages as numpy arrays.
"""

import numpy as np
import torch

from orbslam3_byzyh_tpu_torch import convert

torch.set_num_threads(2)


def t(x):
    """numpy / JAX array -> CPU tensor (uint32 words become int32 bits)."""
    return convert.to_torch(x, "cpu")


def n(x):
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def popcount_rows(a, b):
    """Per-row Hamming distance of two (K, 8) word arrays (any 32-bit type)."""
    x = np.asarray(a).view(np.uint32) ^ np.asarray(b).view(np.uint32)
    return np.unpackbits(x.view(np.uint8), axis=1).sum(1)


def small_mono_config():
    """The EuRoC-mono configuration cut for the CPU parity tests: half the
    image and intrinsics, 256 features, 2048 landmark and 64 keyframe slots,
    a 512-landmark window (the widths that set the behaviour: radtan
    coefficients, 8 levels at 1.2, 12 observations, 20 + 4 local
    keyframes, are EuRoC's)."""
    from orbslam3_byzyh_tpu_torch import graft
    return graft.MonoConfig(width=376, height=240, fx=229.327, fy=228.648,
                            cx=183.6075, cy=124.1875, n_features=256,
                            max_kf=64, max_lm=2048, n_local_lm=512)


def mono_scene(feats, cfg, case):
    """graft.euroc_mono_scene on numpy features (xy, level, desc, angle,
    valid), with 48 live keyframes."""
    from orbslam3_byzyh_tpu_torch import graft
    return graft.euroc_mono_scene(*feats, cfg=cfg, case=case, n_live_kf=48)


def small_map_config():
    """The EuRoC-mono configuration cut for the keyframe-step parity tests:
    half the image and intrinsics, 256 features, 32 keyframe and 2048
    landmark slots, 8 observations a landmark, a BA window of 5 free and 12
    keyframes in all with 256 landmarks (below the free keyframes' own, so
    the cut is engaged), triangulation against 3 neighbours."""
    from orbslam3_byzyh_tpu_torch import graft
    return graft.MonoConfig(width=376, height=240, fx=229.327, fy=228.648,
                            cx=183.6075, cy=124.1875, n_features=256,
                            max_kf=32, max_lm=2048, max_obs=8,
                            local_window=4, ba_window=12, ba_lm_window=256)


# graft.euroc_mono_map at the small configuration: 24 live keyframes,
# about 600 points in each view.
SMALL_MAP_KW = dict(n_live_kf=24, view_points=600)


def small_map(case="normal", seed=0):
    from orbslam3_byzyh_tpu_torch import graft
    return graft.euroc_mono_map(small_map_config(), case=case, seed=seed,
                                **SMALL_MAP_KW)


def jax_map_state(state_np):
    """A numpy map state (the JAX package's dtypes) -> the JAX package's
    MapState."""
    import jax.numpy as jnp

    from orbslam3_byzyh_tpu.models import map_state as jms
    return jms.MapState(
        kfs=jms.KeyFrames(*(jnp.asarray(a) for a in state_np.kfs)),
        lms=jms.Landmarks(*(jnp.asarray(a) for a in state_np.lms)),
        obs=jms.Observations(*(jnp.asarray(a) for a in state_np.obs)))


def jax_feats(feats_np):
    """numpy FrameFeatures (desc uint32) -> the JAX package's."""
    import jax.numpy as jnp

    from orbslam3_byzyh_tpu.ops import fast_orb as jfo
    return jfo.FrameFeatures(*(jnp.asarray(a) for a in feats_np))


def reprojection_gap(ref, got, cam_params, rows):
    """Per landmark row: the largest distance in pixels between the
    projections of ``ref``'s and ``got``'s positions into the keyframes
    that observe it in ``ref`` (``ref``'s poses)."""
    fx, fy, cx, cy = np.asarray(cam_params, np.float64)
    okf = np.maximum(ref.obs.kf[rows], 0)
    oval = ref.obs.valid[rows] & (ref.obs.kf[rows] >= 0)
    R = ref.kfs.R[okf].astype(np.float64)
    t = ref.kfs.t[okf].astype(np.float64)
    gap = np.zeros(len(rows))
    for pos in (ref.lms.pos, got.lms.pos):
        pc = np.einsum("loij,lj->loi", R, pos[rows].astype(np.float64)) + t
        uv = np.stack([fx * pc[..., 0] / pc[..., 2] + cx,
                       fy * pc[..., 1] / pc[..., 2] + cy], -1)
        gap = uv if gap.ndim == 1 else np.linalg.norm(uv - gap, axis=-1)
    return np.where(oval, gap, 0.0).max(-1)


def assert_states_close(ref, got, cam_params, pos_atol=1e-3,
                        pose_atol=1e-4, px_atol=1e-2):
    """Two map states (numpy leaves, either package): every integer and
    bool array equal, descriptors bit-equal; keyframe poses within
    ``pose_atol``, ranges within ``pos_atol`` relative, normals within 1e-4,
    live landmark positions within ``pos_atol`` m. A live landmark beyond
    that must still project within ``px_atol`` px in every keyframe that
    observes it: the BA decides each LM step on a cost comparison, and
    where two costs agree to float32 rounding the packages may take
    different steps, which moves poorly constrained (low-parallax, two-view)
    points along their ray. Such rows are printed. Dead rows are not
    compared."""
    for group in ("kfs", "lms", "obs"):
        a, b = getattr(ref, group), getattr(got, group)
        for name in a._fields:
            x = np.asarray(getattr(a, name))
            y = np.asarray(getattr(b, name))
            what = f"{group}.{name}"
            if x.dtype.kind != "f":
                np.testing.assert_array_equal(y.view(x.dtype), x, err_msg=what)
            elif name in ("R", "t"):
                np.testing.assert_allclose(y, x, atol=pose_atol, err_msg=what)
            elif name in ("min_dist", "max_dist"):
                np.testing.assert_allclose(y, x, rtol=pos_atol, err_msg=what)
            elif name == "normal":
                np.testing.assert_allclose(y, x, atol=1e-4, err_msg=what)
            elif name != "pos":
                np.testing.assert_array_equal(y, x, err_msg=what)
    live = np.flatnonzero(ref.lms.valid)
    diff = np.abs(got.lms.pos[live] - ref.lms.pos[live]).max(-1)
    far = live[diff > pos_atol]
    if len(far):
        gap = reprojection_gap(ref, got, cam_params, far)
        print(f"{len(far)} of {len(live)} live landmarks beyond {pos_atol} m "
              f"(at most {diff.max():.2e} m); their reprojections within "
              f"{gap.max():.2e} px")
        assert gap.max() <= px_atol, (far[np.argmax(gap)], gap.max())


def triangulation_margins(X, Ra, ta, Rb, tb, xy_a, xy_b, level_a, level_b,
                          cam_params):
    """Per row, recomputed in float64 from the triangulated points X (N, 3):
    the smallest relative distance of any of ``triangulate_pair``'s gates
    (depth in both views, chi2 5.991 in both, the scale ratio's two bounds,
    parallax cos 0.9998) to its threshold. A row whose decision differs
    between the packages must show a margin within float32 rounding."""
    f = lambda a: np.asarray(a, np.float64)
    X, Ra, ta, Rb, tb = f(X), f(Ra), f(ta), f(Rb), f(tb)
    xy_a, xy_b = f(xy_a), f(xy_b)
    fx, fy, cx, cy = f(cam_params)
    la, lb = np.asarray(level_a), np.asarray(level_b)
    margins = []
    for R, t, xo, lv in ((Ra, ta, xy_a, la), (Rb, tb, xy_b, lb)):
        pc = X @ R.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        chi2 = ((uv - xo) ** 2).sum(-1) / 1.2 ** (2 * lv)
        margins += [np.abs(pc[:, 2]) / np.linalg.norm(X, axis=-1),
                    np.abs(chi2 - 5.991) / 5.991]
    ca, cb = -Ra.T @ ta, -Rb.T @ tb
    da = np.linalg.norm(X - ca, axis=-1)
    db = np.linalg.norm(X - cb, axis=-1)
    octave = 1.2 ** (la - lb).astype(np.float64)
    ratio = da / db
    for bound in (octave * 1.8, octave / 1.8):
        margins.append(np.abs(ratio - bound) / bound)
    cos = (((X - ca) / da[:, None]) * ((X - cb) / db[:, None])).sum(-1)
    margins.append(np.abs(cos - 0.9998) / 0.9998)
    return np.min(margins, axis=0)


def plant_ur(state, rng, bf, share=0.6):
    """A numpy map state with ``kp_ur`` planted: each observed keypoint of a
    live landmark gets u - bf / z from the landmark's depth in its keyframe
    (noise 0.3 px) with probability ``share``; the rest keep -1."""
    kfs, lms, obs = state.kfs, state.lms, state.obs
    live = obs.valid & (obs.kf >= 0) & lms.valid[:, None]
    rows, cols = np.nonzero(live)
    kf, kp = obs.kf[rows, cols], obs.kp[rows, cols]
    pc = np.einsum("nij,nj->ni", kfs.R[kf], lms.pos[rows]) + kfs.t[kf]
    ur = kfs.kp_xy[kf, kp, 0] - bf / pc[:, 2] + rng.normal(0, 0.3, len(kf))
    keep = (rng.random(len(kf)) < share) & (pc[:, 2] > 0.1)
    kp_ur = kfs.kp_ur.copy()
    kp_ur[kf[keep], kp[keep]] = ur[keep]
    return state._replace(kfs=kfs._replace(kp_ur=kp_ur.astype(np.float32)))
