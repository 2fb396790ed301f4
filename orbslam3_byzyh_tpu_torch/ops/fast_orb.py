"""ORB feature extraction: pyramid FAST + steered BRIEF.

Port of ``orbslam3_byzyh_tpu/ops/fast_orb.py`` in plain PyTorch forms:
bilinear resize by ``F.interpolate``, the Gaussian blur and the IC_Angle
moments by ``conv2d``, NMS by ``max_pool2d``, and per-tile selection by a
stable sort (ties go to the lower index, as ``jax.lax.top_k`` and the
reference's iterative argmax do). The BRIEF sampling and packing of all
levels is one call to :func:`cuda_brief.brief_descriptors` (kernel K1).

Behaviour constants: PATCH=31/HALF=15, EDGE=19, FAST radius 3 with the
20 -> 7 threshold fallback per 35 px cell, 8 levels at scale 1.2, the
geometric per-level feature budget, 32 px selection tiles.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19
FAST_RADIUS = 3
INI_TH_FAST = 20.0
MIN_TH_FAST = 7.0
TILE = 32

# bit_pattern_31_ (256 point pairs: ax, ay, bx, by): the port's own copy,
# byte-identical to the JAX package's.
_PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "orb_pattern.npy")
PATTERN = np.load(_PATTERN_PATH).astype(np.float32)     # (256, 4)

# Bresenham circle r=3, 16 px, contiguous order (dx, dy).
_CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
           (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
           (-1, -3))


def _umax_table() -> np.ndarray:
    """Circular-patch half-widths for IC_Angle."""
    umax = np.zeros(HALF_PATCH_SIZE + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH_SIZE * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH_SIZE * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH_SIZE ** 2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH_SIZE, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _moment_kernels() -> np.ndarray:
    """(2, 1, 31, 31) conv weights: x*disc (m10) and y*disc (m01)."""
    umax = _umax_table()
    k = np.zeros((2, 1, PATCH_SIZE, PATCH_SIZE), np.float32)
    for v in range(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1):
        half = umax[abs(v)]
        for u in range(-half, half + 1):
            k[0, 0, v + HALF_PATCH_SIZE, u + HALF_PATCH_SIZE] = u
            k[1, 0, v + HALF_PATCH_SIZE, u + HALF_PATCH_SIZE] = v
    return k


_MOMENTS = _moment_kernels()


def _gauss_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = np.arange(ksize) - ksize // 2
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_GAUSS1D = _gauss_kernel_1d()


@functools.cache
def _constants(device: torch.device) -> dict:
    """The blur taps, moment kernels and BRIEF pattern, copied to
    ``device`` once: a copy from pageable host memory synchronises the
    stream, which would stall the host on every level of every frame."""
    return {
        "gauss": torch.from_numpy(_GAUSS1D).to(device),
        "moments": torch.from_numpy(_MOMENTS).to(device),
        # (256, 4): ax, ay, bx, by of each pair (K1 reads a row as a float4).
        "pattern": torch.from_numpy(PATTERN).to(device),
    }


class FrameFeatures(NamedTuple):
    """All-level features in level-0 coordinates."""

    xy: torch.Tensor        # (N, 2) float32
    level: torch.Tensor     # (N,) int32 octave
    angle: torch.Tensor     # (N,) radians
    response: torch.Tensor  # (N,)
    desc: torch.Tensor      # (N, 8) int32 words (the JAX package's uint32 bits)
    valid: torch.Tensor     # (N,) bool


def level_sizes(h: int, w: int, n_levels: int, scale: float):
    out = []
    for lv in range(n_levels):
        s = scale ** lv
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def level_feature_budget(n_features: int, n_levels: int, scale: float):
    """Geometric per-level split (ORBextractor constructor)."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    budget, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n_first * factor ** lv))
        budget.append(b)
        total += b
    budget.append(max(n_features - total, 0))
    return budget


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float):
    """img: (H, W) float32. Chain of bilinear resizes (pixel-centre
    convention, cv::resize INTER_LINEAR)."""
    sizes = level_sizes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        x = F.interpolate(levels[-1][None, None], size=sizes[lv],
                          mode="bilinear", align_corners=False)
        levels.append(x[0, 0])
    return levels


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 corner score (OpenCV cornerScore semantics)."""
    h, w = img.shape
    r = FAST_RADIUS
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    d = torch.stack([pad[r + dy:r + dy + h, r + dx:r + dx + w] - img
                     for dx, dy in _CIRCLE], 0)             # (16, H, W)

    def arc_min9(x):
        # min over 9 consecutive circle entries, for every start index.
        m = torch.minimum(x, torch.roll(x, -1, 0))
        m = torch.minimum(m, torch.roll(m, -2, 0))
        m = torch.minimum(m, torch.roll(m, -4, 0))
        m = torch.minimum(m, torch.roll(x, -8, 0))
        return m.amax(0)

    score = torch.maximum(arc_min9(d), arc_min9(-d)) - 1.0
    return score.clamp_min(0.0)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def _cell_threshold(score: torch.Tensor, cell: int = 35) -> torch.Tensor:
    """Keep >= 20 in cells that have such a corner, else >= 7."""
    h, w = score.shape
    s = F.pad(score, (0, -w % cell, 0, -h % cell))
    ht, wt = s.shape[0] // cell, s.shape[1] // cell
    cell_max = s.reshape(ht, cell, wt, cell).amax(dim=(1, 3))
    thr = torch.where(cell_max >= INI_TH_FAST, INI_TH_FAST, MIN_TH_FAST)
    thr_map = thr.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(score >= thr_map, score, torch.zeros_like(score))


def _border_mask(score: torch.Tensor, border: int) -> torch.Tensor:
    out = torch.zeros_like(score)
    out[border:score.shape[0] - border, border:score.shape[1] - border] = \
        score[border:score.shape[0] - border, border:score.shape[1] - border]
    return out


def select_keypoints(score: torch.Tensor, capacity: int, k_per_tile: int = 8):
    """Spatially distributed top-``capacity`` selection: the best
    ``k_per_tile`` of each TILE x TILE tile, then the best ``capacity`` of
    those. Returns xy (capacity, 2) float32, response and valid."""
    h, w = score.shape
    s = F.pad(score, (0, -w % TILE, 0, -h % TILE))
    nty, ntx = s.shape[0] // TILE, s.shape[1] // TILE
    tiles = s.reshape(nty, TILE, ntx, TILE).permute(0, 2, 1, 3)
    tiles = tiles.reshape(nty * ntx, TILE * TILE)
    while nty * ntx * k_per_tile < capacity:
        k_per_tile *= 2
    k_per_tile = min(k_per_tile, TILE * TILE)
    vals, idx = torch.sort(tiles, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_per_tile], idx[:, :k_per_tile]
    tile = torch.arange(nty * ntx, device=score.device)[:, None]
    py = ((tile // ntx) * TILE + idx // TILE).reshape(-1)
    px = ((tile % ntx) * TILE + idx % TILE).reshape(-1)
    top_vals, top_i = torch.sort(vals.reshape(-1), descending=True, stable=True)
    top_vals, top_i = top_vals[:capacity], top_i[:capacity]
    xy = torch.stack([px[top_i], py[top_i]], -1).to(torch.float32)
    return xy, top_vals, top_vals > 0.0


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 separable Gaussian with edge padding."""
    k = _constants(img.device)["gauss"]
    r = len(_GAUSS1D) // 2
    x = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x[0, 0]


def orientation_maps(img: torch.Tensor):
    """Dense IC_Angle moments (m10, m01) over the radius-15 disc, with the
    image zero-padded outside its border."""
    k = _constants(img.device)["moments"]
    x = F.pad(img[None, None], (HALF_PATCH_SIZE,) * 4)
    m = F.conv2d(x, k)[0]
    return m[0], m[1]


def _pattern_positions(xy, ca, sa, w, h):
    """Global (gy, gx) int32 positions, (K, 512) each, of the rotated BRIEF
    samples (A pattern then B pattern), clamped to the image.

    Rotation: col = round(px*cos - py*sin), row = round(px*sin + py*cos),
    rounding half to even; the centre is rounded too. ``w``/``h`` are
    float tensors broadcastable to (K, 1): each keypoint's level size."""
    pat = _constants(xy.device)["pattern"]
    # (1, 512): the A points of the 256 pairs, then the B points.
    px = torch.cat([pat[:, 0], pat[:, 2]])[None]
    py = torch.cat([pat[:, 1], pat[:, 3]])[None]
    ca, sa = ca[:, None], sa[:, None]
    col = torch.round(px * ca - py * sa)
    row = torch.round(px * sa + py * ca)
    gx = torch.minimum((torch.round(xy[:, 0:1]) + col).clamp_min(0), w - 1)
    gy = torch.minimum((torch.round(xy[:, 1:2]) + row).clamp_min(0), h - 1)
    return gy.to(torch.int32), gx.to(torch.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words; bit i of word w is bit 32w+i."""
    k = bits.shape[0]
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = (bits.reshape(k, 8, 32).to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def extract(img: torch.Tensor, n_features: int = 1024, n_levels: int = 8,
            scale: float = 1.2) -> FrameFeatures:
    """Full ORB extraction. img: (H, W) float32 grayscale in [0, 255].

    Returns FrameFeatures with capacity ``n_features`` (padded, masked).
    """
    from . import cuda_brief

    dev = device_mod.resolve(img.device)
    img = img.to(torch.float32)
    pyr = build_pyramid(img, n_levels, scale)
    budget = level_feature_budget(n_features, n_levels, scale)

    xs, lvls, angs, resps, valids = [], [], [], [], []
    blurred, level_xy, level_idx = [], [], []
    for lv, lvl_img in enumerate(pyr):
        cap = budget[lv]
        if cap == 0:
            continue
        score = fast_score_map(lvl_img)
        score = _border_mask(score, EDGE_THRESHOLD)
        score = _cell_threshold(score)
        score = _nms3(score)
        xy, resp, valid = select_keypoints(score, cap)

        h, w = lvl_img.shape
        m10, m01 = orientation_maps(lvl_img)
        ix = xy[:, 0].to(torch.int64).clamp(0, w - 1)
        iy = xy[:, 1].to(torch.int64).clamp(0, h - 1)
        angle = torch.atan2(m01[iy, ix], m10[iy, ix])

        # K1 input: this level's blurred image and keypoints, indexed by
        # position in ``blurred`` (levels with no budget are skipped).
        level_idx.append(torch.full((cap,), len(blurred), dtype=torch.int32,
                                    device=dev))
        blurred.append(gaussian_blur(lvl_img))
        level_xy.append(xy)
        xs.append(xy * (scale ** lv))
        lvls.append(torch.full((cap,), lv, dtype=torch.int32, device=dev))
        angs.append(angle)
        resps.append(resp)
        valids.append(valid)

    desc = cuda_brief.brief_descriptors(
        blurred, torch.cat(level_xy), torch.cat(level_idx), torch.cat(angs))
    return FrameFeatures(
        xy=torch.cat(xs), level=torch.cat(lvls), angle=torch.cat(angs),
        response=torch.cat(resps), desc=desc, valid=torch.cat(valids))
