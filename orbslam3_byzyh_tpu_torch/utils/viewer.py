"""Offline map and frame rendering, without matplotlib.

Port of ``orbslam3_byzyh_tpu/utils/viewer.py`` (the stand-in for
ORB-SLAM3's Pangolin viewer: MapDrawer::DrawMapPoints, DrawKeyFrames,
DrawCurrentCamera and FrameDrawer::DrawFrame). The JAX module draws with
matplotlib, which the card's machine does not have; this one splits the
drawing in two:

  * :func:`map_geometry` returns what the JAX ``draw_map`` hands matplotlib:
    the subsampled landmarks, each live keyframe's frustum polyline, the
    covisibility segments of weight >= 15 and the current camera's
    frustum. The JAX function counts the covisibility weights in an O(K^2)
    host loop over the observation table; here they are counted on the
    device (one scatter-add over each landmark's observation pairs) and
    read once, with the map's poses and points.
  * :func:`render_map` rasterises that geometry with numpy: a fixed 3-D
    view (matplotlib's default, azimuth -60 and elevation 30 degrees, z
    up), orthographic, fitted to the geometry, in the JAX colours on
    white. :func:`draw_frame` draws the image with its keypoints (free ones
    as blue dots, tracked ones as green squares) under the JAX banner,
    written with the 5 x 8 bitmap font below.

:func:`snapshot` writes one PNG through ``io.png.write_png`` (8-bit RGB).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..io import png
from ..models import map_state as ms

STATE_NAMES = {0: "NOT INITIALIZED", 1: "OK", 2: "RECENTLY LOST", 3: "LOST"}

# The JAX module's matplotlib colours: "0.3" grey, tab:blue, tab:green
# (drawn at alpha 0.6), tab:red; the background white.
POINT_RGB = (76, 76, 76)
KEYFRAME_RGB = (31, 119, 180)
COVIS_RGB = (44, 160, 44)
COVIS_ALPHA = 0.6
CURRENT_RGB = (214, 39, 40)
BACKGROUND_RGB = (255, 255, 255)
# The least shared-landmark count of a drawn covisibility segment (the JAX
# module's 15; MapDrawer draws at 100).
COVIS_MIN_WEIGHT = 15
# matplotlib's default 3-D view.
VIEW_AZIM_DEG = -60.0
VIEW_ELEV_DEG = 30.0
MARGIN_PX = 12

# The classic 5 x 8 column font for ASCII 32-126: 5 bytes a glyph, one a
# column, bit 0 the top row.
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649562050" "0008070300" "001c224100" "0041221c00"
    "2a1c7f1c2a" "08083e0808" "0080703000" "0808080808" "0000606000"
    "2010080402" "3e5149453e" "00427f4000" "7249494946" "2141494d33"
    "1814127f10" "2745454539" "3c4a494931" "4121110907" "3649494936"
    "464949291e" "0000140000" "0040340000" "0008142241" "1414141414"
    "0041221408" "0201590906" "3e415d594e" "7c1211127c" "7f49494936"
    "3e41414122" "7f4141413e" "7f49494941" "7f09090901" "3e41415173"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f021c027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "2649494932" "03017f0103" "3f4040403f" "1f2040201f"
    "3f4038403f" "6314081463" "0304780403" "6159494d43" "007f414141"
    "0204081020" "004141417f" "0402010204" "4040404040" "0003070800"
    "2054547840" "7f28444438" "3844444428" "384444287f" "3854545418"
    "00087e0902" "18a4a49c78" "7f08040478" "00447d4000" "2040403d00"
    "7f10284400" "00417f4000" "7c04780478" "7c08040478" "3844444438"
    "fc18242418" "18242418fc" "7c08040408" "4854545424" "04043f4424"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "4c9090907c"
    "4464544c44" "0008364100" "0000770000" "0041360800" "0201020402")
GLYPH_W, GLYPH_H = 6, 8          # a glyph's cell: 5 columns and a gap


class MapGeometry(NamedTuple):
    """What :func:`map_geometry` hands the renderer (numpy float64, world
    frame): the JAX ``draw_map``'s scatter and plot arguments."""

    points: np.ndarray          # (P, 3) the subsampled live landmarks
    keyframes: np.ndarray       # (n, 12, 3) the live keyframes' frusta
    covisibility: np.ndarray    # (m, 2, 3) centre segments of weight >= 15
    current: np.ndarray | None  # (12, 3) the current camera's frustum


def _camera_wireframe(R, t, scale=0.1):
    """Frustum polyline in world coords for a world->cam pose."""
    w, h, z = 1.0 * scale, 0.75 * scale, 0.6 * scale
    pts_c = np.array([[0, 0, 0], [w, h, z], [-w, h, z], [-w, -h, z],
                      [w, -h, z]], np.float64)
    pts_w = (pts_c - t) @ R            # R^T (p - t)
    order = [0, 1, 2, 0, 3, 4, 0, 2, 3, 0, 4, 1]
    return pts_w[order]


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def map_geometry(state: ms.MapState, n_kf: int, current_pose=None,
                 show_covisibility: bool = True,
                 max_points: int = 20000) -> MapGeometry:
    """The map's drawing as the JAX ``draw_map`` computes it: the live
    landmarks (every ``len // max_points + 1``-th past ``max_points``),
    the frustum of each live keyframe below ``n_kf``, the segments between
    the centres of live keyframe pairs (a < b) that observe at least 15
    common landmarks (a landmark counts while its observation rows are
    valid, whether or not it is live, as in the JAX loop), and the
    frustum of ``current_pose`` (R, t), 1.5 x larger. One read of the
    device."""
    K = state.kfs.valid.shape[0]
    weights = (ms.covisibility_matrix(
        state, lm_valid=torch.ones_like(state.lms.valid))
        if show_covisibility else torch.zeros((K, K), dtype=torch.int32,
                                               device=state.kfs.R.device))
    lm_valid, pos, Rs, ts, kf_valid, W = device_mod.read(
        state.lms.valid, state.lms.pos, state.kfs.R, state.kfs.t,
        state.kfs.valid, weights)
    pos = pos[lm_valid > 0].astype(np.float64)
    if len(pos) > max_points:
        pos = pos[:: len(pos) // max_points + 1]
    ids = np.array([k for k in range(n_kf) if kf_valid[k] > 0], np.int64)
    frusta = np.stack([_camera_wireframe(Rs[k], ts[k]) for k in ids]
                      ) if len(ids) else np.zeros((0, 12, 3))
    centres = {k: -Rs[k].T.astype(np.float64) @ ts[k] for k in ids}
    pairs = [(a, b) for i, a in enumerate(ids) for b in ids[i + 1:]
             if show_covisibility and W[a, b] >= COVIS_MIN_WEIGHT]
    segs = (np.stack([np.stack([centres[a], centres[b]]) for a, b in pairs])
            if pairs else np.zeros((0, 2, 3)))
    cur = None
    if current_pose is not None:
        cur = _camera_wireframe(_host(current_pose[0]),
                                _host(current_pose[1]), scale=0.15)
    return MapGeometry(pos, frusta, segs, cur)


def _view_axes():
    az, el = np.radians(VIEW_AZIM_DEG), np.radians(VIEW_ELEV_DEG)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az),
                   np.cos(el)])
    return right, up


def _blend(img, rr, cc, rgb, alpha=1.0):
    """Paint the pixels (rr, cc) inside the image with ``rgb``."""
    h, w = img.shape[:2]
    ok = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    rr, cc = rr[ok], cc[ok]
    col = np.asarray(rgb, np.float64)
    if alpha >= 1.0:
        img[rr, cc] = col.astype(np.uint8)
    else:
        img[rr, cc] = (alpha * col + (1 - alpha) * img[rr, cc]).round(
            ).astype(np.uint8)


def _segments(img, a, b, rgb, alpha=1.0):
    """Draw the 2-D segments a[i] -> b[i] (pixels, (n, 2) as x, y) one pixel
    wide, sampled at every pixel step along the longer axis."""
    if len(a) == 0:
        return
    n = int(np.ceil(np.abs(b - a).max(-1).max())) + 1
    s = np.linspace(0.0, 1.0, n)[None, :, None]
    p = np.rint(a[:, None] + s * (b - a)[:, None]).reshape(-1, 2)
    p = np.unique(p.astype(np.int64), axis=0)
    _blend(img, p[:, 1], p[:, 0], rgb, alpha)


def render_map(geometry: MapGeometry, size=(480, 640)) -> np.ndarray:
    """Rasterise :func:`map_geometry`'s output: (h, w, 3) uint8 RGB. Every
    element is projected orthographically along the fixed view
    (``VIEW_AZIM_DEG``, ``VIEW_ELEV_DEG``; the world's z up the image) and
    the whole fitted into the image inside ``MARGIN_PX``: points one pixel,
    polylines and segments one pixel wide."""
    margin = MARGIN_PX
    h, w = size
    img = np.empty((h, w, 3), np.uint8)
    img[:] = BACKGROUND_RGB
    right, up = _view_axes()
    parts = [geometry.points.reshape(-1, 3),
             geometry.keyframes.reshape(-1, 3),
             geometry.covisibility.reshape(-1, 3)]
    if geometry.current is not None:
        parts.append(geometry.current)
    every = np.concatenate(parts)
    every = every[np.isfinite(every).all(-1)]
    if len(every) == 0:
        return img
    xy = np.stack([every @ right, every @ up], -1)
    lo, hi = xy.min(0), xy.max(0)
    span = max(float((hi - lo).max()), 1e-9)
    scale = min((w - 1 - 2 * margin) / span, (h - 1 - 2 * margin) / span)
    mid = 0.5 * (lo + hi)

    def to_px(p):
        q = np.stack([p @ right, p @ up], -1)
        return np.stack([(q[..., 0] - mid[0]) * scale + 0.5 * (w - 1),
                         (mid[1] - q[..., 1]) * scale + 0.5 * (h - 1)], -1)

    def polyline(pts, rgb, alpha=1.0):
        px = to_px(pts)
        _segments(img, px[:-1], px[1:], rgb, alpha)

    if len(geometry.points):
        p = np.rint(to_px(geometry.points[
            np.isfinite(geometry.points).all(-1)])).astype(np.int64)
        _blend(img, p[:, 1], p[:, 0], POINT_RGB)
    for wf in geometry.keyframes:
        polyline(wf, KEYFRAME_RGB)
    if len(geometry.covisibility):
        seg = to_px(geometry.covisibility)
        _segments(img, seg[:, 0], seg[:, 1], COVIS_RGB, COVIS_ALPHA)
    if geometry.current is not None:
        polyline(geometry.current, CURRENT_RGB)
    return img


def draw_text(img: np.ndarray, text: str, x: int, y: int,
              rgb=(0, 0, 0)) -> None:
    """Write ``text`` into ``img`` with its top-left corner at (x, y), in
    the 5 x 8 font (a character outside ASCII 32-126 as '?')."""
    for i, ch in enumerate(text):
        code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
        cols = _FONT[5 * (code - 32):5 * (code - 32) + 5]
        bits = np.array([[(c >> r) & 1 for c in cols] for r in range(8)],
                        bool)
        rr, cc = np.nonzero(bits)
        _blend(img, y + rr, x + i * GLYPH_W + cc, rgb)


def draw_frame(img, feats, bindings=None, status: int = 1, n_kf: int = 0,
               n_lm: int = 0):
    """The current frame with its keypoints and the tracking banner
    (FrameDrawer::DrawFrame): the grey image in RGB under a white strip
    holding the banner, keypoints bound to a landmark as green 7 x 7
    squares, the other valid ones as blue 3-pixel dots. Returns (the (h +
    16, w, 3) uint8 image, the banner)."""
    grey = np.clip(np.rint(_host(img).astype(np.float64)), 0, 255).astype(
        np.uint8)
    h, w = grey.shape
    xy = _host(feats.xy)
    valid = _host(feats.valid).astype(bool)
    if bindings is not None:
        bound = _host(bindings) >= 0
        tracked, free = valid & bound, valid & ~bound
    else:
        tracked, free = np.zeros_like(valid), valid
    strip = 2 * GLYPH_H
    out = np.empty((h + strip, w, 3), np.uint8)
    out[:strip] = BACKGROUND_RGB
    out[strip:] = grey[..., None]
    c = np.rint(xy).astype(np.int64)
    dot = np.array([[0, 0], [0, -1], [0, 1], [-1, 0], [1, 0]])
    for (dx, dy) in dot:
        _blend(out, strip + c[free, 1] + dy, c[free, 0] + dx, KEYFRAME_RGB)
    ring = [(dx, dy) for dx in range(-3, 4) for dy in range(-3, 4)
            if max(abs(dx), abs(dy)) == 3]
    for (dx, dy) in ring:
        _blend(out, strip + c[tracked, 1] + dy, c[tracked, 0] + dx,
               COVIS_RGB)
    text = (f"{STATE_NAMES.get(status, '?')}  |  KFs: {n_kf}  "
            f"MPs: {n_lm}  |  matches: {int(tracked.sum())}")
    draw_text(out, text, max(0, (w - GLYPH_W * len(text)) // 2),
              GLYPH_H // 2)
    return out, text


def snapshot(slam, path: str, img=None, feats=None):
    """Write the map (and, with ``img`` and ``feats``, the current frame
    beside it) to the PNG ``path``: the practical equivalent of a glance at
    the Pangolin window. Returns ``path``."""
    cur = None
    if slam._last is not None:
        cur = (_host(slam._last["R"]), _host(slam._last["t"]))
    panel = render_map(map_geometry(slam.state, slam.n_kf,
                                    current_pose=cur))
    if img is not None and feats is not None:
        frame, _ = draw_frame(img, feats,
                              bindings=(slam._last or {}).get("bindings"),
                              status=slam.status, n_kf=slam.n_kf,
                              n_lm=slam.n_lm)
        hh = max(panel.shape[0], frame.shape[0])
        pad = lambda a: np.concatenate([a, np.full(  # noqa: E731
            (hh - a.shape[0],) + a.shape[1:], 255, np.uint8)])
        panel = np.concatenate([pad(panel), pad(frame)], 1)
    png.write_png(path, panel)
    return path


def atlas_image(atlas, idx: int | None = None):
    """One atlas map's render (720 x 900, the current map by default) under
    the JAX ``view_atlas.py`` title. Returns (the RGB image, the title)."""
    idx = atlas.current if idx is None else idx
    size = (720, 900)
    meta = atlas.meta[idx]
    img = render_map(map_geometry(atlas.maps[idx], meta.n_kf), size)
    title = (f"map {idx}/{len(atlas.maps)}: {meta.n_kf} KFs, "
             f"{meta.n_lm} landmarks")
    draw_text(img, title, max(0, (size[1] - GLYPH_W * len(title)) // 2), 4)
    return img, title


def main_view_atlas(argv=None) -> str:
    """``scripts/view_atlas_torch.py``: render an atlas checkpoint
    (``io/checkpoint``'s format, written by either package) to a PNG.
    Returns the path written."""
    import argparse

    from ..io import checkpoint
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--out", default="map.png")
    ap.add_argument("--map", type=int, default=None,
                    help="map index (default: current)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    atlas = checkpoint.load_atlas(args.checkpoint, args.device)
    img, _ = atlas_image(atlas, args.map)
    png.write_png(args.out, img)
    print(f"wrote {args.out}")
    return args.out
