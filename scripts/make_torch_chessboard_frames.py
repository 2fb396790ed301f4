#!/usr/bin/env python3
"""Write the chessboard world-frame cell's frames as a fixture for the
PyTorch port.

    python scripts/make_torch_chessboard_frames.py

The fork's deployment (``configs/Mycamera.yaml``, a Basler camera at
1280x1024 with radtan distortion) sets the map's world frame from a 9 x 6
chessboard of 24 mm squares lying on the floor. This script renders such a
scene in the board's frame (x along the board's rows, y along its
columns, z up, the origin at the first inner corner): a textured floor, the
board with a white margin on it, and 3D clutter where it hides none of the
board: raised textured plates (4-30 cm high) beside and beyond it, and
upright textured panels (15-70 cm high) staggered 0.25-1.2 m beyond it.
The camera starts 0.62 m above the floor looking down at the board,
tilted 45 degrees from the vertical, moves sideways at 0.25 m/s, sees the
whole board on the first frames and moves on past it. (A camera looking
straight down at a floor that is mostly one plane does not initialise:
the two-view homography's decompositions tie and the fundamental matrix
is degenerate; the panels give the init its depth.) Each pixel is the mean of
3 x 3 samples, each cast from the pixel's position undistorted through
Mycamera's radtan coefficients, so the images are what that camera sees.

Rendering needs OpenCV, which a machine that only runs the port may lack,
so the frames are committed: ``tests/golden/frames_chessboard.npz`` holds

  * ``frames``: (30, 1024, 1280) uint8, at 10 Hz (t = 0.0 ... 2.9 s);
  * ``frames_half``: (30, 512, 640) uint8, the same poses through the
    intrinsics halved (the CPU tests' size);
  * ``stamps``: (30,) float64 s;
  * ``R``, ``t``: (30, 3, 3) and (30, 3) float64, the true board-to-camera
    poses; ``centres``: (30, 3) float64, the camera centres;
  * ``corners``, ``corners_half``: (30, 54, 2) float64, the true projections
    of the board's inner corners (distorted pixels, NaN where a corner is
    outside the image), in the row-major order of ``board_world_points``;
  * ``cv_corners``, ``cv_corners_half``: OpenCV's
    ``findChessboardCornersSB`` corners, NaN where it found no board;
    ``cv_err``, ``cv_err_half``: (30,) their mean distance to the truth in
    px (each OpenCV corner against its nearest true corner), NaN where
    none;
  * ``camera``: (10,) float64, fx, fy, cx, cy, width, height, k1, k2, p1,
    p2 at full size; ``board``: (6,) width, height, square size, start x,
    start y, z height.

``orbslam3_byzyh_tpu_torch.graft.chessboard_frames()`` loads it.
"""

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(ROOT, "tests", "golden", "frames_chessboard.npz")

# configs/Mycamera.yaml.
CAMERA = (1236.996438, 1236.748984, 651.355418, 512.285855, 1280, 1024)
DIST = (-0.1419322617307899, 0.05865966713236987, 0.001520840995510708,
        0.001582820035262499)
BOARD = (9, 6, 0.024, 0.0, 0.0, 0.0)
N_FRAMES = 30
RATE_HZ = 10.0
SUPERSAMPLE = 3
TEXEL_M = 0.0004
TEX_BLUR = 0.8            # the texture's smoothing, texels
FLOOR = (-0.75, 1.25, -0.65, 0.8)        # x0, x1, y0, y1 of the texture, m
TILT_DEG = 45.0
SPEED_MPS = 0.25
HEIGHT_M = 0.62
BOARD_MARGIN_M = 0.02


def plates(rng) -> tuple:
    """Raised plates, (x0, x1, y0, y1, height m, texture offset texels):
    two rows beyond the board (the camera looks towards -y) and two
    columns to its left, none between the camera and the board."""
    out = []

    def plate(x0, y0, w, h):
        out.append((x0 + rng.uniform(0, 0.02), x0 + w,
                    y0 + rng.uniform(0, 0.02), y0 + h,
                    rng.uniform(0.04, 0.3),
                    (int(rng.integers(0, 4000)), int(rng.integers(0, 2800)))))
    for x0 in np.arange(-0.45, 1.05, 0.1):
        for y0 in (-0.33, -0.2):
            plate(x0, y0, rng.uniform(0.07, 0.095), rng.uniform(0.09, 0.12))
    for y0 in np.arange(-0.08, 0.4, 0.1):
        for x0 in (-0.33, -0.2):
            plate(x0, y0, rng.uniform(0.09, 0.12), rng.uniform(0.07, 0.095))
    return tuple(out)


PLATES = plates(np.random.default_rng(11))


def panels(rng) -> tuple:
    """Upright textured panels facing the camera beyond the board,
    (y, x0, x1, height m, texture offset texels): staggered in depth
    (y -0.25 to -1.2 m) and height (0.15-0.7 m), clear of the lines of
    sight to the board."""
    out = []
    for y in np.arange(-0.25, -1.25, -0.12):
        for x0 in np.arange(-0.9 + rng.uniform(0, 0.15), 1.4, 0.3):
            out.append((y + rng.uniform(-0.03, 0.03), x0,
                        x0 + rng.uniform(0.12, 0.22), rng.uniform(0.15, 0.7),
                        (int(rng.integers(0, 4000)),
                         int(rng.integers(0, 2800)))))
    return tuple(out)


PANELS = panels(np.random.default_rng(13))


def floor_texture(rng) -> np.ndarray:
    """A grey floor with random blobs, lines and polygons (uint8, texels
    of ``TEXEL_M``), smoothed by a texel."""
    import cv2
    x0, x1, y0, y1 = FLOOR
    w = int(round((x1 - x0) / TEXEL_M))
    h = int(round((y1 - y0) / TEXEL_M))
    tex = np.full((h, w), 120, np.uint8)
    n = int(w * h / 900)
    cx = rng.integers(0, w, n)
    cy = rng.integers(0, h, n)
    r = rng.integers(4, 28, n)
    val = rng.integers(10, 250, n)
    kind = rng.integers(0, 4, n)
    for i in range(n):
        c = (int(cx[i]), int(cy[i]))
        v = int(val[i])
        if kind[i] == 0:
            cv2.circle(tex, c, int(r[i]), v, -1, cv2.LINE_AA)
        elif kind[i] == 1:
            cv2.rectangle(tex, (c[0] - r[i], c[1] - r[i] // 2),
                          (c[0] + r[i], c[1] + r[i] // 2), v, -1)
        elif kind[i] == 2:
            a = rng.uniform(0, 2 * np.pi, 3)
            pts = np.stack([c[0] + r[i] * np.cos(a),
                            c[1] + r[i] * np.sin(a)], -1)
            cv2.fillConvexPoly(tex, pts.astype(np.int32), v, cv2.LINE_AA)
        else:
            a = rng.uniform(0, np.pi)
            d = np.array([np.cos(a), np.sin(a)]) * r[i] * 1.5
            cv2.line(tex, (int(c[0] - d[0]), int(c[1] - d[1])),
                     (int(c[0] + d[0]), int(c[1] + d[1])), v, 3,
                     cv2.LINE_AA)
    return cv2.GaussianBlur(tex, (0, 0), TEX_BLUR)


def trajectory(t: float):
    """The true camera centre and camera-to-board rotation at ``t`` s."""
    from scipy.spatial.transform import Rotation
    tilt = np.radians(TILT_DEG)
    c = np.array([0.096 + SPEED_MPS * t,
                  0.06 + HEIGHT_M * np.tan(tilt) + 0.03 * np.sin(1.1 * t),
                  HEIGHT_M - 0.05 * t])
    R_wc = (Rotation.from_euler("z", 0.05 * np.sin(0.9 * t) + 0.03)
            * Rotation.from_euler("x", np.pi - tilt)
            * Rotation.from_euler("xy", [0.03 * np.sin(0.7 * t),
                                         -0.03 + 0.06 * t])).as_matrix()
    return c, R_wc


def board_points() -> np.ndarray:
    w, h, sq, sx, sy, z = BOARD
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([sx + jj.ravel() * sq, sy + ii.ravel() * sq,
                     np.full(w * h, z)], -1)


def distort(xy: np.ndarray) -> np.ndarray:
    k1, k2, p1, p2 = DIST
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1 + r2 * (k1 + r2 * k2)
    return np.stack([x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                     y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y], -1)


def undistort(xy_d: np.ndarray, iters: int = 40) -> np.ndarray:
    """The normalised point whose distortion is ``xy_d`` (Newton-free fixed
    point; converges to 1e-12 within the image at these coefficients)."""
    k1, k2, p1, p2 = DIST
    xy = xy_d.copy()
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1 + r2 * (k1 + r2 * k2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = np.stack([(xy_d[..., 0] - dx) / rad,
                       (xy_d[..., 1] - dy) / rad], -1)
    return xy


def project(K, R_cw, t_cw, pts) -> np.ndarray:
    fx, fy, cx, cy = K
    pc = pts @ R_cw.T + t_cw
    d = distort(pc[:, :2] / pc[:, 2:3])
    return np.stack([fx * d[:, 0] + cx, fy * d[:, 1] + cy], -1)


def camera_rays(K, w: int, h: int) -> np.ndarray:
    """(h*S, w*S, 3) unit-depth rays of the supersampled pixel grid."""
    fx, fy, cx, cy = K
    s = SUPERSAMPLE
    off = (np.arange(s) + 0.5) / s - 0.5
    u = (np.arange(w)[:, None] + off[None, :]).ravel()
    v = (np.arange(h)[:, None] + off[None, :]).ravel()
    uu, vv = np.meshgrid(u, v)
    xy = undistort(np.stack([(uu - cx) / fx, (vv - cy) / fy], -1))
    return np.concatenate([xy, np.ones(xy.shape[:2] + (1,))], -1)


def shade(tex, rays, c, R_wc) -> np.ndarray:
    """One frame: the nearest of the floor (with the board) and the plates
    along each ray, texture sampled bilinearly, averaged over each pixel's
    samples."""
    import cv2
    d = rays @ R_wc.T                          # world directions
    dz = d[..., 2]
    best_t = np.where(dz < 0, -c[2] / np.minimum(dz, -1e-12), np.inf)
    best = np.zeros(dz.shape, np.int16)  # 0 floor, i+1 plate i, -k-1 panel k
    for i, (x0, x1, y0, y1, hgt, _) in enumerate(PLATES):
        tp = np.where(dz < 0, (hgt - c[2]) / np.minimum(dz, -1e-12), np.inf)
        px = c[0] + tp * d[..., 0]
        py = c[1] + tp * d[..., 1]
        hit = (tp > 0) & (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1) \
            & (tp < best_t)
        best_t = np.where(hit, tp, best_t)
        best = np.where(hit, i + 1, best)
    hits = []
    for k, (yp, x0, x1, top, off) in enumerate(PANELS):
        dy = d[..., 1]
        tw = np.where(dy < 0, (yp - c[1]) / np.minimum(dy, -1e-12), np.inf)
        px = c[0] + tw * d[..., 0]
        pz = c[2] + tw * dz
        hit = (tw > 0) & (px >= x0) & (px <= x1) & (pz >= 0) & (pz <= top) \
            & (tw < best_t)
        best_t = np.where(hit, tw, best_t)
        best = np.where(hit, -(k + 1), best)
        hits.append((px, pz, off))
    X = c[0] + best_t * d[..., 0]
    Y = c[1] + best_t * d[..., 1]
    fx0, _, fy0, _ = FLOOR
    mx = (X - fx0) / TEXEL_M
    my = (Y - fy0) / TEXEL_M
    for i, p in enumerate(PLATES):
        on = best == i + 1
        mx = np.where(on, mx + p[5][0], mx)
        my = np.where(on, my + p[5][1], my)
    for k, (px, pz, off) in enumerate(hits):
        on = best == -(k + 1)
        mx = np.where(on, (px - fx0) / TEXEL_M + off[0], mx)
        my = np.where(on, pz / TEXEL_M + off[1], my)
    img = cv2.remap(tex, mx.astype(np.float32), my.astype(np.float32),
                    cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    img = img.astype(np.float64)
    # The board and its white margin, point-sampled per sample.
    w, h, sq, sx, sy, _ = BOARD
    on_floor = best == 0
    bx = (X - sx) / sq + 1.0                   # cell coords: 0..w+1
    by = (Y - sy) / sq + 1.0
    m = BOARD_MARGIN_M / sq
    in_margin = on_floor & (bx >= -m) & (bx < w + 1 + m) & (by >= -m) \
        & (by < h + 1 + m)
    in_board = on_floor & (bx >= 0) & (bx < w + 1) & (by >= 0) & (by < h + 1)
    dark = ((np.floor(bx) + np.floor(by)) % 2) == 1
    img = np.where(in_margin, 225.0, img)
    img = np.where(in_board & dark, 28.0, img)
    s = SUPERSAMPLE
    hh, ww = img.shape[0] // s, img.shape[1] // s
    img = img.reshape(hh, s, ww, s).mean(axis=(1, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def opencv_corners(img, truth):
    import cv2
    w, h = BOARD[:2]
    found, corners = cv2.findChessboardCornersSB(img, (w, h))
    if not found or corners is None:
        return np.full((w * h, 2), np.nan), np.nan
    c = corners.reshape(-1, 2).astype(np.float64)
    ok = np.isfinite(truth).all(-1)
    dist = np.linalg.norm(c[:, None, :] - truth[None, ok, :], axis=-1)
    return c, float(dist.min(axis=1).mean())


def _render(job):
    """One frame at one size (a worker of the pool)."""
    K, ww, hh, c, R_wc = job
    return shade(_TEX, camera_rays(K, ww, hh), c, R_wc)


_TEX = None


def _init(tex):
    global _TEX
    _TEX = tex


def arrays(workers: int = 4) -> dict:
    from multiprocessing import get_context
    rng = np.random.default_rng(7)
    tex = floor_texture(rng)
    stamps = np.arange(N_FRAMES) / RATE_HZ
    fx, fy, cx, cy, w, h = CAMERA
    sizes = {"": ((fx, fy, cx, cy), w, h),
             "_half": ((fx / 2, fy / 2, cx / 2, cy / 2), w // 2, h // 2)}
    out = {"stamps": stamps}
    Rs, ts, cs = [], [], []
    for s in stamps:
        c, R_wc = trajectory(float(s))
        Rs.append(R_wc.T)
        ts.append(-R_wc.T @ c)
        cs.append(c)
    out.update(R=np.stack(Rs), t=np.stack(ts), centres=np.stack(cs))
    pts = board_points()
    for suffix, (K, ww, hh) in sizes.items():
        with get_context("fork").Pool(workers, _init, (tex,)) as pool:
            imgs = pool.map(_render, [(K, ww, hh, c, R_cw.T)
                                      for R_cw, c in zip(Rs, cs)])
        frames, truth, cv_c, cv_e = [], [], [], []
        for img, R_cw, t_cw in zip(imgs, Rs, ts):
            uv = project(K, R_cw, t_cw, pts)
            inside = ((uv >= 0) & (uv <= [ww - 1, hh - 1])).all(-1)
            uv = np.where(inside[:, None], uv, np.nan)
            corners, err = opencv_corners(img, uv)
            frames.append(img)
            truth.append(uv)
            cv_c.append(corners)
            cv_e.append(err)
        out["frames" + suffix] = np.stack(frames)
        out["corners" + suffix] = np.stack(truth)
        out["cv_corners" + suffix] = np.stack(cv_c)
        out["cv_err" + suffix] = np.array(cv_e)
    out["camera"] = np.array(CAMERA + DIST, np.float64)
    out["board"] = np.array(BOARD, np.float64)
    return out


def main() -> int:
    a = arrays()
    np.savez_compressed(OUT, **a)
    found = np.flatnonzero(np.isfinite(a["cv_err"]))
    print(f"wrote {os.path.relpath(OUT)}: {a['frames'].shape} and "
          f"{a['frames_half'].shape} frames, "
          f"{os.path.getsize(OUT) / 1e6:.2f} MB; OpenCV finds the board on "
          f"frames {found.tolist()} (mean error "
          f"{np.nanmean(a['cv_err']):.4f} px), half size on "
          f"{np.flatnonzero(np.isfinite(a['cv_err_half'])).tolist()} "
          f"({np.nanmean(a['cv_err_half']):.4f} px)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
