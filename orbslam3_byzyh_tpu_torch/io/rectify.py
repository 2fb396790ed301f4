"""Stereo rectification without OpenCV: Bouguet's ``cv::stereoRectify``
and ``cv::initUndistortRectifyMap`` in float64 numpy, once on the host, and
the per-frame remap as a bilinear gather on the device.

Port of the JAX package's ``io/rectify.py`` (``RectifiedRig`` and
``build_rectification(cam1, cam2, T_c1_c2)``, the same signature and
fields), which calls ``cv2.stereoRectify``, ``initUndistortRectifyMap`` and
``remap``; the card's machine has no OpenCV. The rectification follows
OpenCV's ``cvStereoRectify`` with ``CALIB_ZERO_DISPARITY`` and ``alpha = 0``:

* the half rotations ``r_r = rodrigues(-om / 2)`` of the cam1 -> cam2
  rotation, and the rotation ``wR`` that aligns the baseline with x;
* ``fc_new`` the mean of the two focal lengths across the baseline;
* ``cc_new`` from the four undistorted image corners, projected through
  ``R1`` / ``R2`` at ``fc_new`` and averaged, then averaged over the two
  cameras (zero disparity);
* ``alpha = 0``: the scale ``s0`` that fits the inner rectangle of each
  camera's undistorted, rectified 9 x 9 grid of points from the first
  pixel to the last (``getRectangles``, float64) inside the image, from
  ``cc_new`` to its first and last pixel;
* OpenCV's iterative ``undistortPoints`` (5 fixed-point iterations of the
  radtan model).

The maps are OpenCV's ``initUndistortRectifyMap`` (float32 maps from
float64 arithmetic). ``RectifiedRig.rectify`` is ``cv2.remap`` with
``INTER_LINEAR`` as OpenCV 5 computes it for a float32 image: exact
bilinear weights, zero outside the image. It runs on the images' device
with torch operations and no synchronisation; :func:`remap_plain` is the
float64 numpy version it is held against.

The rig also carries ``R1``: a system that tracks the rectified left
camera needs the IMU extrinsic of that camera, ``T_b_rect = T_b_c1 [R1^T |
0]`` (:func:`rectified_body_extrinsic`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod

UNDISTORT_ITERS = 5       # cvUndistortPoints' default criteria (COUNT, 5)
GRID = 9                  # getRectangles' N x N grid


def rodrigues_to_matrix(om) -> np.ndarray:
    om = np.asarray(om, np.float64).reshape(3)
    th = float(np.linalg.norm(om))
    if th < 1e-300:
        return np.eye(3)
    k = om / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    c, s = np.cos(th), np.sin(th)
    return c * np.eye(3) + (1 - c) * np.outer(k, k) + s * K


def rodrigues_to_vector(R) -> np.ndarray:
    """OpenCV's ``Rodrigues`` of a matrix: made orthonormal by its SVD
    first, then the axis-angle vector."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt(r @ r) * 0.5
    c = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        raise ValueError("a stereo rotation of about 180 degrees")
    return r * (theta / (2 * s))


def _dist8(dist) -> np.ndarray:
    """radtan coefficients (k1, k2, p1, p2[, k3]) -> OpenCV's first 8."""
    k = np.zeros(8)
    if dist is not None:
        d = np.asarray(dist, np.float64).ravel()
        k[:len(d)] = d[:8]
    return k


def undistort_points(pts, K, dist, R=None, P=None,
                     iters: int = UNDISTORT_ITERS) -> np.ndarray:
    """OpenCV's ``undistortPoints`` (radtan, fixed iteration count): (N, 2)
    pixels -> (N, 2) normalised coordinates, or pixels of ``P`` after the
    rotation ``R``."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    k = _dist8(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (pts[:, 0] - cx) * (1.0 / fx)
    y0 = (pts[:, 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    if np.any(k):
        done = np.zeros(len(x), bool)
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                      / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
            # OpenCV stops a point at the first negative icdist, keeping its
            # distorted normalised coordinates.
            bad = (icdist < 0) & ~done
            done |= bad
            dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
            dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
            x = np.where(done, np.where(bad, x0, x), (x0 - dx) * icdist)
            y = np.where(done, np.where(bad, y0, y), (y0 - dy) * icdist)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], -1)


def _inner_rectangle(K, dist, R, P, size):
    """``getRectangles``' inner rectangle (x, y, w, h) of the undistorted,
    rectified 9 x 9 grid from the first pixel to the last (float64
    points)."""
    w, h = size
    n = GRID
    gx, gy = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    pts = np.stack([gx * (w - 1) / (n - 1), gy * (h - 1) / (n - 1)], -1)
    p = undistort_points(pts.reshape(-1, 2), K, dist, R, P).reshape(n, n, 2)
    x0, x1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    y0, y1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return x0, y0, x1 - x0, y1 - y0


def stereo_rectify(K1, d1, K2, d2, size, R, T):
    """``cv2.stereoRectify(K1, d1, K2, d2, size, R, T,
    flags=CALIB_ZERO_DISPARITY, alpha=0)`` -> (R1, R2, P1, P2); ``R``,
    ``T`` map cam1 points into cam2."""
    nx, ny = float(size[0]), float(size[1])
    om = rodrigues_to_vector(R) * -0.5
    r_r = rodrigues_to_matrix(om)
    t = r_r @ np.asarray(T, np.float64).reshape(3)
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = float(np.linalg.norm(t))
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = float(np.linalg.norm(ww))
    if nw > 0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ np.asarray(T, np.float64).reshape(3)

    # fc_new: the mean focal length across the baseline (newImgSize = size).
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    cc = []
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]],
                       np.float32)
    for K, d, Rk in ((K1, d1, R1), (K2, d2, R2)):
        p = undistort_points(corners, K, d).astype(np.float32)
        X = np.concatenate([p, np.ones((4, 1), np.float32)], 1).astype(
            np.float64)
        Y = X @ Rk.T
        proj = (fc_new * Y[:, :2] / Y[:, 2:3]).astype(np.float32)
        avg = proj.astype(np.float64).mean(0)
        cc.append([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]])
    cc = np.asarray(cc)
    cc[:] = (cc[0] + cc[1]) * 0.5                 # CALIB_ZERO_DISPARITY

    def proj_mat(k):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2], P[2, 2] = cc[k, 0], cc[k, 1], 1.0
        return P

    P1, P2 = proj_mat(0), proj_mat(1)
    P2[idx, 3] = t[idx] * fc_new
    in1 = _inner_rectangle(K1, d1, R1, P1, size)
    in2 = _inner_rectangle(K2, d2, R2, P2, size)

    def fit(cx, cy, r):
        """The scale that keeps the rectangle inside the image (alpha = 0)
        around the principal point, to the first and the last pixel."""
        return max(cx / (cx - r[0]), cy / (cy - r[1]),
                   (nx - 1 - cx) / (r[0] + r[2] - cx),
                   (ny - 1 - cy) / (r[1] + r[3] - cy))

    s = max(fit(*cc[0], in1), fit(*cc[1], in2))
    fc_new *= s
    for P in (P1, P2):
        P[0, 0] = P[1, 1] = fc_new
    P2[idx, 3] *= s
    return R1, R2, P1, P2


def init_undistort_rectify_map(K, dist, R, P, size):
    """``cv2.initUndistortRectifyMap(K, dist, R, P, size, CV_32FC1)``:
    float32 (h, w) maps of the source pixel of each rectified pixel."""
    w, h = size
    k = _dist8(dist)
    ir = np.linalg.inv(np.asarray(P, np.float64)[:3, :3]
                       @ np.asarray(R, np.float64))
    j, i = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    wi = 1.0 / _w
    x, y = _x * wi, _y * wi
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    u = K[0, 0] * (x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def remap_plain(img, mx, my) -> np.ndarray:
    """``cv2.remap(img, mx, my, INTER_LINEAR)`` of a float32 image in
    float64 numpy: bilinear, zero outside the image."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    mx, my = np.asarray(mx, np.float64), np.asarray(my, np.float64)
    x0, y0 = np.floor(mx), np.floor(my)
    fx, fy = mx - x0, my - y0
    out = np.zeros(mx.shape)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = img[np.where(ok, yi, 0).astype(np.int64),
                    np.where(ok, xi, 0).astype(np.int64)]
            out += np.where(ok, v, 0.0) * wx * wy
    return out.astype(np.float32)


class DeviceMaps:
    """One camera's remap on a device: the four taps' flat indices
    (clamped into the image) and their bilinear weights, zero for a tap
    outside the image; built once."""

    def __init__(self, mx, my, shape, device):
        h, w = shape
        mx = torch.as_tensor(np.asarray(mx), dtype=torch.float32)
        my = torch.as_tensor(np.asarray(my), dtype=torch.float32)
        x0, y0 = torch.floor(mx), torch.floor(my)
        fx, fy = mx - x0, my - y0
        idx, wts = [], []
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                xi, yi = x0 + dx, y0 + dy
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                idx.append(flat)
                wts.append(torch.where(ok, wx * wy, torch.zeros_like(wx)))
        self.shape = (h, w)
        self.idx = device_mod.upload(torch.stack(idx).numpy(), device)
        self.wts = device_mod.upload(torch.stack(wts).numpy(), device)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        v = img.reshape(-1)[self.idx]
        return (v * self.wts).sum(0)


@dataclasses.dataclass
class RectifiedRig:
    map1x: np.ndarray
    map1y: np.ndarray
    map2x: np.ndarray
    map2y: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float                  # baseline * fx of the rectified rig
    R1: np.ndarray = None      # raw cam1 -> rectified cam1
    R2: np.ndarray = None
    P1: np.ndarray = None
    P2: np.ndarray = None
    _maps: dict = dataclasses.field(default_factory=dict, repr=False)

    def prepare(self, device, shape=None):
        """Build the device maps for ``device`` (once; a frame loop calls
        this before its first frame, so the upload is not a frame's)."""
        return self._device_maps(torch.device(device),
                                 shape or self.map1x.shape)

    def _device_maps(self, device, shape):
        key = (device.type, device.index or 0)
        if key not in self._maps:
            self._maps[key] = (
                DeviceMaps(self.map1x, self.map1y, shape, device),
                DeviceMaps(self.map2x, self.map2y, shape, device))
        return self._maps[key]

    def rectify(self, img_left, img_right):
        """The rectified pair. Tensors are remapped on their device (float32,
        no synchronisation); numpy images on the host (float64 numpy, cast to
        float32), as ``cv2.remap`` does for float32 images."""
        if isinstance(img_left, torch.Tensor):
            m1, m2 = self._device_maps(img_left.device, img_left.shape)
            return (m1(img_left.to(torch.float32)),
                    m2(img_right.to(torch.float32)))
        return (remap_plain(img_left, self.map1x, self.map1y),
                remap_plain(img_right, self.map2x, self.map2y))


def camera_matrix(cam) -> np.ndarray:
    return np.array([[cam.params[0], 0, cam.params[2]],
                     [0, cam.params[1], cam.params[3]], [0, 0, 1]],
                    np.float64)


def build_rectification(cam1, cam2, T_c1_c2: np.ndarray) -> RectifiedRig:
    """cam1/cam2: io.settings.CameraSettings; T_c1_c2: 4x4 cam1<-cam2
    (EuRoC convention: Stereo.T_c1_c2 maps cam2 points into cam1)."""
    K1, K2 = camera_matrix(cam1), camera_matrix(cam2)
    d1 = np.asarray(cam1.dist if cam1.dist is not None else np.zeros(4),
                    np.float64)
    d2 = np.asarray(cam2.dist if cam2.dist is not None else np.zeros(4),
                    np.float64)
    T = np.asarray(T_c1_c2, np.float64)
    # stereoRectify wants cam1->cam2: invert.
    R12, t12 = T[:3, :3], T[:3, 3]
    R = R12.T
    t = -R12.T @ t12
    size = (cam1.width, cam1.height)
    R1, R2, P1, P2 = stereo_rectify(K1, d1, K2, d2, size, R, t)
    m1x, m1y = init_undistort_rectify_map(K1, d1, R1, P1, size)
    m2x, m2y = init_undistort_rectify_map(K2, d2, R2, P2, size)
    bf = float(abs(P2[0, 3]))          # P2[0,3] = -fx * baseline
    return RectifiedRig(m1x, m1y, m2x, m2y,
                        fx=float(P1[0, 0]), fy=float(P1[1, 1]),
                        cx=float(P1[0, 2]), cy=float(P1[1, 2]), bf=bf,
                        R1=R1, R2=R2, P1=P1, P2=P2)


def rectified_body_extrinsic(T_b_c1, R1) -> np.ndarray:
    """The IMU extrinsic of the rectified left camera: ``T_b_rect = T_b_c1
    [R1^T | 0]`` (rectified points are ``R1`` times raw cam1 points)."""
    T = np.eye(4)
    T[:3, :3] = np.asarray(R1, np.float64).T
    return np.asarray(T_b_c1, np.float64) @ T
