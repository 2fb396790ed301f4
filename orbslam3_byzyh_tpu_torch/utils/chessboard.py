"""Chessboard world frame: the fork's world frame set by a chessboard on
the floor, on the device.

Port of the JAX package's ``utils/chessboard.py`` (the fork's
``DetectChessboard``, ``ComputePoseFromChessboard`` and
``TransformAllMapElements``). The JAX module is host OpenCV from end to end
(``findChessboardCornersSB``, ``solvePnP``); the card's machine has no
OpenCV, so this module holds its own detector and its own planar PnP:

  * :func:`detect_chessboard`: a ChESS saddle response (Bennett and
    Lasenby's ring test at three radii, which rejects edges and L-shaped
    corners) with non-maximum suppression and each radius's strongest
    candidates on the device, one read; the lattice grown on the host from
    seeds that have two pairs of opposite neighbours, each position
    predicted by a homography of its grown neighbours; the corners refined
    on the device by gradient orthogonality (as ``cornerSubPix``) and the
    square colours checked for alternation, one read. It returns ``width * height`` corners in a grid
    order (row-major, ``width`` a row), which may differ from OpenCV's by
    the board's symmetries, or None (no board, a board cut by the image
    border, noise).
  * :func:`pose_from_chessboard`: the four grid orderings as one float64
    batch: a normalised DLT homography (the fork's route: r1 = K^-1 h1 / s,
    r2, r3 = r1 x r2, re-orthogonalised), refined by Levenberg-Marquardt
    on the reprojection error (as OpenCV's IPPE and its iterative refine
    end), the JAX module's selection (camera above the board, every depth
    positive, the lowest mean reprojection error, refused above 3 px), one
    read. With radtan coefficients the corners are undistorted first; the
    JAX module (and the fork) pose distorted corners with K alone.
  * :func:`rebase_transform` and :func:`rebase_map`: the rigid rebase of
    the map into the board's frame, on the device.

No step synchronises but the reads named above.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..ops import camera as cam
from ..ops import lie


@dataclasses.dataclass
class ChessboardConfig:
    width: int            # inner corners per row
    height: int           # inner corners per column
    square_size: float    # meters
    start_x: float = 0.0  # world coords of the board origin corner
    start_y: float = 0.0
    z_height: float = 0.0


def board_world_points(cfg: ChessboardConfig) -> np.ndarray:
    """(height * width, 3) world corners, row-major (``width`` a row)."""
    jj, ii = np.meshgrid(np.arange(cfg.width), np.arange(cfg.height))
    return np.stack([cfg.start_x + jj.ravel() * cfg.square_size,
                     cfg.start_y + ii.ravel() * cfg.square_size,
                     np.full(cfg.width * cfg.height, float(cfg.z_height))],
                    -1).astype(np.float64)


# --- The detector -------------------------------------------------------------

# The ChESS ring radii (px), each with candidates of its own: the smallest
# serves squares of about 7 px, the larger ones foreshortened boards.
RING_RADII = (3, 5, 8)
N_CANDIDATES = 256        # strongest suppressed responses read to the host
NMS_RADIUS = 2
MIN_RESPONSE = 0.06       # of the strongest response
SEEDS = 12                # candidates tried as the lattice's seed
OPPOSITE_TOL = 0.3        # of a pair's span: its midpoint off the seed
GROW_TOL = 0.3            # of the local step: a candidate's distance to
#                           its predicted lattice position
REFINE_ITERS = 8
REFINE_HALF = 10          # samples each side of the refinement window
REFINE_SIGMA = 1.2        # the gradients' blur, px
REFINE_WINDOW = (0.45, 2.0, 20.0)  # half-width: x the local step, min, max
MIN_COLOUR_GAP = 20.0     # grey levels between the two colour classes


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(1, int(math.ceil(3 * sigma)))
    k = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    k = torch.exp(-0.5 * (k / sigma) ** 2)
    k = k / k.sum()
    y = F.conv2d(F.pad(x[None, None], (r, r, 0, 0), mode="replicate"),
                 k.view(1, 1, 1, -1))
    y = F.conv2d(F.pad(y, (0, 0, r, r), mode="replicate"),
                 k.view(1, 1, -1, 1))
    return y[0, 0]


def _ring(r: int):
    """16 integer offsets (dy, dx) on a circle of radius ``r``."""
    a = 2 * np.pi * np.arange(16) / 16
    return [(int(round(r * np.sin(t))), int(round(r * np.cos(t)))) for t in a]


def chess_response(img: torch.Tensor) -> torch.Tensor:
    """(len(RING_RADII), H, W) ChESS responses of a float32 image (blurred
    by sigma 1 first), one a ring radius: the sum response (opposite samples
    against the samples a quarter turn on) less the difference response
    (opposite samples against each other) less 16 x the ring mean's
    distance from the local mean. Zero within the ring's radius of the
    border."""
    x = _gaussian_blur(img, 1.0)
    H, W = x.shape
    pad = max(RING_RADII)
    xp = F.pad(x[None, None], (pad,) * 4, mode="replicate")[0, 0]
    local = F.avg_pool2d(x[None, None], 3, 1, 1)[0, 0]
    out = []
    for r in RING_RADII:
        s = torch.stack([xp[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
                         for dy, dx in _ring(r)])
        sum_r = sum((s[n] + s[n + 8] - s[n + 4] - s[n + 12]).abs()
                    for n in range(4))
        diff_r = sum((s[n] - s[n + 8]).abs() for n in range(8))
        mean_r = (s.mean(0) - local).abs()
        inner = torch.ones((H - 2 * r, W - 2 * r), dtype=x.dtype,
                           device=x.device)
        out.append((sum_r - diff_r - 16 * mean_r) * F.pad(inner, (r,) * 4))
    return torch.stack(out)


def _candidates(resp: torch.Tensor, k: int) -> torch.Tensor:
    """(R, k, 3) x, y, response of each radius's strongest local maxima
    (response 0 where fewer qualify)."""
    R, H, W = resp.shape
    mx = F.max_pool2d(resp[:, None], 2 * NMS_RADIUS + 1, 1,
                      NMS_RADIUS)[:, 0]
    top = resp.reshape(R, -1).amax(1)[:, None, None]
    keep = (resp == mx) & (resp > MIN_RESPONSE * top)
    score = torch.where(keep, resp, torch.zeros_like(resp)).reshape(R, -1)
    val, idx = torch.topk(score, min(k, H * W), dim=1)
    return torch.stack([(idx % W).to(resp.dtype),
                        (idx // W).to(resp.dtype), val], -1)


def _fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(3, 3) least-squares homography src -> dst (normalised DLT, numpy
    float64; at least 4 points)."""
    def norm(p):
        mu = p.mean(0)
        s = np.sqrt(2.0) / max(np.linalg.norm(p - mu, axis=1).mean(), 1e-12)
        return np.array([[s, 0, -s * mu[0]], [0, s, -s * mu[1]], [0, 0, 1.0]])
    Ts, Td = norm(src), norm(dst)
    a = src @ Ts[:2, :2].T + Ts[:2, 2]
    b = dst @ Td[:2, :2].T + Td[:2, 2]
    z, o = np.zeros(len(a)), np.ones(len(a))
    A = np.concatenate([
        np.stack([a[:, 0], a[:, 1], o, z, z, z, -b[:, 0] * a[:, 0],
                  -b[:, 0] * a[:, 1], -b[:, 0]], 1),
        np.stack([z, z, z, a[:, 0], a[:, 1], o, -b[:, 1] * a[:, 0],
                  -b[:, 1] * a[:, 1], -b[:, 1]], 1)])
    h = np.linalg.svd(A)[2][-1].reshape(3, 3)
    return np.linalg.inv(Td) @ h @ Ts


def _grow(pts: np.ndarray, seed: int, a: int, b: int, max_ext: int):
    """Grow a lattice from ``seed`` with axes towards candidates ``a`` and
    ``b``: {(i, j): candidate}. Each empty lattice position next to the
    grown ones is predicted by a homography fitted to the nearest grown
    positions (by lattice distance; an affine fit until they fix one) and
    takes the nearest candidate within
    :data:`GROW_TOL` of the local step. Growth stops once the lattice
    spans more than ``max_ext`` positions along an axis."""
    grid = {(0, 0): seed, (1, 0): a, (0, 1): b}
    used = {seed, a, b}
    grown = True
    while grown:
        grown = False
        cells = sorted({(i + di, j + dj) for (i, j) in grid
                        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1))}
                       - set(grid))
        ij = np.array(list(grid), np.float64)
        xy = pts[list(grid.values())]
        for q in cells:
            dq = np.abs(ij - q).max(1)
            near = np.argsort(dq, kind="stable")[:12]
            sub = ij[near]
            qh = np.array([q[0], q[1], 1.0])
            if len(near) >= 8 and len(np.unique(sub[:, 0])) >= 3 and \
                    len(np.unique(sub[:, 1])) >= 3:
                ph = _fit_homography(sub, xy[near]) @ qh
                pred = ph[:2] / ph[2]
            else:
                # An affine fit while the grown positions are too few (or
                # too nearly collinear) to fix a homography.
                A = np.concatenate([sub, np.ones((len(sub), 1))], 1)
                pred = qh @ np.linalg.lstsq(A, xy[near], rcond=None)[0]
            # The local step: the nearest grown neighbour's distance to its
            # own nearest grown neighbour.
            k = near[0]
            dk = np.linalg.norm(xy - xy[k], axis=1)
            dk[k] = np.inf
            step = dk.min()
            d = np.linalg.norm(pts - pred, axis=1)
            n = int(np.argmin(d))
            if d[n] < GROW_TOL * step and n not in used:
                grid[q] = n
                used.add(n)
                grown = True
        span = np.ptp(np.array(list(grid)), axis=0)
        if span.max() >= max_ext:
            break
    return grid


def _seeds(pts: np.ndarray):
    """Candidates that look like an inner lattice corner, in response
    order: among their 6 nearest candidates, two pairs opposite about them
    (each pair's midpoint within :data:`OPPOSITE_TOL` of their distance of
    the candidate) along two directions at least 30 degrees apart. Returns
    [(seed, a, c)]: the seed and one of each pair, the lattice's axes (the
    shortest such pairs)."""
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    k = min(6, len(pts) - 1)
    nb = np.argsort(d, axis=1)[:, :k]
    q = pts[nb] - pts[:, None]                           # (N, k, 2)
    x, y = np.triu_indices(k, 1)
    mid = np.linalg.norm(q[:, x] + q[:, y], axis=-1)     # (N, P)
    span = np.linalg.norm(q[:, x] - q[:, y], axis=-1)
    opp = mid < OPPOSITE_TOL * span
    out = []
    for i in np.flatnonzero(opp.sum(1) >= 2):
        pairs = sorted((span[i, p], x[p], y[p]) for p in np.flatnonzero(opp[i]))
        for j, (_, a0, a1) in enumerate(pairs):
            for _, c0, c1 in pairs[j + 1:]:
                if len({a0, a1, c0, c1}) < 4:
                    continue
                u, v = q[i, a0], q[i, c0]
                lu, lv = np.linalg.norm(u), np.linalg.norm(v)
                if abs(u[0] * v[1] - u[1] * v[0]) / (lu * lv) >= 0.5 and \
                        0.3 < lu / lv < 3.5:
                    out.append((int(i), int(nb[i, a0]), int(nb[i, c0])))
                    break
            else:
                continue
            break
    return out


def _lattice(pts: np.ndarray, cfg: ChessboardConfig):
    """(height, width) candidate indices of a complete board lattice, or
    None. Seeds (:func:`_seeds`) are tried in response order, at most
    :data:`SEEDS`; a candidate already in a lattice that failed is no
    seed."""
    w, h = cfg.width, cfg.height
    if len(pts) < w * h:
        return None
    covered = set()
    tried = 0
    for seed, a, b in _seeds(pts):
        if seed in covered:
            continue
        if tried == SEEDS:
            break
        tried += 1
        grid = _grow(pts, seed, a, b, max(w, h))
        ij = np.array(list(grid))
        ij -= ij.min(0)
        ext = tuple(ij.max(0) + 1)
        if len(grid) != w * h or ext not in ((w, h), (h, w)):
            covered.update(grid.values())
            continue
        out = np.full((ext[1], ext[0]), -1, np.int64)
        for (i, j), k in zip(ij, grid.values()):
            out[j, i] = k
        return out if ext == (w, h) else out.T
    return None


def _refine(grad: torch.Tensor, xy: torch.Tensor,
            half_win: torch.Tensor) -> torch.Tensor:
    """Corners refined by gradient orthogonality (``cornerSubPix``): each
    corner q solves sum_i g_i g_i^T (q - p_i) = 0 over a Gaussian-weighted
    window of half-width ``half_win`` (per corner, px), sampled
    bilinearly; :data:`REFINE_ITERS` iterations from ``xy``."""
    H, W = grad.shape[-2:]
    g = torch.linspace(-1.0, 1.0, 2 * REFINE_HALF + 1, dtype=xy.dtype,
                       device=xy.device)
    oy, ox = torch.meshgrid(g, g, indexing="ij")
    off = torch.stack([ox, oy], -1).reshape(-1, 2)             # (S, 2)
    wgt = torch.exp(-2.0 * (off ** 2).sum(-1))                  # sigma half
    centre = (off ** 2).sum(-1) < (1.0 / REFINE_HALF) ** 2
    wgt = torch.where(centre, torch.zeros_like(wgt), wgt)
    scale = device_mod.upload(np.array([2.0 / (W - 1), 2.0 / (H - 1)],
                                       np.float32), xy.device).to(xy.dtype)
    q = xy
    for _ in range(REFINE_ITERS):
        p = q[:, None, :] + off[None] * half_win[:, None, None]  # (N, S, 2)
        gs = F.grid_sample(grad[None], (p * scale - 1.0)[None],
                           mode="bilinear", padding_mode="border",
                           align_corners=True)[0]               # (2, N, S)
        gx, gy = gs[0] * wgt, gs[1] * wgt
        a = (gx * gs[0]).sum(-1)
        b = (gx * gs[1]).sum(-1)
        c = (gy * gs[1]).sum(-1)
        bx = (gx * gs[0] * p[..., 0] + gx * gs[1] * p[..., 1]).sum(-1)
        by = (gy * gs[0] * p[..., 0] + gy * gs[1] * p[..., 1]).sum(-1)
        det = a * c - b * b
        ok = det.abs() > 1e-9 * (a * c).abs().clamp_min(1e-30)
        safe = torch.where(ok, det, torch.ones_like(det))
        qn = torch.stack([(c * bx - b * by) / safe,
                          (a * by - b * bx) / safe], -1)
        q = torch.where(ok[:, None], qn, q)
    return q


def detect_chessboard(img, cfg: ChessboardConfig, device=None):
    """The board's ``width * height`` inner corners as an (N, 2) float64
    numpy array of distorted pixels in a grid order (row-major, ``width``
    a row; the grid's origin and handedness are the board's symmetries,
    which :func:`pose_from_chessboard` resolves), or None. ``img``: an
    (H, W) numpy image (uploaded to ``device``; ``None``: the card) or a
    tensor (used where it lies). Two reads: the candidates, then the
    refined corners with the squares' colours."""
    if isinstance(img, torch.Tensor):
        x = img.to(torch.float32)
    else:
        x = device_mod.upload(np.asarray(img),
                              device_mod.resolve(device)).to(torch.float32)
    cand = _candidates(chess_response(x), N_CANDIDATES)
    (c_all,) = device_mod.read(cand)                           # read 1
    # The smallest ring first: it places corners best and serves the
    # smallest squares; a larger one where the lattice did not close.
    for c_np in c_all:
        c_np = c_np[c_np[:, 2] > 0]
        grid = _lattice(c_np[:, :2].astype(np.float64), cfg)
        if grid is not None:
            break
    else:
        return None
    pts = c_np[grid, :2].astype(np.float64)                     # (h, w, 2)
    step = np.full(grid.shape, np.inf)
    for ax in (0, 1):
        d = np.linalg.norm(np.diff(pts, axis=ax), axis=-1)
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[ax], hi[ax] = slice(0, -1), slice(1, None)
        step[tuple(lo)] = np.minimum(step[tuple(lo)], d)
        step[tuple(hi)] = np.minimum(step[tuple(hi)], d)
    # The refinement window: a share of the local lattice step, inside the
    # image.
    f, lo_px, hi_px = REFINE_WINDOW
    H, W = x.shape
    edge = np.minimum.reduce([pts[..., 0], W - 1 - pts[..., 0], pts[..., 1],
                              H - 1 - pts[..., 1]]) - 1.0
    half = np.maximum(np.minimum(np.clip(f * step, lo_px, hi_px), edge), 1.0)
    up = device_mod.upload(np.concatenate(
        [pts.reshape(-1, 2), half.reshape(-1, 1)], 1).astype(np.float32),
        x.device)
    xb = _gaussian_blur(x, REFINE_SIGMA)
    gy, gx = torch.gradient(xb)
    q = _refine(torch.stack([gx, gy]), up[:, :2], up[:, 2])
    # The squares' colours: the image at each inner square's centre.
    qg = q.reshape(cfg.height, cfg.width, 2)
    mid = 0.25 * (qg[1:, 1:] + qg[:-1, 1:] + qg[1:, :-1] + qg[:-1, :-1])
    scale = device_mod.upload(np.array([2.0 / (W - 1), 2.0 / (H - 1)],
                                       np.float32), x.device)
    col = F.grid_sample(xb[None, None], (mid.reshape(1, 1, -1, 2) * scale
                                         - 1.0), mode="bilinear",
                        padding_mode="border", align_corners=True)
    q_np, col_np = device_mod.read(q, col.reshape(-1))         # read 2
    col_np = col_np.reshape(cfg.height - 1, cfg.width - 1)
    par = (np.add.outer(np.arange(cfg.height - 1),
                        np.arange(cfg.width - 1)) % 2).astype(bool)
    a, b = col_np[par], col_np[~par]
    gap = max(a.min() - b.max(), b.min() - a.max())
    if gap < MIN_COLOUR_GAP or not np.isfinite(q_np).all():
        return None
    # A refined corner that left its lattice cell.
    moved = np.linalg.norm(q_np - pts.reshape(-1, 2), axis=1)
    if (moved > 0.35 * step.reshape(-1)).any():
        return None
    return q_np.astype(np.float64)


# --- The planar pose ----------------------------------------------------------

LM_ITERS = 12
MAX_REPROJ_PX = 3.0
TIE_PX = 1e-6             # a tie goes to the first ordering


def _orderings(corners: torch.Tensor, cfg: ChessboardConfig) -> torch.Tensor:
    """(4, N, 2): the detector's order, rows reversed, columns reversed,
    both (the JAX module's candidates, in its order)."""
    g = corners.reshape(cfg.height, cfg.width, 2)
    return torch.stack([g, g.flip(0), g.flip(1), g.flip(0).flip(1)]
                       ).reshape(4, -1, 2)


def _normaliser(p: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) Hartley normalisation of (B, N, 2) points."""
    mu = p.mean(1)
    d = (p - mu[:, None]).norm(dim=-1).mean(1)
    s = math.sqrt(2.0) / d
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([s, z, -s * mu[:, 0]], -1),
                        torch.stack([z, s, -s * mu[:, 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def _apply_h(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1) @ T.transpose(-1, -2)
    return ph[..., :2] / ph[..., 2:]


def _homography(plane: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) homographies taking the (N, 2) plane points to the (B, N,
    2) normalised image points: the normalised DLT with h33 = 1, solved
    from its normal equations without a host read."""
    B, N, _ = img.shape
    pw = plane.expand(B, N, 2)
    Tw, Ti = _normaliser(pw), _normaliser(img)
    a, b = _apply_h(Tw, pw), _apply_h(Ti, img)
    X, Y = a[..., 0], a[..., 1]
    x, y = b[..., 0], b[..., 1]
    z, o = torch.zeros_like(X), torch.ones_like(X)
    r1 = torch.stack([X, Y, o, z, z, z, -x * X, -x * Y], -1)
    r2 = torch.stack([z, z, z, X, Y, o, -y * X, -y * Y], -1)
    A = torch.cat([r1, r2], 1)                                 # (B, 2N, 8)
    rhs = torch.cat([x, y], 1)
    h = torch.linalg.solve_ex(A.transpose(1, 2) @ A,
                              (A.transpose(1, 2) @ rhs[..., None]))[0]
    Hn = torch.cat([h[..., 0], torch.ones_like(h[:, :1, 0])], 1).reshape(
        B, 3, 3)
    return torch.linalg.inv_ex(Ti)[0] @ Hn @ Tw


def _project(R, t, P, K):
    pc = P @ R.transpose(-1, -2) + t[:, None]
    uv = pc[..., :2] / pc[..., 2:]
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack(
        [K[0, 2], K[1, 2]]), pc


def _pose_batch(uv: torch.Tensor, cfg: ChessboardConfig, K: torch.Tensor):
    """(R, t, err, valid) of the (B, N, 2) undistorted pixel orderings, in
    float64: the homography's pose refined by LM."""
    dt, dev = torch.float64, uv.device
    P = device_mod.upload(board_world_points(cfg), dev).to(dt)
    Kinv = torch.linalg.inv_ex(K)[0]
    xn = _apply_h(Kinv[None], uv)
    H = _homography(P[:, :2], xn)
    h1, h2, h3 = H[..., 0], H[..., 1], H[..., 2]
    # The board lies in front: w > 0 at the board's points.
    w = (torch.cat([P[:, :2], torch.ones_like(P[:, :1])], -1) @
         H.transpose(-1, -2))[..., 2].mean(1)
    lam = torch.where(w < 0, -1.0, 1.0).to(dt) * 2.0 / (h1.norm(dim=-1)
                                                         + h2.norm(dim=-1))
    r1, r2 = lam[:, None] * h1, lam[:, None] * h2
    R = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], -1)
    for _ in range(6):
        R = 0.5 * (R + lie._inv_transpose(R))
    # Plane points are (X, Y, z_height): t = t' - z_height r3.
    t = lam[:, None] * h3 - cfg.z_height * R[..., 2]

    def cost(R_, t_):
        p, _ = _project(R_, t_, P, K)
        return ((p - uv) ** 2).sum((-1, -2))

    mu = torch.full_like(lam, 1e-3)
    c0 = cost(R, t)
    for _ in range(LM_ITERS):
        p, pc = _project(R, t, P, K)
        r = (p - uv).reshape(uv.shape[0], -1)                  # (B, 2N)
        iz = 1.0 / pc[..., 2]
        fx, fy = K[0, 0], K[1, 1]
        zero = torch.zeros_like(iz)
        Jp = torch.stack([
            torch.stack([fx * iz, zero, -fx * pc[..., 0] * iz * iz], -1),
            torch.stack([zero, fy * iz, -fy * pc[..., 1] * iz * iz], -1)],
            -2)                                                 # (B, N, 2, 3)
        # A left perturbation: p' = p + dw x p + dt.
        Jx = torch.cat([-Jp @ lie.skew(pc), Jp], -1)            # (B, N, 2, 6)
        J = Jx.reshape(uv.shape[0], -1, 6)
        A = J.transpose(1, 2) @ J
        g = J.transpose(1, 2) @ r[..., None]
        diag = torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))
        step = torch.linalg.solve_ex(A + mu[:, None, None] * (
            diag + 1e-9 * torch.eye(6, dtype=dt, device=dev)), -g)[0][..., 0]
        dR = lie.so3_exp(step[:, :3])
        R_n = dR @ R
        t_n = (dR @ t[..., None])[..., 0] + step[:, 3:]
        c1 = cost(R_n, t_n)
        better = c1 < c0
        R = torch.where(better[:, None, None], R_n, R)
        t = torch.where(better[:, None], t_n, t)
        c0 = torch.where(better, c1, c0)
        mu = torch.where(better, mu * 0.3, mu * 10.0)
    p, pc = _project(R, t, P, K)
    err = (p - uv).norm(dim=-1).mean(1)
    centre_z = -(R.transpose(-1, -2) @ t[..., None])[:, 2, 0]
    valid = (pc[..., 2] > 0).all(1) & (centre_z > cfg.z_height) \
        & torch.isfinite(err)
    return R, t, err, valid


def _as_corners(corners, device) -> torch.Tensor:
    if isinstance(corners, torch.Tensor):
        return corners.to(device=device, dtype=torch.float64)
    return device_mod.upload(np.asarray(corners, np.float64), device)


def pose_from_chessboard(corners, cfg: ChessboardConfig, K, dist=None,
                         device=None):
    """Camera pose (world->cam) in the chessboard world frame, as float32
    numpy (R_cw (3, 3), t_cw (3,)), or None. ``corners``: the detector's
    (N, 2) distorted pixels; ``K``: (3, 3); ``dist``: radtan
    ``[k1, k2, p1, p2(, k3)]`` or None (the JAX module's call). The four
    orderings run as one batch on ``device`` (``None``: the card), with one
    read."""
    n = cfg.width * cfg.height
    if corners is None or len(corners) != n:
        return None
    dev = (corners.device if isinstance(corners, torch.Tensor)
           else device_mod.resolve(device))
    uv = _as_corners(corners, dev)
    Kt = (K.to(device=dev, dtype=torch.float64) if isinstance(K, torch.Tensor)
          else device_mod.upload(np.asarray(K, np.float64), dev))
    if dist is not None:
        d = (dist.to(device=dev, dtype=torch.float64)
             if isinstance(dist, torch.Tensor)
             else device_mod.upload(np.asarray(dist, np.float64), dev))
        params = torch.stack([Kt[0, 0], Kt[1, 1], Kt[0, 2], Kt[1, 2]])
        uv = cam.undistort_pixels(params, d, uv, iters=20)
    R, t, err, valid = _pose_batch(_orderings(uv, cfg), cfg, Kt)
    e = torch.where(valid, err, torch.full_like(err, float("inf")))
    best = e.min()
    pick = torch.argmax((e <= best + TIE_PX).to(torch.int8))
    sel = pick.reshape(1)
    out = torch.cat([R.index_select(0, sel).reshape(-1),
                     t.index_select(0, sel).reshape(-1), best.reshape(1),
                     sel.to(torch.float64)])
    (o,) = device_mod.read(out, dtype=torch.float64)          # the read
    if not np.isfinite(o[12]) or o[12] > MAX_REPROJ_PX:
        return None
    return o[:9].reshape(3, 3).astype(np.float32), o[9:12].astype(np.float32)


def _pose_one_ordering(corners, cfg: ChessboardConfig, K, device=None):
    """One ordering's pose (R_cw, t_cw) float32 numpy, or None where a
    depth is not positive."""
    dev = (corners.device if isinstance(corners, torch.Tensor)
           else device_mod.resolve(device))
    uv = _as_corners(corners, dev)[None]
    Kt = device_mod.upload(np.asarray(K, np.float64), dev)
    R, t, _, _ = _pose_batch(uv, cfg, Kt)
    P = device_mod.upload(board_world_points(cfg), dev).to(R.dtype)
    depth = (P @ R[0].T + t[0])[:, 2]
    R_np, t_np, d_np = device_mod.read(R[0], t[0], depth,
                                       dtype=torch.float64)
    if (d_np <= 0).any():
        return None
    return R_np.astype(np.float32), t_np.astype(np.float32)


def _reproj_err(pose, cfg: ChessboardConfig, K, corners) -> float:
    """Mean pixel distance of the board's projections under ``pose`` from
    ``corners`` (numpy, float64)."""
    R_cw, t_cw = (np.asarray(x, np.float64) for x in pose)
    pc = board_world_points(cfg) @ R_cw.T + t_cw
    uv = pc @ np.asarray(K, np.float64).T
    uv = uv[:, :2] / uv[:, 2:3]
    return float(np.linalg.norm(uv - np.asarray(corners), axis=-1).mean())


# --- The rebase ---------------------------------------------------------------

def rebase_transform(R_chess_cam, t_chess_cam, R_slam_cam, t_slam_cam):
    """SE3 M = chess_world <- slam_world from one camera seen in both
    frames: M = Tc_chess^-1 Tc_slam, p_chess = R_m p_slam + t_m. Tensors
    (or arrays, made tensors on the others' device) in, float32 tensors
    out, no read."""
    dev = next((x.device for x in (R_slam_cam, t_slam_cam, R_chess_cam,
                                   t_chess_cam)
                if isinstance(x, torch.Tensor)), torch.device("cpu"))
    Rc, tc, Rs, ts = (x if isinstance(x, torch.Tensor)
                      else torch.as_tensor(np.asarray(x), device=dev)
                      for x in (R_chess_cam, t_chess_cam, R_slam_cam,
                                t_slam_cam))
    dt = torch.promote_types(Rc.dtype, Rs.dtype)
    Rc, tc, Rs, ts = (x.to(device=dev, dtype=dt) for x in (Rc, tc, Rs, ts))
    R_wc = Rc.T
    t_wc = -R_wc @ tc
    R_m = R_wc @ Rs
    t_m = R_wc @ ts + t_wc
    return R_m.to(torch.float32), t_m.to(torch.float32)


def rebase_map(state, R_m: torch.Tensor, t_m: torch.Tensor,
               scale: float = 1.0):
    """p' = s (R_m p + t_m) on the landmarks, Tcw' = Tcw M^-1 (the
    translation scaled) on the keyframes: the batched MapState form of
    ``TransformAllMapElements``. ``scale`` 1.0 is the fork's rigid rebase.
    On the device, no read."""
    kfs, lms = state.kfs, state.lms
    R_new = kfs.R @ R_m.T
    t_new = scale * (kfs.t - (R_new @ t_m[:, None])[..., 0])
    pos_new = scale * (lms.pos @ R_m.T + t_m)
    normal_new = lms.normal @ R_m.T
    kfs = kfs._replace(R=R_new, t=t_new)
    lms = lms._replace(pos=pos_new, normal=normal_new,
                       min_dist=lms.min_dist * scale,
                       max_dist=lms.max_dist * scale)
    return state._replace(kfs=kfs, lms=lms)
