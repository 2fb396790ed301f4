"""Contrast-limited adaptive histogram equalisation without OpenCV.

The TUM-VI and the mono-inertial runners apply ``cv2.createCLAHE(3.0, (8,
8)).apply`` to each frame (``scripts/run_tumvi.py:126-131``,
``run_euroc_mono_inertial.py:105``); the card's machine has no OpenCV.
:class:`Clahe` is OpenCV's algorithm (``imgproc/src/clahe.cpp``) for 8-bit
images in torch operations on the image's device, with no
synchronisation:

* the image is padded by reflection (BORDER_REFLECT_101) at the bottom and
  the right to a multiple of the tiles when it is not one;
* a 256-bin histogram a tile, clipped at ``max(int(clip * tile_area /
  256), 1)``; the clipped excess spread evenly over the bins, and its
  residual one a bin from bin 0 at a step of ``max(256 // residual, 1)``;
* the LUT ``saturate_cast<uchar>(cdf * (255.f / tile_area))`` (float32,
  rounded half to even);
* each pixel interpolated between the LUTs of the four nearest tile
  centres at ``x * (1.f / tile_w) - 0.5f``, clamped at the edges, in
  float32 in OpenCV's order of operations, rounded half to even.

:func:`clahe_plain` is the same algorithm written per tile in numpy, the
version it is held against.
"""

from __future__ import annotations

import numpy as np
import torch

HIST = 256


class Clahe:
    """``cv2.createCLAHE(clip_limit, tiles)``; ``apply`` takes an image of
    uint8 values (any dtype) on any device and returns float32 values."""

    def __init__(self, clip_limit: float = 3.0, tiles=(8, 8)):
        self.clip_limit = float(clip_limit)
        self.tiles_x, self.tiles_y = int(tiles[0]), int(tiles[1])

    def apply(self, img: torch.Tensor) -> torch.Tensor:
        ty, tx = self.tiles_y, self.tiles_x
        src = img.to(torch.uint8)
        h, w = src.shape
        ext = self._pad(src)
        eh, ew = ext.shape
        th, tw = eh // ty, ew // tx
        area = th * tw
        dev = src.device
        # Histograms: one 256-bin row a tile (scatter-add, no read back).
        tiles = ext.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(
            ty * tx, area).long()
        base = torch.arange(ty * tx, device=dev)[:, None] * HIST
        hist = torch.zeros(ty * tx * HIST, dtype=torch.int64, device=dev)
        hist.index_add_(0, (tiles + base).reshape(-1),
                        torch.ones(tiles.numel(), dtype=torch.int64,
                                   device=dev))
        hist = hist.reshape(ty * tx, HIST)
        if self.clip_limit > 0:
            limit = max(int(self.clip_limit * area / HIST), 1)
            clipped = (hist - limit).clamp_min(0).sum(1, keepdim=True)
            hist = hist.clamp_max(limit)
            batch = clipped // HIST
            residual = clipped - batch * HIST
            hist = hist + batch
            step = (HIST // residual.clamp_min(1)).clamp_min(1)
            i = torch.arange(HIST, device=dev)[None, :]
            extra = (residual > 0) & (i % step == 0) & (i // step < residual)
            hist = hist + extra.long()
        # Python floats of float32 values: a float32 tensor's scalar operand
        # is taken in float32, and no host value is copied to the device.
        scale = float(np.float32(HIST - 1) / np.float32(area))
        lut = torch.round(hist.cumsum(1).to(torch.float32) * scale).clamp(
            0, 255).reshape(ty, tx, HIST)
        # Interpolation between the four nearest tile centres (float32).
        inv_tw = float(np.float32(1.0) / np.float32(tw))
        inv_th = float(np.float32(1.0) / np.float32(th))
        txf = torch.arange(w, device=dev, dtype=torch.float32) * inv_tw - 0.5
        tyf = torch.arange(h, device=dev, dtype=torch.float32) * inv_th - 0.5
        tx1, ty1 = torch.floor(txf), torch.floor(tyf)
        xa, ya = txf - tx1, tyf - ty1
        xa1, ya1 = 1.0 - xa, 1.0 - ya
        tx2 = (tx1 + 1).clamp_max(tx - 1).long()
        ty2 = (ty1 + 1).clamp_max(ty - 1).long()
        tx1, ty1 = tx1.clamp_min(0).long(), ty1.clamp_min(0).long()
        v = src.long()
        flat = lut.reshape(-1)

        def at(ty_, tx_):
            return flat[(ty_[:, None] * tx + tx_[None, :]) * HIST + v]

        res = ((at(ty1, tx1) * xa1[None, :] + at(ty1, tx2) * xa[None, :])
               * ya1[:, None]
               + (at(ty2, tx1) * xa1[None, :] + at(ty2, tx2) * xa[None, :])
               * ya[:, None])
        return torch.round(res).clamp(0, 255)

    def _pad(self, src):
        h, w = src.shape
        if h % self.tiles_y == 0 and w % self.tiles_x == 0:
            return src
        # OpenCV pads both sides by tiles - (size % tiles) once either size
        # is not a multiple.
        ph = self.tiles_y - h % self.tiles_y
        pw = self.tiles_x - w % self.tiles_x
        dev = src.device
        rows = torch.cat([torch.arange(h, device=dev),
                          h - 2 - torch.arange(ph, device=dev)]).abs()
        cols = torch.cat([torch.arange(w, device=dev),
                          w - 2 - torch.arange(pw, device=dev)]).abs()
        return src[rows][:, cols]


def clahe_plain(img, clip_limit: float = 3.0, tiles=(8, 8)) -> np.ndarray:
    """The same algorithm per tile and per pixel row in numpy (float32
    arithmetic where OpenCV has it): the version :class:`Clahe` is held
    against. Returns float32 values."""
    tx, ty = tiles
    src = np.asarray(img).astype(np.uint8)
    h, w = src.shape
    if h % ty or w % tx:
        ph, pw = ty - h % ty, tx - w % tx
        rows = np.abs(np.concatenate([np.arange(h), h - 2 - np.arange(ph)]))
        cols = np.abs(np.concatenate([np.arange(w), w - 2 - np.arange(pw)]))
        ext = src[rows][:, cols]
    else:
        ext = src
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    limit = max(int(clip_limit * area / HIST), 1) if clip_limit > 0 else 0
    scale = np.float32(HIST - 1) / np.float32(area)
    lut = np.zeros((ty, tx, HIST), np.float32)
    for j in range(ty):
        for i in range(tx):
            hist = np.bincount(ext[j * th:(j + 1) * th,
                                   i * tw:(i + 1) * tw].ravel(),
                               minlength=HIST).astype(np.int64)
            if clip_limit > 0:
                clipped = int(np.maximum(hist - limit, 0).sum())
                hist = np.minimum(hist, limit)
                batch = clipped // HIST
                residual = clipped - batch * HIST
                hist += batch
                if residual:
                    step = max(HIST // residual, 1)
                    k = 0
                    while k < HIST and residual > 0:
                        hist[k] += 1
                        k += step
                        residual -= 1
            lut[j, i] = np.clip(np.round(
                np.cumsum(hist).astype(np.float32) * scale), 0, 255)
    out = np.zeros((h, w), np.float32)
    x = np.arange(w, dtype=np.float32)
    txf = x * (np.float32(1) / np.float32(tw)) - np.float32(0.5)
    tx1 = np.floor(txf)
    xa = (txf - tx1).astype(np.float32)
    xa1 = np.float32(1) - xa
    tx2 = np.minimum(tx1 + 1, tx - 1).astype(np.int64)
    tx1 = np.maximum(tx1, 0).astype(np.int64)
    for y in range(h):
        tyf = np.float32(y) * (np.float32(1) / np.float32(th)) - np.float32(
            0.5)
        ty1 = int(np.floor(tyf))
        ya = np.float32(tyf - np.float32(ty1))
        ya1 = np.float32(1) - ya
        ty2 = min(ty1 + 1, ty - 1)
        ty1 = max(ty1, 0)
        v = src[y].astype(np.int64)
        res = ((lut[ty1, tx1, v] * xa1 + lut[ty1, tx2, v] * xa) * ya1
               + (lut[ty2, tx1, v] * xa1 + lut[ty2, tx2, v] * xa) * ya)
        out[y] = np.clip(np.round(res), 0, 255)
    return out
