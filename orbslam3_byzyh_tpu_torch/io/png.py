"""The port's own PNG codec: stdlib ``zlib`` and ``struct``, and numpy.

Stands in for ``cv2.imread`` / ``cv2.imwrite`` on the dataset path (the
card's machine has no OpenCV, Pillow or torchvision). A file is read in two
halves:

* :func:`inflate` (host): the chunks are parsed and their CRCs checked,
  IHDR's fields validated, the IDAT chunks joined and inflated with
  ``zlib.decompress`` into the filtered scanlines (each a filter byte and
  the row's bytes). zlib releases the GIL, so the prefetcher's worker
  threads run it in parallel.
* the unfilter and the conversion to the caller's samples: on the host by
  :func:`unfilter_plain` (numpy; the CPU path and the oracle of kernel P1)
  or on the card by ``ops.cuda_png`` (P1).

Supported: bit depth 8 grey, grey + alpha, RGB and RGBA, and bit depth 16
grey (big-endian), not interlaced. Anything else raises a ``ValueError``
naming the file and the reason; so does a truncated or corrupt file: a
wrong image is never returned.

The two ``cv2.imread`` modes the JAX loaders use:

* :func:`read_grey` (``IMREAD_GRAYSCALE``), float32: grey as it is; RGB and
  RGBA by libpng's fixed-point rule ``(9797 R + 19234 G + 3737 B) >> 15``
  (truncating; alpha dropped), which ``cv2.imread`` gives bit for bit; a
  16-bit sample's high byte.
* :func:`read_unchanged` (``IMREAD_UNCHANGED``) for grey files: uint8 or
  uint16 as stored.

:func:`write_png` writes grey 8 or 16, or 8-bit RGB (the viewer's
renders), with the Sub filter on every row, as ``cv2.imwrite`` does by
default (or any of the five filters on each row); :func:`read_rgb` reads
an RGB file back as it is.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Conversion modes (shared with csrc/png.cu): the output sample of a pixel.
GREY8 = 0       # the byte
GREY16 = 1      # the big-endian 16-bit sample
RGB8 = 2        # libpng's rgb_to_gray of R, G, B
RGBA8 = 3       # the same, alpha dropped
GREYA8 = 4      # the grey byte, alpha dropped
# libpng's rgb_to_gray weights for OpenCV's (0.299, 0.587): 32768 x
# 29900 / 100000 and 32768 x 58700 / 100000, truncated; blue the rest.
W_R, W_G, W_B = 9797, 19234, 3737

_MODES = {(0, 8): (GREY8, 1), (0, 16): (GREY16, 2), (2, 8): (RGB8, 3),
          (6, 8): (RGBA8, 4), (4, 8): (GREYA8, 2)}


@dataclasses.dataclass
class Inflated:
    """A PNG file's filtered scanlines and what is needed to unfilter and
    convert them. ``raw``: (height, 1 + rowbytes) uint8, column 0 the
    filter type of each row."""

    path: str
    width: int
    height: int
    bpp: int           # bytes a pixel (the filters' left distance)
    mode: int          # GREY8 | GREY16 | RGB8 | RGBA8 | GREYA8
    raw: np.ndarray

    @property
    def rowbytes(self) -> int:
        return self.width * self.bpp


def _fail(path, why):
    raise ValueError(f"{path}: not a PNG this reader takes: {why}")


def parse(data: bytes, path: str = "<bytes>") -> Inflated:
    """Parse and inflate the bytes of a PNG file (see the module doc)."""
    if data[:8] != SIGNATURE:
        _fail(path, "no PNG signature")
    pos, ihdr, idat, ended = 8, None, [], False
    while pos < len(data):
        if pos + 12 > len(data):
            _fail(path, "truncated chunk header")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 12 + n
        if end > len(data):
            _fail(path, f"truncated {kind!r} chunk")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:end])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            _fail(path, f"bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            if n != 13:
                _fail(path, "IHDR of the wrong length")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
            break
        elif kind == b"PLTE":
            _fail(path, "palette image")
        elif not kind[0] & 0x20:
            _fail(path, f"unknown critical chunk {kind!r}")
        pos = end
    if ihdr is None:
        _fail(path, "no IHDR chunk")
    if not ended:
        _fail(path, "truncated: no IEND chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype == 3:
        _fail(path, "palette image")
    if interlace != 0:
        _fail(path, "interlaced image")
    if comp != 0 or filt != 0:
        _fail(path, f"compression {comp} / filter method {filt}")
    if (ctype, depth) not in _MODES:
        _fail(path, f"colour type {ctype} at bit depth {depth}")
    if w == 0 or h == 0:
        _fail(path, "empty image")
    mode, bpp = _MODES[(ctype, depth)]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        _fail(path, f"corrupt image data ({e})")
    stride = 1 + w * bpp
    if len(raw) != h * stride:
        _fail(path, f"image data of {len(raw)} bytes, expected {h * stride}")
    raw = np.frombuffer(raw, np.uint8).reshape(h, stride)
    if int(raw[:, 0].max()) > 4:
        _fail(path, f"unknown row filter {int(raw[:, 0].max())}")
    return Inflated(path, w, h, bpp, mode, raw)


def inflate(path: str) -> Inflated:
    """Read, check and inflate the PNG file at ``path``."""
    with open(path, "rb") as f:
        return parse(f.read(), path)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(inf: Inflated) -> np.ndarray:
    """The plain unfilter: (height, rowbytes) uint8 reconstructed bytes.
    None, Sub (a cumulative sum mod 256 per byte lane) and Up are
    vectorised; Average and Paeth, sequential along the row, run per
    byte."""
    h, n, bpp = inf.height, inf.rowbytes, inf.bpp
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for r in range(h):
        ft, row = int(inf.raw[r, 0]), inf.raw[r, 1:]
        if ft == 0:
            cur = row.copy()
        elif ft == 1:
            lanes = np.zeros(((n + bpp - 1) // bpp) * bpp, np.uint64)
            lanes[:n] = row
            cur = (np.cumsum(lanes.reshape(-1, bpp), 0) % 256).astype(
                np.uint8).reshape(-1)[:n]
        elif ft == 2:
            cur = row + prev                      # uint8 wraps mod 256
        else:
            cur, up = row.tolist(), prev.tolist()
            for x in range(n):
                a = cur[x - bpp] if x >= bpp else 0
                if ft == 3:
                    cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, up[x], c)) & 0xFF
            cur = np.asarray(cur, np.uint8)
        out[r] = cur
        prev = cur
    return out


def samples_plain(inf: Inflated, recon: np.ndarray) -> np.ndarray:
    """Reconstructed bytes -> one sample a pixel (uint8, or uint16 for 16-bit
    grey): the conversion P1 fuses into its unfilter."""
    h, w = inf.height, inf.width
    if inf.mode == GREY8:
        return recon.reshape(h, w)
    if inf.mode == GREY16:
        b = recon.reshape(h, w, 2).astype(np.uint16)
        return (b[..., 0] << 8) | b[..., 1]
    if inf.mode == GREYA8:
        return recon.reshape(h, w, 2)[..., 0].copy()
    px = recon.reshape(h, w, inf.bpp).astype(np.uint32)
    return ((W_R * px[..., 0] + W_G * px[..., 1] + W_B * px[..., 2])
            >> 15).astype(np.uint8)


def decode_plain(inf: Inflated) -> np.ndarray:
    """The file's samples as float32 (grey, or the 16-bit value): what P1
    writes on the card."""
    return samples_plain(inf, unfilter_plain(inf)).astype(np.float32)


def read_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)`` of a grey file: uint8 or
    uint16 (TUM's depth images)."""
    inf = inflate(path)
    if inf.mode not in (GREY8, GREY16):
        _fail(path, "read_unchanged takes grey files only")
    return samples_plain(inf, unfilter_plain(inf))


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit RGB file's (h, w, 3) uint8 samples as stored."""
    inf = inflate(path)
    if inf.mode != RGB8:
        _fail(path, "read_rgb takes 8-bit RGB files only")
    return unfilter_plain(inf).reshape(inf.height, inf.width, 3)


def read_grey(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_GRAYSCALE).astype(np.float32)``."""
    inf = inflate(path)
    s = samples_plain(inf, unfilter_plain(inf))
    if inf.mode == GREY16:
        s = s >> 8
    return s.astype(np.float32)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def filter_rows(by: np.ndarray, bpp: int, filters) -> np.ndarray:
    """PNG's forward filters: (h, rowbytes) uint8 bytes -> (h, 1 +
    rowbytes) scanlines, row r filtered with ``filters[r % len(filters)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; all vectorised: the forward
    filters read the original bytes)."""
    r = by.astype(np.int32)
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    c = np.zeros_like(r)
    c[:, bpp:] = up[:, :-bpp]
    pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    preds = np.stack([np.zeros_like(r), a, up, (a + up) >> 1, paeth])
    ft = np.asarray(filters, np.int64)[np.arange(len(r)) % len(filters)]
    res = (r - preds[ft, np.arange(len(r))]) & 0xFF
    return np.concatenate([ft[:, None], res], 1).astype(np.uint8)


def write_png(path: str, image: np.ndarray, level: int = 6,
              filters=(1,)) -> None:
    """Write a (h, w) uint8 or uint16 array as a grey PNG of bit depth 8 or
    16, or a (h, w, 3) uint8 array as an 8-bit RGB PNG (colour type 2),
    every row with the Sub filter (``cv2.imwrite``'s default), or row r
    with ``filters[r % len(filters)]``."""
    a = np.asarray(image)
    rgb = a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8
    if (not rgb and (a.ndim != 2 or a.dtype not in (np.uint8, np.uint16))
            or 0 in a.shape):
        raise ValueError(f"{path}: write_png takes a non-empty (h, w) uint8 "
                         f"or uint16 array or an (h, w, 3) uint8 one, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    depth = 8 if a.dtype == np.uint8 else 16
    by = (a if depth == 8 else a.astype(">u2")).view(np.uint8).reshape(h, -1)
    bpp = 3 if rgb else depth // 8
    rows = filter_rows(by, bpp, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if rgb else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))
