"""The port's PNG codec (``io/png.py``) and P1's plain twin
(``ops/cuda_png.py``) against ``cv2.imread`` / ``cv2.imwrite``.

Bit for bit: grey 8 over all five row filters (cv2's files at every
compression level, and files built here with each filter on the rows),
grey 16 (``IMREAD_UNCHANGED``, and ``IMREAD_GRAYSCALE``'s high byte), RGB,
RGBA and grey + alpha to grey (libpng's fixed-point rule), odd widths and
one-row images; the writer read back by cv2; a ``ValueError`` naming the
file on interlaced, palette, truncated and bad-CRC files.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu_torch.io import png
from orbslam3_byzyh_tpu_torch.ops import cuda_png

torch.set_num_threads(2)


def _image(rng, h, w, c=None, dtype=np.uint8):
    hi = 256 if dtype == np.uint8 else 65536
    shape = (h, w) if c is None else (h, w, c)
    # Texture and ramps, so that every filter has both small and large
    # residuals.
    ramp = (np.add.outer(np.arange(h), 3 * np.arange(w)) % hi)
    if c is not None:
        ramp = ramp[..., None]
    return ((rng.integers(0, hi, shape) // 4 + ramp) % hi).astype(dtype)


def _filter_row(row, prev, ft, bpp):
    """PNG's forward filter of one row (uint8 bytes)."""
    r, p = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if ft == 0:
        pred = np.zeros_like(r)
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = p
    elif ft == 3:
        pred = (a + p) >> 1
    else:
        pa, pb, pc = (np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c))
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _build_png(img, ctype, depth, filters, interlace=0, plte=False,
               n_idat=1):
    """A PNG file of ``img`` with the given row filters (cycled)."""
    a = np.asarray(img)
    h = a.shape[0]
    if depth == 16:
        by = a.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        by = a.reshape(h, -1).astype(np.uint8)
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8
    rows, prev = [], np.zeros(by.shape[1], np.uint8)
    for r in range(h):
        ft = filters[r % len(filters)]
        rows.append(np.concatenate([[ft], _filter_row(by[r], prev, ft, bpp)])
                    .astype(np.uint8))
        prev = by[r]
    data = zlib.compress(np.stack(rows).tobytes(), 6)
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    w = a.shape[1]
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte:
        out += _chunk(b"PLTE", bytes(range(256)) * 3)
    for i in range(n_idat):
        out += _chunk(b"IDAT", data[cuts[i]:cuts[i + 1]])
    return out + _chunk(b"IEND", b"")


@pytest.mark.parametrize("level", range(10))
def test_grey8_cv2_files_every_compression(tmp_path, level):
    rng = np.random.default_rng(level)
    img = _image(rng, 120, 157)
    path = str(tmp_path / "g.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = png.read_grey(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.read_unchanged(path), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4), (4, 3, 2, 1)])
@pytest.mark.parametrize("ctype,c", [(0, None), (2, 3), (6, 4), (4, 2)])
def test_hand_built_filters(tmp_path, filters, ctype, c):
    """Every filter on 8-bit grey, RGB, RGBA and grey + alpha rows, against
    cv2's decode of the same file; the plain twin of P1 on the inflated
    scanlines gives the same image."""
    rng = np.random.default_rng(sum(filters) + 7 * ctype)
    img = _image(rng, 23, 41, c)
    path = tmp_path / "h.png"
    path.write_bytes(_build_png(img, ctype, 8, filters, n_idat=3))
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = png.read_grey(str(path))
    np.testing.assert_array_equal(got, ref)
    inf = png.inflate(str(path))
    assert set(inf.raw[:, 0].tolist()) == set(filters)
    twin = cuda_png.unfilter(torch.from_numpy(inf.raw.copy()), inf.width,
                             inf.bpp, inf.mode)
    np.testing.assert_array_equal(twin.numpy(), ref)


@pytest.mark.parametrize("filters", [(1,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_grey16(tmp_path, filters):
    rng = np.random.default_rng(3)
    img = _image(rng, 31, 19, dtype=np.uint16)
    path = tmp_path / "d.png"
    path.write_bytes(_build_png(img, 0, 16, filters))
    un = png.read_unchanged(str(path))
    assert un.dtype == np.uint16
    np.testing.assert_array_equal(un, cv2.imread(str(path),
                                                 cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(png.read_grey(str(path)),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    inf = png.inflate(str(path))
    twin = cuda_png.unfilter(torch.from_numpy(inf.raw.copy()), inf.width,
                             inf.bpp, inf.mode)
    np.testing.assert_array_equal(twin.numpy(), img.astype(np.float32))


@pytest.mark.parametrize("c", [3, 4])
def test_rgb_rgba_to_grey_as_cv2(tmp_path, c):
    rng = np.random.default_rng(c)
    img = _image(rng, 64, 80, c)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(png.read_grey(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 97), (37, 1), (5, 3), (11, 753)])
def test_odd_sizes(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    img = _image(rng, h, w)
    path = tmp_path / "o.png"
    path.write_bytes(_build_png(img, 0, 8, (4, 3, 1, 2, 0)))
    np.testing.assert_array_equal(png.read_grey(str(path)),
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_writer_read_back_by_cv2(tmp_path, dtype):
    rng = np.random.default_rng(5)
    img = _image(rng, 48, 75, dtype=dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert set(png.inflate(path).raw[:, 0].tolist()) == {1}   # Sub rows
    np.testing.assert_array_equal(png.read_unchanged(path), img)


@pytest.mark.parametrize("filters", [(0,), (2,), (3,), (4,), (4, 0, 3, 1, 2)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_writer_filters_read_back_by_cv2(tmp_path, filters, dtype):
    rng = np.random.default_rng(len(filters))
    img = _image(rng, 29, 33, dtype=dtype)
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filters=filters)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert set(png.inflate(path).raw[:, 0].tolist()) == set(filters)


def test_writer_rejects_other_arrays(tmp_path):
    # Grey 8 / 16 and 8-bit RGB are written (the viewer's RGB renders,
    # test_torch_viewer.py); anything else raises.
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.uint16),
                np.zeros((4, 4), np.float32), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.write_png(str(tmp_path / "x.png"), bad)


def _bad_files():
    rng = np.random.default_rng(9)
    img = _image(rng, 16, 16)
    good = _build_png(img, 0, 8, (1, 4))
    idat = good.index(b"IDAT")
    flipped = bytearray(good)
    flipped[idat + 10] ^= 0xFF
    return {
        "interlaced": (_build_png(img, 0, 8, (0,), interlace=1),
                       "interlaced"),
        "palette": (_build_png(img, 3, 8, (0,), plte=True), "palette"),
        "truncated": (good[:len(good) // 2], "truncated"),
        "bad_crc": (bytes(flipped), "CRC"),
        "no_signature": (b"GIF89a" + good[6:], "signature"),
    }


@pytest.mark.parametrize("kind", ["interlaced", "palette", "truncated",
                                  "bad_crc", "no_signature"])
def test_bad_files_raise_naming_the_file(tmp_path, kind):
    data, why = _bad_files()[kind]
    path = tmp_path / f"{kind}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        png.read_grey(str(path))
    assert str(path) in str(e.value) and why in str(e.value)


def test_kernel_wrapper_rejects_cpu_tensors():
    """P1's wrapper takes CUDA tensors only: no silent CPU run."""
    with pytest.raises(ValueError):
        cuda_png.unfilter_kernel(torch.zeros((4, 5), dtype=torch.uint8), 4,
                                 1, png.GREY8)


def test_cpu_decode_launches_no_kernel(tmp_path):
    cuda_png.KERNEL.launches = 0
    path = str(tmp_path / "k.png")
    png.write_png(path, np.zeros((8, 8), np.uint8))
    inf = png.inflate(path)
    cuda_png.unfilter(torch.from_numpy(inf.raw.copy()), 8, 1, png.GREY8)
    assert cuda_png.KERNEL.launches == 0
    assert cuda_png.bound_bytes(480, 752, 1) == 480 * 753 + 4 * 480 * 752
