"""The port's CLAHE (``ops/clahe.py``) against OpenCV's
``cv2.createCLAHE(3.0, (8, 8)).apply``, the TUM-VI and mono-inertial
runners' equalisation: bit-identical on random, gradient, constant and
blocky images at 752x480 (EuRoC), 512x512 (TUM-VI), 640x480 and a size
that is not a multiple of the tiles (OpenCV pads by reflection), and the
numpy version it is held against on the card equal to both.
"""

import cv2
import numpy as np
import pytest
import torch

from orbslam3_byzyh_tpu_torch.ops import clahe

torch.set_num_threads(2)

SIZES = [(480, 752), (512, 512), (480, 640), (101, 77)]
KINDS = ["random", "gradient", "constant", "blocks"]


def _image(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "gradient":
        return (np.add.outer(np.arange(h), np.arange(w)) * 255
                // (h + w)).astype(np.uint8)
    if kind == "constant":
        return np.full((h, w), 77, np.uint8)
    blocks = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1))
    return (blocks.repeat(8, 0).repeat(8, 1)[:h, :w] // 3 + 40).astype(
        np.uint8)


@pytest.mark.parametrize("h,w", SIZES, ids=lambda s: str(s))
@pytest.mark.parametrize("kind", KINDS)
def test_clahe_bit_identical_to_opencv(h, w, kind):
    img = _image(kind, h, w, h + w)
    ref = cv2.createCLAHE(3.0, (8, 8)).apply(img).astype(np.float32)
    # The runners hand it float32 images of uint8 values.
    out = clahe.Clahe(3.0, (8, 8)).apply(torch.from_numpy(
        img.astype(np.float32)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(clahe.clahe_plain(img), ref)


@pytest.mark.parametrize("clip,tiles", [(2.0, (4, 4)), (40.0, (8, 8)),
                                        (3.0, (6, 5))])
def test_other_settings(clip, tiles):
    img = _image("blocks", 120, 150, 3)
    ref = cv2.createCLAHE(clip, tiles).apply(img).astype(np.float32)
    out = clahe.Clahe(clip, tiles).apply(torch.from_numpy(img))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(clahe.clahe_plain(img, clip, tiles), ref)


def test_fractional_input_truncates_as_astype_uint8():
    """The JAX runners apply CLAHE to ``img.astype(np.uint8)``: fractions
    truncate."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255.99, (64, 64)).astype(np.float32)
    ref = cv2.createCLAHE(3.0, (8, 8)).apply(img.astype(np.uint8))
    out = clahe.Clahe().apply(torch.from_numpy(img))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.float32))
