"""Port parity: ORB extraction stage by stage, K1's plain version, and
``extract`` end to end, against the JAX package.

Each stage is fed the JAX stage's own input, so one resize rounding cannot
cascade. Integer and selection stages must agree exactly; float stages
within the stated tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, popcount_rows, t

from orbslam3_byzyh_tpu.ops import fast_orb as jfo
from orbslam3_byzyh_tpu.ops import pallas_brief
from orbslam3_byzyh_tpu_torch import graft
from orbslam3_byzyh_tpu_torch.ops import cuda_brief
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo

H, W, N_FEAT = 240, 320, 256

# Each JAX stage jitted whole: one compile per shape instead of one per op.
_j_pyramid = jax.jit(jfo.build_pyramid, static_argnums=(1, 2))
_j_select = jax.jit(jfo.select_keypoints, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _j_score_stages(img, border=jfo.EDGE_THRESHOLD):
    s = jfo.fast_score_map(img)
    b = jfo._border_mask(s, border)
    c = jfo._cell_threshold(b)
    return s, b, c, jfo._nms3(c)


@pytest.fixture(scope="module")
def image():
    return graft.example_arrays(H, W, 16)[0]


@pytest.fixture(scope="module")
def jax_levels(image):
    return [np.asarray(x) for x in _j_pyramid(jnp.asarray(image), 8, 1.2)]


def _same_trig_angles(rng, k):
    """Angles whose float32 cos and sin agree bit for bit between XLA and
    torch (about 5% differ by one ulp); the sampler is then compared on
    identical inputs."""
    a = rng.uniform(-np.pi, np.pi, 4 * k).astype(np.float32)
    ok = ((n(jnp.cos(a)) == n(torch.cos(t(a))))
          & (n(jnp.sin(a)) == n(torch.sin(t(a)))))
    return a[ok][:k]


@pytest.mark.parametrize("shape", [(480, 640, 1024), (240, 320, 256),
                                   (120, 160, 500)])
def test_level_tables(shape):
    h, w, nf = shape
    assert tfo.level_sizes(h, w, 8, 1.2) == jfo.level_sizes(h, w, 8, 1.2)
    assert (tfo.level_feature_budget(nf, 8, 1.2)
            == jfo.level_feature_budget(nf, 8, 1.2))


def test_build_pyramid(image, jax_levels):
    out = tfo.build_pyramid(t(image), 8, 1.2)
    # F.interpolate weighs in float32 where the JAX plan weighs in float64,
    # and the 7 resizes chain: 1e-2 grey levels on a 0-255 scale.
    for ref, lvl in zip(jax_levels, out):
        assert lvl.shape == ref.shape
        np.testing.assert_allclose(n(lvl), ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("lv", [0, 3, 7])
def test_score_stages_exact(jax_levels, lv):
    img = jax_levels[lv]
    s, b, c, m = _j_score_stages(jnp.asarray(img))
    np.testing.assert_array_equal(n(tfo.fast_score_map(t(img))), n(s))
    np.testing.assert_array_equal(
        n(tfo._border_mask(t(s), tfo.EDGE_THRESHOLD)), n(b))
    np.testing.assert_array_equal(n(tfo._cell_threshold(t(b))), n(c))
    np.testing.assert_array_equal(n(tfo._nms3(t(c))), n(m))


@pytest.mark.parametrize("case", ["level0", "small_level", "one_tile"])
def test_select_keypoints_exact(jax_levels, case):
    """Both JAX branches: iterative argmax (k <= 16) and lax.top_k, with
    many tied zero scores."""
    img, cap = {"level0": (jax_levels[0], 60),
                "small_level": (jax_levels[7], 17),
                "one_tile": (jax_levels[0][40:72, 40:72], 64)}[case]
    s = _j_score_stages(jnp.asarray(img), 4)[3]
    ref = _j_select(s, cap)
    out = tfo.select_keypoints(t(s), cap)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), n(b))


def test_blur_and_moments(jax_levels):
    for img in jax_levels[:3]:
        blur = tfo.gaussian_blur(t(img))
        # Same taps, other summation order: float32 rounding on 0-255.
        np.testing.assert_allclose(
            n(blur), n(jfo._sep_conv2d(jnp.asarray(img), jfo._GAUSS1D)),
            rtol=0, atol=1e-4)
        m10, m01 = tfo.orientation_maps(t(img))
        r10, r01 = jfo.orientation_maps(jnp.asarray(img))
        # The JAX package takes the moments from row prefix sums, which lose
        # ~5e-5 of the moments' range in float32; the port convolves.
        for a, b in ((m10, r10), (m01, r01)):
            scale = np.abs(n(b)).max()
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-4 * scale)


def test_pattern_positions_and_packing_exact(rng, jax_levels):
    img = jax_levels[1]
    h, w = img.shape
    k = 96
    angle = _same_trig_angles(rng, k)
    xy = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)],
                  -1).astype(np.float32)
    gy, gx = jfo._pattern_positions(jnp.asarray(xy), jnp.asarray(angle), w, h)
    ty, tx = tfo._pattern_positions(t(xy), torch.cos(t(angle)),
                                    torch.sin(t(angle)), torch.tensor(float(w)),
                                    torch.tensor(float(h)))
    np.testing.assert_array_equal(n(ty), n(gy))
    np.testing.assert_array_equal(n(tx), n(gx))
    bits = rng.random((k, 256)) < 0.5
    ref = n(jfo._pack_bits(jnp.asarray(bits, jnp.float32)))
    np.testing.assert_array_equal(n(tfo._pack_bits(t(bits))).view(np.uint32),
                                  ref)


def _multi_level_keypoints(rng, levels, per_level, margin):
    xy, lvl = [], []
    for i, img in enumerate(levels):
        h, w = img.shape
        xy.append(np.stack([rng.integers(margin, w - margin, per_level),
                            rng.integers(margin, h - margin, per_level)], -1))
        lvl.append(np.full(per_level, i, np.int32))
    return np.concatenate(xy).astype(np.float32), np.concatenate(lvl)


@pytest.mark.parametrize("witness", ["pallas_interpret", "xla_gather"])
def test_brief_plain_matches_jax(rng, jax_levels, witness):
    """K1's plain version (all levels in one call) against the Pallas
    kernel in interpret mode and against the XLA gather path."""
    levels = jax_levels[:4]
    blurred = [n(jfo._sep_conv2d(jnp.asarray(x), jfo._GAUSS1D)) for x in levels]
    xy, lvl = _multi_level_keypoints(rng, levels, 24, margin=20)
    angle = _same_trig_angles(rng, xy.shape[0])
    ca, sa = n(torch.cos(t(angle))), n(torch.sin(t(angle)))
    out = cuda_brief.brief_descriptors_plain(
        [t(b) for b in blurred], t(xy), t(lvl), t(angle))
    ref = []
    for i, b in enumerate(blurred):
        sel = lvl == i
        h, w = b.shape
        if witness == "pallas_interpret":
            ix = jnp.asarray(np.round(xy[sel, 0]).astype(np.int32))
            iy = jnp.asarray(np.round(xy[sel, 1]).astype(np.int32))
            vals = pallas_brief.brief_sample(
                jnp.asarray(b), ix, iy, jnp.asarray(ca[sel]),
                jnp.asarray(sa[sel]), jnp.round(jnp.asarray(xy[sel, 1])),
                jnp.round(jnp.asarray(xy[sel, 0])), interpret=True)
        else:
            gy, gx = jfo._pattern_positions(jnp.asarray(xy[sel]),
                                            jnp.asarray(angle[sel]), w, h)
            vals = jnp.asarray(b).reshape(-1)[gy * w + gx]
        ref.append(n(jfo._pack_bits(
            (vals[:, :256] < vals[:, 256:]).astype(jnp.float32))))
    np.testing.assert_array_equal(n(out).view(np.uint32), np.concatenate(ref))


def test_brief_dispatch_cpu_uses_plain(rng, jax_levels):
    img = jax_levels[2]
    b = tfo.gaussian_blur(t(img))
    xy, lvl = _multi_level_keypoints(rng, [img], 16, margin=0)
    angle = t(rng.uniform(-np.pi, np.pi, 16).astype(np.float32))
    before = cuda_brief.KERNEL.launches
    out = cuda_brief.brief_descriptors([b], t(xy), t(lvl), angle)
    ref = cuda_brief.brief_descriptors_plain([b], t(xy), t(lvl), angle)
    assert torch.equal(out, ref)
    assert cuda_brief.KERNEL.launches == before


def test_extract_end_to_end(image):
    ref = jfo.extract(jnp.asarray(image), n_features=N_FEAT)
    out = tfo.extract(t(image), n_features=N_FEAT)
    assert out.desc.dtype == torch.int32 and out.desc.shape == (N_FEAT, 8)
    key = {(float(x), float(y), int(lv)): i for i, ((x, y), lv, v) in
           enumerate(zip(n(ref.xy), n(ref.level), n(ref.valid))) if v}
    same, dists = 0, []
    for i, ((x, y), lv, v) in enumerate(zip(n(out.xy), n(out.level),
                                            n(out.valid))):
        j = key.get((float(x), float(y), int(lv)))
        if v and j is not None:
            same += 1
            dists.append(popcount_rows(n(ref.desc)[j:j + 1],
                                       n(out.desc)[i:i + 1])[0])
    # Stated tolerance: >= 97% of valid keypoints at the same (x, y, level);
    # their descriptors within Hamming 4 (the angles differ by the JAX
    # moments' float32 error, which moves a few rotated samples).
    assert same >= 0.97 * n(ref.valid).sum()
    assert max(dists) <= 4
