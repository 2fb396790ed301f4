"""Port parity: the tracking slice (extraction + local-map tracking + pose
optimization) against the JAX package on the lifted scene, and the port's
own ``tracking_step`` at full size on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu import graft as jgraft
from orbslam3_byzyh_tpu.ops import fast_orb as jfo
from orbslam3_byzyh_tpu.pipeline import tracking as jtr
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo
from orbslam3_byzyh_tpu_torch.pipeline import tracking as ttr

H, W, N_FEAT, N_LM = 240, 320, 256, 1024


@pytest.fixture(scope="module")
def small():
    """JAX features of the small example image and the scene lifted from
    them, as numpy."""
    img = graft.example_arrays(H, W, N_LM)[0]
    f = jfo.extract(jnp.asarray(img), n_features=N_FEAT)
    feats = tuple(np.asarray(a) for a in (f.xy, f.level, f.desc, f.valid))
    return feats, graft.lifted_scene(*feats, h=H, w=W, n_lm=N_LM)


def _jax_track(scene, feats):
    _, R0, t0, *lm, cam = scene
    bind = jnp.full((N_FEAT,), -1, jnp.int32)
    return jtr.track_local_map(
        jnp.asarray(R0), jnp.asarray(t0), bind, *[jnp.asarray(a) for a in lm],
        *[jnp.asarray(a) for a in feats], jnp.asarray(cam), W, H)


def _port_track(scene, feats):
    _, R0, t0, *lm, cam = convert.tree_to_torch(scene, "cpu")
    bind = torch.full((N_FEAT,), -1, dtype=torch.int32)
    return ttr.track_local_map(R0, t0, bind, *lm, *feats, cam, W, H)


def test_track_local_map_on_jax_features(small):
    feats, scene = small
    ref = _jax_track(scene, feats)
    out = _port_track(scene, convert.tree_to_torch(feats, "cpu"))
    np.testing.assert_array_equal(n(out.bindings), n(ref.bindings))
    assert int(out.n_inliers) == int(ref.n_inliers) > 0.8 * N_FEAT
    # Same matches; the pose differs only by the float32 solver path.
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=1e-4)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=1e-4)


def test_slice_end_to_end(small):
    feats, scene = small
    ref = _jax_track(scene, feats)
    f = tfo.extract(t(scene[0]), n_features=N_FEAT)
    out = _port_track(scene, (f.xy, f.level, f.desc, f.valid))
    # Stated tolerance: features may differ in a few descriptor bits, so a
    # couple of matches may change; the pose then moves a little.
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=1e-3)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=1e-3)


def test_example_args_match_jax():
    ref = jgraft.example_tracking_args(48, 64, 32)
    out = graft.example_tracking_args(48, 64, 32, device="cpu")
    for a, b in zip(out, ref):
        b = np.asarray(b)
        a = n(a).view(np.uint32) if b.dtype == np.uint32 else n(a)
        # The normals divide by a float32 norm summed in another order.
        np.testing.assert_allclose(a, b, rtol=1e-6)
        assert a.shape == b.shape


def test_tracking_step_full_size_cpu():
    """The port's entry point at 480x640, 1024 features, 4096 landmarks,
    through the plain versions: the lifted scene tracks back to the
    identity pose."""
    img = t(graft.example_arrays()[0])
    f = tfo.extract(img, n_features=graft.N_FEATURES)
    scene = graft.lifted_scene(n(f.xy), n(f.level), n(f.desc), n(f.valid))
    R, tt, n_inl = graft.tracking_step(*convert.tree_to_torch(scene, "cpu"))
    assert int(n_inl) >= 900
    np.testing.assert_allclose(n(R), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(n(tt), 0.0, atol=1e-3)
    # The random example map does not track: a single inlier.
    _, _, n_ex = graft.tracking_step(*graft.example_tracking_args(device="cpu"))
    assert int(n_ex) <= 2
