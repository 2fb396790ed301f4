"""Port parity: the map state (``models/map_state.py``) against the JAX
package's, function by function and exact, on the small EuRoC-mono map
(``graft.euroc_mono_map``); and the map's carry across
(``convert.map_state_to_torch`` / ``map_state_to_numpy``) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_feats, jax_map_state, n, small_map, t

from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms


@pytest.fixture(scope="module")
def scene():
    return small_map("full")


def _np_state(state):
    """Either package's state -> numpy leaves with the JAX dtypes."""
    if isinstance(state.kfs.R, torch.Tensor):
        return convert.map_state_to_numpy(state)
    return jms.MapState(*(type(g)(*(np.asarray(a) for a in g))
                          for g in state))


def _assert_equal_states(ref, got):
    ref, got = _np_state(ref), _np_state(got)
    for group in ("kfs", "lms", "obs"):
        for name in getattr(ref, group)._fields:
            x = getattr(getattr(ref, group), name)
            y = getattr(getattr(got, group), name)
            assert x.dtype == y.dtype, (group, name, x.dtype, y.dtype)
            np.testing.assert_array_equal(y, x, err_msg=f"{group}.{name}")


def test_convert_round_trip_bit_exact(scene):
    st = convert.map_state_to_torch(scene.state, "cpu")
    assert st.kfs.kp_desc.dtype == torch.int32
    assert st.lms.desc.dtype == torch.int32
    assert st.obs.valid.dtype == torch.bool
    _assert_equal_states(scene.state, convert.map_state_to_numpy(st))
    # And from the JAX package's own arrays.
    back = convert.map_state_to_numpy(
        convert.map_state_to_torch(jax_map_state(scene.state), "cpu"))
    _assert_equal_states(scene.state, back)


def test_map_state_default_device_is_the_card(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.map_state_to_torch(scene.state)


def test_empty_map_exact():
    _assert_equal_states(jms.empty_map(16, 64, 6, 32),
                         tms.empty_map(16, 64, 6, 32, device="cpu"))


def test_add_keyframe_exact(scene):
    ref = jms.add_keyframe(jax_map_state(scene.state), scene.kf_id,
                           jnp.asarray(scene.R), jnp.asarray(scene.t),
                           scene.stamp, jax_feats(scene.feats))
    a = graft.mono_map_args(scene, "cpu")
    got = tms.add_keyframe(a[0], scene.kf_id, a[2], a[3], a[4], a[5])
    _assert_equal_states(ref, got)
    # A 0-d tensor slot writes the same row.
    got2 = tms.add_keyframe(a[0], torch.tensor(scene.kf_id), a[2], a[3],
                            a[4], a[5])
    _assert_equal_states(ref, got2)
    # The caller's state is not written.
    assert not bool(a[0].kfs.valid[scene.kf_id])


def test_add_landmarks_exact_and_clears_recycled_rows(scene, rng):
    """Recycled slots (live rows overwritten, stale observations beyond the
    first two cleared) and masked rows, as test_lm_valve.py checks."""
    L = scene.state.lms.valid.shape[0]
    m = 40
    slots = rng.choice(L, m, replace=False).astype(np.int32)
    mask = rng.random(m) < 0.8
    pos = rng.normal(0, 5, (m, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    kp_a = rng.integers(0, 256, m).astype(np.int32)
    kp_b = rng.integers(0, 256, m).astype(np.int32)
    normal = rng.normal(0, 1, (m, 3)).astype(np.float32)
    md = rng.uniform(0.1, 1, m).astype(np.float32)
    xd = rng.uniform(5, 50, m).astype(np.float32)
    kf_b = rng.integers(0, 24, m).astype(np.int32)
    J = jnp.asarray
    ref = jms.add_landmarks(jax_map_state(scene.state), J(slots), J(pos),
                            J(desc), 24, J(kp_a), J(kf_b), J(kp_b), J(mask),
                            J(normal), J(md), J(xd))
    got = tms.add_landmarks(convert.map_state_to_torch(scene.state, "cpu"),
                            t(slots), t(pos), t(desc), 24, t(kp_a), t(kf_b),
                            t(kp_b), t(mask), t(normal), t(md), t(xd))
    _assert_equal_states(ref, got)
    assert (scene.state.obs.valid[slots[mask]].sum(1) > 2).any()
    assert (_np_state(got).obs.valid[slots[mask]].sum(1) == 2).all()


def test_add_observations_exact(scene, rng):
    """Appends at each row's first free slot; full rows and masked rows
    are left alone."""
    L = scene.state.lms.valid.shape[0]
    lm = rng.choice(L, 300, replace=False).astype(np.int32)
    kp = rng.integers(0, 256, 300).astype(np.int32)
    mask = rng.random(300) < 0.9
    state = scene.state
    full = state.obs.valid.all(1)[lm]
    assert full.any() and (~full).any()
    ref = jms.add_observations(jax_map_state(state), jnp.asarray(lm), 24,
                               jnp.asarray(kp), jnp.asarray(mask))
    got = tms.add_observations(convert.map_state_to_torch(state, "cpu"),
                               t(lm), 24, t(kp), t(mask))
    _assert_equal_states(ref, got)


@pytest.mark.parametrize("kf", [0, 11, 12, 23, 24])
def test_covisibility_and_seen_by_exact(scene, kf):
    js = jax_map_state(scene.state)
    ts = convert.map_state_to_torch(scene.state, "cpu")
    max_kf = scene.state.kfs.valid.shape[0]
    np.testing.assert_array_equal(
        n(tms.covisibility_counts(ts, kf, max_kf)),
        np.asarray(jms.covisibility_counts(js, kf, max_kf)))
    seen_j, kp_j = jms.landmarks_seen_by(js, kf)
    seen_t, kp_t = tms.landmarks_seen_by(ts, kf)
    np.testing.assert_array_equal(n(seen_t), np.asarray(seen_j))
    np.testing.assert_array_equal(n(kp_t), np.asarray(kp_j))


def test_check_invariants_matches(scene):
    n_kf, L = scene.kf_id, scene.state.lms.valid.shape[0]
    js = jax_map_state(scene.state)
    ts = convert.map_state_to_torch(scene.state, "cpu")
    assert tms.check_invariants(ts, n_kf, L) == jms.check_invariants(
        js, n_kf, L) == []
    # A broken map: a dead observer, a live landmark without observations,
    # liveness past the cursor.
    kf_valid = scene.state.kfs.valid.copy()
    kf_valid[3] = False
    kf_valid[n_kf + 2] = True
    lm_valid = scene.state.lms.valid.copy()
    obs_valid = scene.state.obs.valid.copy()
    row = np.flatnonzero(lm_valid)[0]
    obs_valid[row] = False
    bad = scene.state._replace(
        kfs=scene.state.kfs._replace(valid=kf_valid),
        obs=scene.state.obs._replace(valid=obs_valid))
    want = jms.check_invariants(jax_map_state(bad), n_kf, L)
    assert len(want) == 3
    assert tms.check_invariants(convert.map_state_to_torch(bad, "cpu"),
                                n_kf, L) == want


def test_scatter_rows_drops_the_sentinel():
    x = torch.arange(5, dtype=torch.int32)
    out = tms.scatter_rows(x, torch.tensor([4, 5, 0, 5]),
                           torch.tensor([40, 50, 7, 60], dtype=torch.int32))
    assert out.tolist() == [7, 1, 2, 3, 40] and x.tolist() == [0, 1, 2, 3, 4]
    acc = tms.scatter_rows(x, torch.tensor([1, 1, 5]), 1, accumulate=True)
    assert acc.tolist() == [0, 3, 2, 3, 4]
