"""Port parity: the monocular system's host-side pieces against the JAX
package's, on the same numpy inputs.

* ``ops/lie.rot_to_quat`` (within 1e-6, on every branch of Shepperd's
  method) and ``io/trajectory`` (``save_tum`` writes the JAX package's
  stamps and positions, and its quaternions within float32 rounding;
  ``load_tum`` reads them back; test_io.py's round trip);
* ``pipeline/trajectory_log.TrajectoryLog``: test_trajectory_log.py's seven
  cases, run on the JAX package's class and on the port's;
* ``map_state.compact_keyframes`` / ``compact_landmarks`` and
  ``mapping.cull_candidate`` on a small ``graft.euroc_mono_map`` with
  planted dead keyframes and landmarks: the states equal (a compaction
  only moves rows), ``old2new`` and the counts equal, the candidate equal;
* ``models/atlas``: test_atlas.py's ``create_new_map`` and
  ``reset_active_map`` cases (that file is ``slow``), and ``merge`` waits
  for loop closing;
* ``utils/evaluate``: the Horn alignment and the ATE;
* the golden frames fixture (``tests/golden/frames_golden_mono.npz``): the
  frames ``tests/synth_world.py`` renders, bit for bit.
"""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import test_trajectory_log
import torch
from scipy.spatial.transform import Rotation
from torch_port_util import jax_map_state, n, small_map, t

from orbslam3_byzyh_tpu.io import trajectory as jtraj
from orbslam3_byzyh_tpu.models import map_state as jms
from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.pipeline import mapping as jmap
from orbslam3_byzyh_tpu.pipeline import trajectory_log as jtl
from orbslam3_byzyh_tpu.utils import evaluate as jev
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.io import trajectory as ttraj
from orbslam3_byzyh_tpu_torch.models import atlas as tatlas
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.ops import fast_orb as tfo
from orbslam3_byzyh_tpu_torch.ops import lie as tlie
from orbslam3_byzyh_tpu_torch.pipeline import mapping as tmap
from orbslam3_byzyh_tpu_torch.pipeline import trajectory_log as ttl
from orbslam3_byzyh_tpu_torch.utils import evaluate as tev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rotations(case):
    """Rotations that take each branch of Shepperd's method: a positive
    trace, and turns near pi about x, y and z (the largest diagonal entry
    picks the pivot)."""
    rng = np.random.default_rng(7)
    if case == "random":
        return Rotation.random(64, random_state=3).as_matrix()
    axis = {"x": 0, "y": 1, "z": 2}[case]
    w = rng.normal(0, 0.05, (16, 3))
    w[:, axis] = np.pi - rng.uniform(0, 0.3, 16)
    return Rotation.from_rotvec(w).as_matrix()


@pytest.mark.parametrize("case", ["random", "x", "y", "z"])
def test_rot_to_quat_matches_jax(case):
    R = _rotations(case).astype(np.float32)
    ref = np.asarray(jlie.rot_to_quat(jnp.asarray(R)))
    got = n(tlie.rot_to_quat(t(R)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if case != "random":
        tr = np.trace(R, axis1=1, axis2=2)
        assert (tr < 0).all()
    back = Rotation.from_quat(got.astype(np.float64)).as_matrix()
    np.testing.assert_allclose(back, R, atol=1e-5)


def _poses(rng, k=20):
    R = Rotation.random(k, random_state=int(rng.integers(1 << 30)))
    return (R.as_matrix().astype(np.float32),
            rng.normal(0, 2, (k, 3)).astype(np.float32))


@pytest.mark.parametrize("scale", [1.0, 1e9])
def test_save_tum_writes_the_jax_lines(tmp_path, rng, scale):
    """Relative float stamps (the system's), written in seconds and in
    EuRoC's nanoseconds: the stamp and the position of each line are the
    JAX package's text; the quaternion (float32 in both) within 3e-7, a few
    float32 units in the last place seen in the 7th decimal: torch's
    float32 square root and norm round differently from XLA's for a few
    percent of inputs."""
    R, tt = _poses(rng, 200)
    stamps = np.float32(0.05) * np.arange(len(R)) + 0.1
    jtraj.save_tum(str(tmp_path / "jax.txt"), stamps, R, tt,
                   stamp_scale=scale)
    ttraj.save_tum(str(tmp_path / "port.txt"), stamps, R, tt,
                   stamp_scale=scale)
    ref = (tmp_path / "jax.txt").read_text().splitlines()
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert len(got) == len(ref) == len(R)
    for a, b in zip(got, ref):
        a, b = a.split(), b.split()
        assert a[:4] == b[:4]
        np.testing.assert_allclose(np.float64(a[4:]), np.float64(b[4:]),
                                   atol=3e-7, rtol=0)


def test_tum_round_trip(tmp_path, rng):
    """test_io.py's TestTrajectoryIO on the port: the centres are -R^T t."""
    R, tt = _poses(rng, 10)
    stamps = np.arange(10) * 0.05
    path = str(tmp_path / "traj.txt")
    ttraj.save_tum(path, stamps, R, tt, stamp_scale=1e9)
    s, centres, quats = ttraj.load_tum(path)
    np.testing.assert_allclose(s / 1e9, stamps, atol=1e-6)
    np.testing.assert_allclose(centres, tev.camera_centers(R, tt), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-6)
    ref = jtraj.load_tum(path)
    for a, b in zip((s, centres, quats), ref):
        np.testing.assert_array_equal(a, b)


TRAJ_CASES = sorted(k for k in dir(test_trajectory_log)
                    if k.startswith("test_"))


def test_trajectory_log_cases_listed():
    assert len(TRAJ_CASES) == 7


@pytest.mark.parametrize("case", TRAJ_CASES)
def test_trajectory_log_matches_jax(case, monkeypatch):
    """Each of test_trajectory_log.py's cases on both classes, from the same
    random stream; the port's records equal the JAX package's."""
    logs = {}
    for name, cls in (("jax", jtl.TrajectoryLog), ("port", ttl.TrajectoryLog)):
        made = []

        def tracking(cls=cls, made=made):
            log = cls()
            made.append(log)
            return log

        monkeypatch.setattr(test_trajectory_log, "TrajectoryLog", tracking)
        getattr(test_trajectory_log, case)(np.random.default_rng(42))
        logs[name] = made
    for a, b in zip(logs["jax"], logs["port"]):
        assert (b.stamps, b.refs, b.tags) == (a.stamps, a.refs, a.tags)
        for x, y in zip(a.R_cr + a.t_cr, b.R_cr + b.t_cr):
            np.testing.assert_array_equal(y, x)


@functools.cache
def _planted_map():
    """The small EuRoC-mono map with keyframes 3, 7 and 15 culled (the JAX
    package's ``drop_keyframe``) and 5 % of the landmarks killed."""
    m = small_map()
    s = jax_map_state(m.state)
    for k in (3, 7, 15):
        s = jmap.drop_keyframe(s, jnp.asarray(k))
    rng = np.random.default_rng(1)
    kill = rng.random(s.lms.valid.shape[0]) < 0.05
    s = s._replace(lms=s.lms._replace(valid=s.lms.valid & ~jnp.asarray(kill)))
    return type(s)(*(type(g)(*(np.asarray(a) for a in g)) for g in s)), m


def _states_equal(ref, got):
    for group in ("kfs", "lms", "obs"):
        a, b = getattr(ref, group), getattr(got, group)
        for name in a._fields:
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            np.testing.assert_array_equal(y.view(x.dtype), x,
                                          err_msg=f"{group}.{name}")


@pytest.mark.parametrize("what", ["keyframes", "landmarks"])
def test_compaction_matches_jax(what):
    state, m = _planted_map()
    n_kf = m.kf_id
    n_lm = int(np.flatnonzero(state.lms.valid).max()) + 1
    jfn = getattr(jms, f"compact_{what}")
    tfn = getattr(tms, f"compact_{what}")
    count = n_kf if what == "keyframes" else n_lm
    ref, ref_o2n, ref_n = jfn(jax_map_state(state), count)
    got, o2n, n_valid = tfn(convert.map_state_to_torch(state, "cpu"), count)
    assert n_valid == ref_n
    assert n_valid < (n_kf if what == "keyframes" else n_lm)
    np.testing.assert_array_equal(o2n, ref_o2n)
    assert o2n.dtype == np.int32
    _states_equal(type(ref)(*(type(g)(*(np.asarray(a) for a in g))
                              for g in ref)),
                  convert.map_state_to_numpy(got))
    if what == "keyframes":
        assert tms.check_invariants(got, n_valid, n_lm) == []


@pytest.mark.parametrize("min_seen", [0, 30])
def test_cull_candidate_matches_jax(min_seen):
    state, _ = _planted_map()
    rng = np.random.default_rng(2)
    for _ in range(3):
        eligible = rng.random(state.kfs.valid.shape[0]) < 0.6
        ref = np.asarray(jmap.cull_candidate(jax_map_state(state),
                                             jnp.asarray(eligible),
                                             min_seen=min_seen))
        got = n(tmap.cull_candidate(convert.map_state_to_torch(state, "cpu"),
                                    t(eligible), min_seen=min_seen))
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.float32 and ref[1] >= 0
    none = np.zeros_like(eligible)
    got = n(tmap.cull_candidate(convert.map_state_to_torch(state, "cpu"),
                                t(none)))
    assert got[1] == -1


def _feats(rng, n_feat=64):
    return tfo.FrameFeatures(
        xy=t(rng.uniform(0, 100, (n_feat, 2)).astype(np.float32)),
        level=torch.zeros(n_feat, dtype=torch.int32),
        angle=torch.zeros(n_feat), response=torch.ones(n_feat),
        desc=t(rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)),
        valid=torch.ones(n_feat, dtype=torch.bool))


def _fill_map(at, rng, n_kf=3, n_lm=20):
    """test_atlas.py's fill_map, with the port's functions."""
    for k in range(n_kf):
        at.state = tms.add_keyframe(at.state, k, torch.eye(3),
                                    torch.tensor([0.1 * k, 0.0, 0.0]),
                                    float(k), _feats(rng))
    at.state = tms.add_landmarks(
        at.state, torch.arange(n_lm), t(rng.normal(size=(n_lm, 3))),
        t(rng.integers(0, 2 ** 32, (n_lm, 8), dtype=np.uint32)), 0,
        torch.arange(n_lm, dtype=torch.int32), 1,
        torch.arange(n_lm, dtype=torch.int32), torch.ones(n_lm, dtype=bool),
        torch.zeros(n_lm, 3), torch.zeros(n_lm), torch.full((n_lm,), 10.0))
    at.meta[at.current] = tatlas.MapMeta(n_kf=n_kf, n_lm=n_lm)


def test_atlas_create_new_map(rng):
    at = tatlas.Atlas(16, 256, 4, 64, device="cpu")
    _fill_map(at, rng)
    old = at.current
    assert at.create_new_map() == 1
    assert at.current != old and len(at.maps) == 2
    assert not bool(at.state.kfs.valid.any())
    assert at.counts().n_kf == 0
    assert bool(at.maps[old].kfs.valid[0]) and at.meta[old].n_kf == 3
    assert at.state.kfs.R.device.type == "cpu"


def test_atlas_reset_active(rng):
    at = tatlas.Atlas(16, 256, 4, 64, device="cpu")
    _fill_map(at, rng)
    at.reset_active_map()
    assert len(at.maps) == 1
    assert not bool(at.state.kfs.valid.any())
    assert not bool(at.state.lms.valid.any())
    assert at.counts().n_kf == 0 and at.counts().n_lm == 0
    # The merge is ported (test_torch_atlas_merge.py holds it against the
    # JAX merge): a filled map welds into the reset one.
    at.create_new_map()
    _fill_map(at, rng)
    at.current = 0
    assert at.merge(1, np.eye(3), np.zeros(3), 1.0) == 0
    assert len(at.maps) == 1
    assert (at.counts().n_kf, at.counts().n_lm) == (3, 20)
    assert int(at.state.obs.kf[0, 1]) == 1


def test_evaluate_matches_jax(rng):
    R, tt = _poses(rng, 30)
    est = tev.camera_centers(R, tt)
    np.testing.assert_array_equal(est, jev.camera_centers(R, tt))
    # A similarity-transformed, noisy copy as the ground truth.
    gR = Rotation.random(random_state=5).as_matrix()
    gt = 2.5 * est @ gR.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, est.shape)
    s, Rh, th, rmse = tev.horn_align(est, gt)
    ref = jev.horn_align(est, gt)
    for a, b in zip((s, Rh, th, rmse), ref):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert abs(s - 2.5) < 0.01 and rmse < 0.03
    stamps = np.arange(30) * 0.1
    assert tev.ate_rmse(stamps + 0.001, est, stamps, gt) == \
        jev.ate_rmse(stamps + 0.001, est, stamps, gt)


def test_golden_frames_fixture_is_the_render():
    """The committed frames are what ``tests/synth_world.py`` renders now
    (``scripts/make_torch_golden_frames.py`` wrote them)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_torch_golden_frames as mk
    finally:
        sys.path.pop(0)
    fresh = mk.golden_arrays()
    g = graft.golden_frames()
    assert g.frames.dtype == np.uint8 and g.frames.shape == (45, 480, 640)
    for k in graft.GoldenFrames._fields:
        np.testing.assert_array_equal(getattr(g, k), fresh[k], err_msg=k)
    np.testing.assert_allclose(g.stamps, np.arange(0, 4.5, 0.1))
