"""Port parity: the landmark-sharded global BA (``parallel/dist_ba.py``)
against the JAX package's, and against the port's unsharded BA.

The JAX side runs on the 8 CPU devices ``conftest.py`` forces; the port's
mesh is ``["cpu"] * 8`` (one process, a device list). Tolerances, those of
``tests/test_dist_ba.py`` (the sharded against the unsharded result: sums
taken in another order, float32): poses within 5e-4 (R) and 5e-3 (t),
cost within 5 % + 1. The port's sharded BA against its unsharded one also
holds the points within 5e-3 and the inlier masks equal; the tiny map of
``graft.make_tiny_map_state`` is the JAX one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_ba
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu import graft as jgraft
from orbslam3_byzyh_tpu.ops import lie as jlie
from orbslam3_byzyh_tpu.parallel import dist_ba as jdist
from orbslam3_byzyh_tpu.pipeline import mapping as jmapping
from orbslam3_byzyh_tpu_torch import convert, graft
from orbslam3_byzyh_tpu_torch.models import map_state as tms
from orbslam3_byzyh_tpu_torch.parallel import dist_ba
from orbslam3_byzyh_tpu_torch.pipeline import mapping
from orbslam3_byzyh_tpu_torch.pipeline import system as tsystem
from orbslam3_byzyh_tpu_torch.solver import ba as tba

R_TOL, T_TOL, PTS_TOL = 5e-4, 5e-3, 5e-3
CPU8 = ["cpu"] * 8


def _cost_close(a, b):
    return abs(float(a) - float(b)) < 0.05 * float(b) + 1.0


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the forced 8-device CPU backend")
    return jdist.make_mesh(8)


@pytest.fixture(scope="module")
def problem():
    """tests/test_dist_ba.py's case: synth_ba at 5 keyframes and 320
    landmarks, keyframes 2-4 perturbed, 0-1 fixed."""
    rng = np.random.default_rng(42)
    X, Rs, ts, okf, ouv, oval = test_ba.synth_ba(rng, n_kf=5, n_lm=320)
    Rp, tp = Rs.copy(), ts.copy()
    for k in range(2, len(Rs)):
        dR = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.uniform(-0.02, 0.02, 3).astype(np.float32))))
        Rp[k] = dR @ Rs[k]
        tp[k] = ts[k] + rng.uniform(-0.05, 0.05, 3)
    fixed = np.zeros(len(Rs), bool)
    fixed[:2] = True
    jp = test_ba.make_problem(X, Rp, tp, okf, ouv, oval, fixed)
    tp_ = tba.BAProblem(*(t(np.asarray(a)) if a is not None else None
                          for a in jp))
    return jp, tp_, (Rs, ts)


def test_matches_jax_sharded(problem, jax_mesh):
    jp, tp_, _ = problem
    ref = jdist.dist_bundle_adjust(jdist.shard_problem(jp, jax_mesh),
                                   jax_mesh)
    mesh = dist_ba.make_mesh(devices=CPU8)
    out = dist_ba.dist_bundle_adjust(dist_ba.shard_problem(tp_, mesh), mesh)
    np.testing.assert_allclose(n(out.R), n(ref.R), atol=R_TOL)
    np.testing.assert_allclose(n(out.t), n(ref.t), atol=T_TOL)
    assert _cost_close(out.cost, ref.cost), (float(out.cost), float(ref.cost))


def test_sharded_matches_unsharded(problem):
    _, tp_, (Rs, ts) = problem
    single = tba.bundle_adjust(tp_, assembly=tba.schur_pieces_scatter)
    mesh = dist_ba.make_mesh(devices=CPU8)
    out = dist_ba.dist_bundle_adjust(dist_ba.shard_problem(tp_, mesh), mesh)
    np.testing.assert_allclose(n(out.R), n(single.R), atol=R_TOL)
    np.testing.assert_allclose(n(out.t), n(single.t), atol=T_TOL)
    np.testing.assert_allclose(n(out.points), n(single.points), atol=PTS_TOL)
    np.testing.assert_array_equal(n(out.obs_inlier), n(single.obs_inlier))
    assert _cost_close(out.cost, single.cost)
    # test_dist_ba.py's gate on the poses it frees.
    for k in range(2, len(Rs)):
        assert test_ba.rot_err_deg(n(out.R[k]), Rs[k]) < 0.15
        assert np.linalg.norm(n(out.t[k]) - ts[k]) < 0.03


def test_shard_problem_layout(problem):
    _, tp_, _ = problem
    mesh = dist_ba.make_mesh(devices=["cpu"] * 4)
    shards = dist_ba.shard_problem(tp_, mesh)
    assert len(shards) == 4
    assert all(s.points.shape[0] == 80 for s in shards)
    assert torch.equal(torch.cat([s.obs_kf for s in shards]), tp_.obs_kf)
    assert all(torch.equal(s.R, tp_.R) for s in shards)
    with pytest.raises(ValueError, match="equal shards"):
        dist_ba.shard_problem(tp_, dist_ba.make_mesh(devices=["cpu"] * 3))


def test_tiny_map_state_is_the_jax_one():
    js, jcam, jbf = jgraft.make_tiny_map_state(n_kf=6, n_lm=64)
    ts_, tcam, tbf = graft.make_tiny_map_state(n_kf=6, n_lm=64,
                                               device="cpu")
    ref = convert.map_state_to_numpy(ts_)
    for part in ("kfs", "lms", "obs"):
        for name, a in getattr(js, part)._asdict().items():
            np.testing.assert_array_equal(
                getattr(getattr(ref, part), name), np.asarray(a),
                err_msg=f"{part}.{name}")
    np.testing.assert_array_equal(n(tcam), np.asarray(jcam))
    assert tbf == jbf


def _map_close(a, b):
    np.testing.assert_allclose(n(a.kfs.R), n(b.kfs.R), atol=R_TOL)
    np.testing.assert_allclose(n(a.kfs.t), n(b.kfs.t), atol=T_TOL)
    np.testing.assert_allclose(n(a.lms.pos), n(b.lms.pos), atol=PTS_TOL)
    np.testing.assert_array_equal(n(a.obs.valid), n(b.obs.valid))
    np.testing.assert_array_equal(n(a.lms.valid), n(b.lms.valid))


def test_global_ba_mesh_matches_jax(jax_mesh):
    """The production entry point with stereo rows, as the dry run calls
    it: the port's over ``["cpu"] * 8`` against JAX's over its 8-device
    mesh, and against the port's unsharded call."""
    js, jcam, jbf = jgraft.make_tiny_map_state(n_kf=6, n_lm=64)
    ref = jmapping.global_ba(js, jcam, use_stereo=True, bf=jbf,
                             mesh=jax_mesh)
    st, cam, bf = graft.make_tiny_map_state(n_kf=6, n_lm=64, device="cpu")
    mesh = dist_ba.make_mesh(devices=CPU8)
    out = mapping.global_ba(st, cam, use_stereo=True, bf=bf, mesh=mesh)
    _map_close(out, convert.map_state_to_torch(
        jax.tree.map(np.asarray, ref), "cpu"))
    _map_close(out, mapping.global_ba(st, cam, use_stereo=True, bf=bf))


def test_global_ba_divisibility_fallback(capsys):
    """64 landmark slots over 3 shards: the JAX message, then the
    unsharded BA (the same result bit for bit)."""
    st, cam, bf = graft.make_tiny_map_state(n_kf=4, n_lm=64, device="cpu")
    mesh = dist_ba.make_mesh(devices=["cpu"] * 3)
    out = mapping.global_ba(st, cam, mesh=mesh)
    assert ("global_ba: max_lm=64 not divisible by mesh size 3; falling "
            "back to single-device BA") in capsys.readouterr().out
    ref = mapping.global_ba(st, cam)
    assert torch.equal(out.kfs.R, ref.kfs.R)
    assert torch.equal(out.lms.pos, ref.lms.pos)


def test_make_mesh_devices():
    mesh = dist_ba.make_mesh(4, devices=CPU8)
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        dist_ba.make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="9 devices asked"):
        dist_ba.make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no device"):
            dist_ba.make_mesh()
    st, cam, _ = graft.make_tiny_map_state(device="cpu")
    with pytest.raises(ValueError, match="for a map on cpu"):
        mapping.global_ba(st, cam, mesh=dist_ba.DeviceMesh(
            (torch.device("cuda", 0),) * 2))


def test_dryrun_multichip_on_cpu():
    """``graft.dryrun_multichip`` over ``["cpu"] * 4``: the sharded global
    BA equals the unsharded one within the tolerances, and the pose graph
    runs."""
    state, res = graft.dryrun_multichip(4, devices=["cpu"] * 4)
    st, cam, bf = graft.make_tiny_map_state(n_kf=6, n_lm=64, device="cpu")
    _map_close(state, mapping.global_ba(st, cam, use_stereo=True, bf=bf))
    assert float(res.cost) >= 0.0 and torch.isfinite(res.R).all()


def _small_config(**kw):
    return tsystem.SlamConfig(fx=200.0, fy=200.0, cx=80.0, cy=60.0,
                              width=160, height=120, n_features=128,
                              max_kf=8, max_lm=256, **kw)


class _StubCloser:
    """A loop closer whose detection fires at once and whose closure
    leaves the map as it is."""

    def __init__(self):
        self.info = {"host_reads": []}

    def detect(self, state, kf_id, n_kf):
        eye = np.eye(3, dtype=np.float32)
        return 0, (eye, np.zeros(3, np.float32), 1.0, 0)

    def close(self, state, kf_id, cand, corr, n_kf, span_parent=None):
        return state


def test_monoslam_hands_its_mesh_to_global_ba(monkeypatch):
    """``MonoSlam`` with a mesh: the closure's inline GBA and the merge
    receive it (captured by monkeypatch, no run)."""
    mesh = dist_ba.make_mesh(devices=["cpu"] * 2)
    slam = tsystem.MonoSlam(_small_config(device_mesh=mesh,
                                          background_gba=False),
                            device="cpu")
    assert slam.mesh is mesh
    seen = {}

    def fake_gba(state, cam_params, **kw):
        seen["gba"] = kw.get("mesh")
        return state

    monkeypatch.setattr(mapping, "global_ba", fake_gba)
    monkeypatch.setattr(mapping, "fuse_duplicates",
                        lambda state, *a, **k: state)
    slam.loop_closer = _StubCloser()
    slam._on_map_corrected = lambda kf_id: None
    slam._run_loop_closing(1, live=True)
    assert seen["gba"] is mesh

    def fake_merge(*a, **kw):
        seen["merge"] = kw.get("mesh")
        raise StopIteration

    monkeypatch.setattr(graft, "merge_maps", fake_merge)
    with pytest.raises(StopIteration):
        slam._merge_maps(1, 1, 0, None)
    assert seen["merge"] is mesh


def test_system_default_mesh_without_a_card(monkeypatch):
    """``device_mesh=None`` makes a mesh only for a CUDA system on a host
    with more than one card; ``False`` never."""
    assert tsystem.MonoSlam(_small_config(), device="cpu").mesh is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tsystem.MonoSlam(_small_config(), device="cpu").mesh is None
    assert tsystem.MonoSlam(_small_config(device_mesh=False),
                            device="cpu").mesh is None


def test_covisibility_matrix_landmark_mask():
    """``covisibility_matrix(lm_valid=)``: the viewer's count over every
    landmark row against the default over the live ones."""
    st, _, _ = graft.make_tiny_map_state(n_kf=6, n_lm=64, device="cpu")
    dead = st._replace(lms=st.lms._replace(
        valid=torch.arange(64) % 2 == 0))
    live = tms.covisibility_matrix(dead)
    every = tms.covisibility_matrix(
        dead, lm_valid=torch.ones(64, dtype=torch.bool))
    assert int(live[0, 1]) == 32 and int(every[0, 1]) == 64
