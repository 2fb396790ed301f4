"""Port parity: the edge-sharded pose graph (``parallel/dist_posegraph.py``)
against the JAX package's ``dist_optimize_pose_graph`` on
``test_sim3_posegraph.make_loop_problem`` (16 keyframes; 8 shards in JAX,
3 in the port, so that the port's edges are padded), and
against the port's unsharded pose graph.

Tolerances: against the JAX function those of ``tests/test_dist_posegraph
.py`` (the sharded against the unsharded result): R within 1e-3, t within
5e-3 (float32 dense solves of two libraries; the port re-projects
rotations by Newton polar iterations, the JAX package by SVD). Against the
port's unsharded form, the same sums in another order: within 1e-4, as
``test_torch_sim3_posegraph.py`` holds the port's pose graph. ``pad_edges``
equals the JAX function's output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_dist_posegraph
import torch
from torch_port_util import n, t

from orbslam3_byzyh_tpu.parallel import dist_ba as jdist
from orbslam3_byzyh_tpu.parallel import dist_posegraph as jdpg
from orbslam3_byzyh_tpu.solver import pose_graph as jpg
from orbslam3_byzyh_tpu_torch.parallel import dist_ba, dist_posegraph
from orbslam3_byzyh_tpu_torch.solver import pose_graph as tpg

R_TOL, T_TOL, SELF_TOL = 1e-3, 5e-3, 1e-4


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the forced 8-device CPU backend")
    return jdist.make_mesh(8)


@pytest.fixture(scope="module")
def graph():
    """test_dist_posegraph.py's chain of 16 keyframes with its loop edge
    (16 edges)."""
    rng = np.random.default_rng(42)
    Rs_gt, ts_gt, Rs_o, ts_o, args = test_dist_posegraph.build_edges(rng, 16)
    return Rs_gt, ts_gt, Rs_o, ts_o, tuple(np.asarray(a) for a in args)


def test_pad_edges_matches_jax(graph):
    *_, args = graph
    for m in (1, 3, 8):
        ref = jdpg.pad_edges(*(jnp.asarray(a) for a in args), m)
        out = dist_posegraph.pad_edges(*(t(a) for a in args), m)
        assert len(out) == 6
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(n(a), np.asarray(b))


def test_matches_jax_sharded(graph, jax_mesh):
    """test_dist_posegraph.py's case: the JAX function over its 8 devices,
    the port's over 3 (the edges padded from 16 to 18)."""
    _, _, Rs_o, ts_o, args = graph
    K = len(Rs_o)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ref = jdpg.dist_optimize_pose_graph(
        jnp.asarray(Rs_o), jnp.asarray(ts_o), jnp.ones(K),
        *jdpg.pad_edges(*(jnp.asarray(a) for a in args), 8),
        jnp.asarray(fixed), jpg.DOF_SE3, mesh=jax_mesh, n_iters=20)
    mesh = dist_ba.make_mesh(devices=["cpu"] * 3)
    out = dist_posegraph.dist_optimize_pose_graph(
        t(Rs_o), t(ts_o), torch.ones(K),
        *dist_posegraph.pad_edges(*(t(a) for a in args), 3), t(fixed),
        tpg.DOF_SE3, mesh=mesh, n_iters=20)
    np.testing.assert_allclose(n(out.R), np.asarray(ref.R), atol=R_TOL)
    np.testing.assert_allclose(n(out.t), np.asarray(ref.t), atol=T_TOL)
    np.testing.assert_allclose(n(out.s), np.asarray(ref.s), atol=T_TOL)


def test_sharded_matches_unsharded_and_reduces_drift(graph):
    """Against the port's ``optimize_pose_graph``, with the live-prefix
    vertex bucket (``n_live``) as ``LoopCloser.close`` calls it, on 24
    vertex slots of which 16 live; and test_dist_posegraph.py's drift
    gate."""
    Rs_gt, ts_gt, Rs_o, ts_o, args = graph
    K, P = 24, 16
    R0 = np.concatenate([Rs_o, np.tile(np.eye(3, dtype=np.float32),
                                       (K - P, 1, 1))])
    t0 = np.concatenate([ts_o, np.zeros((K - P, 3), np.float32)])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    single = tpg.optimize_pose_graph(
        t(R0), t(t0), torch.ones(K), *(t(a) for a in args), t(fixed),
        tpg.DOF_SE3, n_iters=25, n_live=P)
    mesh = dist_ba.make_mesh(devices=["cpu"] * 4)
    out = dist_posegraph.dist_optimize_pose_graph(
        t(R0), t(t0), torch.ones(K),
        *dist_posegraph.pad_edges(*(t(a) for a in args), 4), t(fixed),
        tpg.DOF_SE3, mesh=mesh, n_iters=25, n_live=P)
    np.testing.assert_allclose(n(out.R), n(single.R), atol=SELF_TOL)
    np.testing.assert_allclose(n(out.t), n(single.t), atol=SELF_TOL)
    np.testing.assert_allclose(float(out.cost), float(single.cost),
                               rtol=1e-3, atol=1e-6)
    assert torch.equal(out.R[P:], t(R0[P:]))
    c_after = -np.einsum("nji,nj->ni", n(out.R[:P]), n(out.t[:P]))
    c_gt = -np.einsum("nji,nj->ni", Rs_gt, ts_gt)
    drift0 = np.linalg.norm((-Rs_o[-1].T @ ts_o[-1]) - c_gt[-1])
    assert np.linalg.norm(c_after[-1] - c_gt[-1]) < 0.5 * drift0


def test_edge_count_must_split(graph):
    _, _, Rs_o, ts_o, args = graph
    K = len(Rs_o)
    mesh = dist_ba.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="pad_edges"):
        dist_posegraph.dist_optimize_pose_graph(
            t(Rs_o), t(ts_o), torch.ones(K), *(t(a) for a in args),
            torch.zeros(K, dtype=torch.bool), tpg.DOF_SE3, mesh=mesh)
