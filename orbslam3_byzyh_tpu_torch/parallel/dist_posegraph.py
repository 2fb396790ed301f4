"""Distributed pose-graph optimization: edge-sharded Gauss-Newton.

Port of ``orbslam3_byzyh_tpu/parallel/dist_posegraph.py``. The essential
graph's solve (``solver/pose_graph.py``) grows with its edges
(covisibility, spanning tree, loops), not with its keyframes, so the edges
are cut into ``mesh.size`` equal chunks (:func:`pad_edges` pads them), one
a device of a :class:`~.dist_ba.DeviceMesh`. Each LM iteration every shard
linearises its edges (``pose_graph.edge_linearization``, inside
``pose_graph._build``) and scatters them into a full (K, K, 7, 7) system;
the shards' systems and costs are summed on ``mesh.devices[0]`` (the JAX
package's ``psum``), where the damped solve and the retraction run once;
the vertices go back to every shard for the candidate's costs.

The port's pose graph departs from the JAX function in two stated ways, and
this form keeps both: with ``n_live`` the solve runs over the first
``bucket(n_live)`` vertices only, and the retraction re-projects rotations
by Newton's polar iteration (``lie.project_rotation``), not by SVD. The
dense solves use cuSOLVER on the card, as the single-device form's CUDA
graph does. On a card each shard's linearisation (hundreds of small
operations of ``torch.func.jacfwd``) replays as a CUDA graph; the sums, the
solve and the retraction run op by op. Nothing is read back to the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import device as device_mod
from ..ops import lie
from ..solver import pose_graph as pg
from ..solver.ba import sum_on
from ..utils import cuda_graph
from .dist_ba import DeviceMesh


def pad_edges(edges_i, edges_j, meas_R, meas_t, meas_s, edge_w,
              n_devices: int):
    """Pad the edge arrays to a multiple of ``n_devices``: a padding edge
    joins vertex 0 to itself with the identity measurement and weight 0,
    and adds nothing."""
    e = edges_i.shape[0]
    pad = -(-e // n_devices) * n_devices - e
    if pad == 0:
        return edges_i, edges_j, meas_R, meas_t, meas_s, edge_w
    zi = edges_i.new_zeros(pad)
    eye = torch.eye(3, dtype=meas_R.dtype, device=meas_R.device).expand(
        pad, 3, 3)
    return (torch.cat([edges_i, zi]), torch.cat([edges_j, zi]),
            torch.cat([meas_R, eye]),
            torch.cat([meas_t, meas_t.new_zeros((pad, 3))]),
            torch.cat([meas_s, meas_s.new_ones(pad)]),
            torch.cat([edge_w, edge_w.new_zeros(pad)]))


def dist_optimize_pose_graph(R, t, s, edges_i, edges_j, meas_R, meas_t,
                             meas_s, edge_w, fixed, dof_mask,
                             mesh: DeviceMesh, n_iters: int = 20,
                             right_perturb: bool = False,
                             n_live: int | None = None) -> pg.PoseGraphResult:
    """``pose_graph.optimize_pose_graph``, edge-sharded: the same LM steps
    and accept rule. The edge count must be divisible by the mesh size
    (:func:`pad_edges`). Returns the result on the vertices' device."""
    E = edges_i.shape[0]
    if E % mesh.size:
        raise ValueError(f"dist_optimize_pose_graph: {E} edges do not split "
                         f"into {mesh.size} equal shards (pad_edges)")
    K = R.shape[0]
    P = (K if n_live is None
         else cuda_graph.bucket(max(int(n_live), 1), pg.MIN_BUCKET, K))
    home, devs = R.device, mesh.devices
    dev0 = devs[0]
    chunk = E // mesh.size
    Minv = lie.sim3_inv(meas_R, meas_t, meas_s)
    shards = []
    for i, d in enumerate(devs):
        sl = slice(i * chunk, (i + 1) * chunk)
        shards.append((edges_i[sl].long().to(d), edges_j[sl].long().to(d),
                       tuple(m[sl].to(d) for m in Minv), edge_w[sl].to(d),
                       device_mod.upload(np.asarray(dof_mask, np.float32), d)))
    fix0 = fixed[:P].to(dev0)
    dof0 = shards[0][4].to(dev0)

    def build(Rv, tv, sv):
        """The shards' (H, b, cost) summed on the first device; on a card
        each shard's linearisation replays as a CUDA graph (one per
        device and shape: shards of one card share it)."""
        parts = []
        for d, (ei, ej, Mi, w, dof) in zip(devs, shards):
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()):
                parts.append(cuda_graph.call(
                    "dist_pose_graph_build", pg._build, Rv.to(d), tv.to(d),
                    sv.to(d), ei, ej, Mi, w, dof, right_perturb))
        return tuple(sum_on([x[k] for x in parts], dev0) for k in range(3))

    with (cuda_graph.cusolver() if dev0.type == "cuda"
          else contextlib.nullcontext()):
        Rv, tv, sv = R[:P].to(dev0), t[:P].to(dev0), s[:P].to(dev0)
        _, _, cost = build(Rv, tv, sv)
        lam = torch.full((), 1e-4, dtype=R.dtype, device=dev0)
        for _ in range(n_iters):
            H, b, _ = build(Rv, tv, sv)
            dx = pg._solve(H, b, lam, fix0, dof0)
            Rn, tn, sn = pg._retract(Rv, tv, sv, dx, fix0, right_perturb)
            _, _, cost_new = build(Rn, tn, sn)
            accept = cost_new < cost
            Rv = torch.where(accept, Rn, Rv)
            tv = torch.where(accept, tn, tv)
            sv = torch.where(accept, sn, sv)
            lam = torch.where(accept, lam * 0.5, lam * 10.0)
            cost = torch.where(accept, cost_new, cost)
    Rv, tv, sv, cost = (x.to(home) for x in (Rv, tv, sv, cost))
    if P < K:
        Rv = torch.cat([Rv, R[P:]])
        tv = torch.cat([tv, t[P:]])
        sv = torch.cat([sv, s[P:]])
    return pg.PoseGraphResult(R=Rv, t=tv, s=sv, cost=cost)
