"""Distributed bundle adjustment: a landmark-sharded Schur over a device mesh.

Port of ``orbslam3_byzyh_tpu/parallel/dist_ba.py``. The JAX package is one
process that runs ``shard_map`` over its devices; the port is one process
with an explicit list of devices (:class:`DeviceMesh`), not a group of
``torch.distributed`` ranks: the SLAM system runs once, and only its global
BA spreads over the devices.

The landmark axis of the BA problem is cut into ``mesh.size`` equal chunks,
each on its shard's device (:func:`shard_problem`); the poses, the fixed
mask and the camera are copied to every device. Each LM iteration:

  * every shard builds its landmarks' normal-equation blocks
    (``solver/ba._build_system``) and their Schur pieces by scatter-add
    (``ba.schur_pieces_scatter``);
  * the pieces ``Hpp``, ``bp``, ``cross`` and ``corr`` and the costs are
    summed on ``mesh.devices[0]`` (the JAX package's ``psum``): one
    transfer of K * K * 36 + 3 * K * 6 floats a shard, whatever the
    landmark count;
  * the dense (6K, 6K) solve runs once there (``ba.schur_solve``) and the
    pose step ``dp`` goes back to every shard, for the shard-local
    back-substitution and retraction;
  * the accept decision is a ``torch.where`` on the first device, copied to
    the shards as a tensor: nothing is read back to the host.

The LM loop is ``solver.ba.bundle_adjust``'s own, which takes the shards
as a sequence of problems; one shard is the unsharded BA.

The devices of a mesh may repeat (``["cuda:0"] * 4`` on one card, ``["cpu"]
* 8`` in the tests): the shards then share a device and the sums are the
same arithmetic. A mesh is all CUDA or all CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera as cam
from ..solver import ba


class DeviceMesh(NamedTuple):
    """A one-axis mesh: ``devices`` in shard order (repeats allowed)."""

    devices: tuple
    axis: str = "lm"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A mesh over ``devices`` (any mix of strings and ``torch.device``; by
    default every CUDA card), cut to the first ``n_devices``. Raises for an
    empty mesh, for fewer devices than ``n_devices`` and for a mesh that
    mixes the CPU with the card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"make_mesh: {n_devices} devices asked, {len(devs)} given "
                "(pass devices=, which may repeat one device)")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no device (no CUDA card; pass devices=)")
    types = {d.type for d in devs}
    if len(types) > 1:
        raise ValueError(f"make_mesh: a mesh is all CUDA or all CPU, got "
                         f"{[str(d) for d in devs]}")
    devs = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None
            else d for d in devs]
    return DeviceMesh(tuple(devs))


# The BAProblem fields along the landmark axis; the rest are replicated.
_LM_FIELDS = ("points", "obs_kf", "obs_uv", "obs_w", "obs_valid", "lm_valid",
              "obs_ur")


def shard_problem(p: ba.BAProblem, mesh: DeviceMesh) -> tuple:
    """Cut every landmark-axis field into ``mesh.size`` equal chunks, each
    on its shard's device, and copy the poses, the fixed mask and the
    camera to every device (``bf`` stays a Python float): one
    ``ba.BAProblem`` a shard. The landmark count must be divisible by the
    mesh size, as ``shard_map`` requires."""
    L = p.points.shape[0]
    if L % mesh.size:
        raise ValueError(f"shard_problem: {L} landmarks do not split into "
                         f"{mesh.size} equal shards")
    chunk = L // mesh.size
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = i * chunk
        shards.append(ba.BAProblem(*(
            None if x is None
            else x if not isinstance(x, torch.Tensor)
            else (x[lo:lo + chunk] if name in _LM_FIELDS else x).to(dev)
            for name, x in zip(ba.BAProblem._fields, p))))
    return tuple(shards)


def dist_bundle_adjust(shards, mesh: DeviceMesh, model_id: int = cam.PINHOLE,
                       stages: tuple = (5, 10)) -> ba.BAResult:
    """``solver.ba.bundle_adjust`` with the scatter assembly over
    :func:`shard_problem`'s shards: the same stages, Huber schedule,
    re-classification and LM bookkeeping, the Schur pieces and costs
    summed on ``mesh.devices[0]``. Stereo rows (``obs_ur``, ``bf``) shard
    with the observations. Returns the result on ``mesh.devices[0]``: the
    poses, every landmark's point and inlier mask in the original order,
    the summed cost."""
    if len(shards) != mesh.size:
        raise ValueError(f"dist_bundle_adjust: {len(shards)} shards for a "
                         f"mesh of {mesh.size}")
    return ba.bundle_adjust(shards, model_id=model_id, stages=stages,
                            assembly=ba.schur_pieces_scatter)
