"""Kernels K3 and K3s: the fused 4 x 10 motion-only pose optimization, mono
and mixed mono/stereo.

K3 replaces ``orbslam3_byzyh_tpu/solver/pallas_pose_opt.py::
pose_optimization_fused`` (the Pallas kernel from ``_kernel_factory``). K3s
is the same kernel with its stereo flag set: it computes
``orbslam3_byzyh_tpu/solver/pose_opt.py::pose_optimization_stereo``, which
the JAX package runs through XLA (no Pallas original). The CUDA source is
``csrc/pose_opt.cu``: one thread block per problem, so a batch of B
problems (relocalization hypotheses, the reference-keyframe fallback) is
one launch; the points stay in shared memory and each LM iteration is one
pass over them. :func:`pose_optimization_plain` is the same schedule in
plain PyTorch, following the JAX package's XLA path (``solver/pose_opt.py``):
SVD re-orthonormalisation and ``linalg.solve`` where the kernel uses
Gram-Schmidt and an LDL^T solve.

Both take ``model_id``: the pinhole (``cam_params`` fx, fy, cx, cy) or the
Kannala-Brandt fisheye KB8 (fx, fy, cx, cy, k0..k3), whose projection and
Jacobian the kernel computes in double as ``ops/camera.py`` does; the JAX
package runs KB8 through XLA (its Pallas kernel takes the pinhole only).

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
Both return (R, t, chi2); the caller forms the inlier mask.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels._build import Kernel, check_cuda, ptr, stream_of
from ..ops import camera as cam
from ..ops import lie
from . import lm, pose_opt

CHI2_MONO = lm.CHI2_MONO
CHI2_STEREO = lm.CHI2_STEREO

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("pose_opt", {
    # R0, t0, cam_params, pts, obs, inv_s2, valid, b, n, n_rounds, n_iters,
    # R_out, t_out, chi2_out, model_id, stream
    "pose_optimization": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                          _P, _I, _P],
    # R0, t0, cam_params, pts, obs, obs_ur, bf, inv_s2, valid, b, n,
    # n_rounds, n_iters, R_out, t_out, chi2_out, model_id, stream
    "pose_optimization_stereo": [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P,
                                 _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "pose_max_points": [],
    "pose_max_points_stereo": [],
})
# The exported launcher of each variant.
MONO_FN = "pose_optimization"
STEREO_FN = "pose_optimization_stereo"
# The launches of each launcher's KB8 variant, counted beside
# ``KERNEL.fn_launches`` (which counts both camera models).
KB8_LAUNCHES = {MONO_FN: 0, STEREO_FN: 0}


def pose_optimization_plain(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                            cam_params, n_rounds: int = 4, n_iters: int = 10,
                            obs_ur=None, bf=None,
                            model_id: int = cam.PINHOLE):
    """Plain PyTorch version for one problem: (R, t, chi2). With ``obs_ur``
    (N,) and ``bf`` it is the stereo schedule: rows with ``obs_ur >= 0``
    add the u_r residual and gate at 7.815."""
    if obs_ur is None:
        delta2 = CHI2_MONO

        def residuals(R, t):
            return pose_opt._residuals_mono(R, t, pts_w, obs_uv, cam_params,
                                            model_id)
    else:
        delta2 = torch.where(obs_ur >= 0.0, CHI2_STEREO, CHI2_MONO)

        def residuals(R, t):
            return pose_opt._residuals_stereo(R, t, pts_w, obs_uv, obs_ur, bf,
                                              cam_params, model_id)[:3]

    def chi2_of(R, t):
        r, _, depth_ok = residuals(R, t)
        chi2 = (r * r).sum(-1) * inv_sigma2
        return torch.where(depth_ok, chi2, 1e9)

    def retract(x, dx):
        Rr, tr = x
        dR, dt = lie.se3_exp(dx)
        return lie.normalize_rotation(dR @ Rr), dR @ tr + dt

    R, t, inlier = R0, t0, valid
    for rd in range(n_rounds):
        robust = rd < n_rounds - 1      # the final round drops the kernel

        def build(x, inlier=inlier, robust=robust):
            r, J, depth_ok = residuals(*x)
            chi2 = (r * r).sum(-1) * inv_sigma2
            mask = inlier & valid & depth_ok
            if robust:
                w_rob = lm.huber_weight(chi2, delta2)
                rho = torch.where(chi2 <= delta2, chi2,
                                  2.0 * torch.sqrt(delta2 * chi2) - delta2)
            else:
                w_rob, rho = torch.ones_like(chi2), chi2
            H, b = lm.assemble_normal(J, r, w_rob * inv_sigma2 * mask)
            return H, -b, (rho * mask).sum()

        _, _, cost0 = build((R, t))
        st = ((R, t), torch.tensor(1e-3, dtype=torch.float32,
                                   device=R.device), cost0)
        for _ in range(n_iters):
            st = lm.lm_step(st[0], st[1], st[2], build, retract)
        R, t = st[0]
        inlier = (chi2_of(R, t) <= delta2) & valid   # re-classify
    return R, t, chi2_of(R, t)


def pose_optimization_stereo_plain(R0, t0, pts_w, obs_uv, obs_ur, bf,
                                   inv_sigma2, valid, cam_params,
                                   n_rounds: int = 4, n_iters: int = 10,
                                   model_id: int = cam.PINHOLE):
    """K3s's plain version, with the kernel's arguments: one problem, or a
    batch solved one problem after another."""
    return _plain_batched(
        (R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params),
        dict(n_rounds=n_rounds, n_iters=n_iters, obs_ur=obs_ur,
             bf=float(bf), model_id=model_id))


def _check_camera(cam_params, model_id):
    """Raise unless ``cam_params`` holds ``model_id``'s parameters: 4 for
    the pinhole, 8 for KB8."""
    if model_id not in (cam.PINHOLE, cam.KB8):
        raise ValueError(f"model_id: PINHOLE or KB8, got {model_id}")
    need = 8 if model_id == cam.KB8 else 4
    if cam_params.dim() != 1 or cam_params.shape[0] < need:
        raise ValueError(f"cam_params: expected {need} parameters (fx, fy, "
                         f"cx, cy{', k0..k3' if need == 8 else ''}), got "
                         f"shape {tuple(cam_params.shape)}")


def _check_args(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
                obs_ur, max_points, model_id):
    """Raise unless the arguments are K3's (one problem or a batch), on the
    card, with the camera's parameters for ``model_id`` (4 for the
    pinhole, 8 for KB8) and at most ``max_points()`` points (asked last:
    it builds the kernel). Returns (b, n, lead shape)."""
    single = R0.dim() == 2
    b = 1 if single else R0.shape[0]
    n = pts_w.shape[-2]
    lead = () if single else (b,)
    check_cuda("R0", R0, torch.float32, lead + (3, 3))
    check_cuda("t0", t0, torch.float32, lead + (3,))
    check_cuda("cam_params", cam_params, torch.float32)
    _check_camera(cam_params, model_id)
    check_cuda("pts_w", pts_w, torch.float32, lead + (n, 3))
    check_cuda("obs_uv", obs_uv, torch.float32, lead + (n, 2))
    if obs_ur is not None:
        check_cuda("obs_ur", obs_ur, torch.float32, lead + (n,))
    check_cuda("inv_sigma2", inv_sigma2, torch.float32, lead + (n,))
    check_cuda("valid", valid, torch.bool, lead + (n,))
    if n > max_points():
        raise ValueError(f"pts_w: at most {max_points()} points, got {n}")
    return b, n, lead


def pose_optimization_kernel(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                             cam_params, n_rounds: int = 4,
                             n_iters: int = 10, model_id: int = cam.PINHOLE):
    """K3 on the card. Takes one problem (R0 (3, 3), pts (N, 3), ...) or a
    batch (R0 (B, 3, 3), pts (B, N, 3), ...) sharing ``cam_params`` (the
    pinhole fx, fy, cx, cy, then KB8's k0..k3 with ``model_id`` KB8).
    Every input is a contiguous CUDA tensor, float32 (``valid``: bool); the
    kernel reads them where they lie, so a call is one launch beside the
    allocation of its outputs. N is at most ``pose_max_points()``: the
    points stay in the block's shared memory."""
    b, n, lead = _check_args(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                             cam_params, None, pose_max_points, model_id)
    dev = pts_w.device
    R = torch.empty(lead + (3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    chi2 = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    KERNEL.launch(MONO_FN, ptr(R0), ptr(t0), ptr(cam_params),
                  ptr(pts_w), ptr(obs_uv), ptr(inv_sigma2), ptr(valid), b, n,
                  n_rounds, n_iters, ptr(R), ptr(t), ptr(chi2), model_id,
                  stream_of(pts_w))
    if model_id == cam.KB8:
        KB8_LAUNCHES[MONO_FN] += 1
    return R, t, chi2


def pose_optimization_stereo_kernel(R0, t0, pts_w, obs_uv, obs_ur, bf,
                                    inv_sigma2, valid, cam_params,
                                    n_rounds: int = 4, n_iters: int = 10,
                                    model_id: int = cam.PINHOLE):
    """K3s on the card: K3's arguments (one problem or a batch) and
    ``obs_ur`` (N,) or (B, N) float32, the right-image u of each point (< 0
    for a mono row), and ``bf`` (baseline x fx, a Python float passed by
    value). N is at most ``pose_max_points_stereo()``. One launch."""
    b, n, lead = _check_args(R0, t0, pts_w, obs_uv, inv_sigma2, valid,
                             cam_params, obs_ur, pose_max_points_stereo,
                             model_id)
    dev = pts_w.device
    R = torch.empty(lead + (3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    chi2 = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    KERNEL.launch(STEREO_FN, ptr(R0), ptr(t0), ptr(cam_params),
                  ptr(pts_w), ptr(obs_uv), ptr(obs_ur), float(bf),
                  ptr(inv_sigma2), ptr(valid), b, n, n_rounds, n_iters,
                  ptr(R), ptr(t), ptr(chi2), model_id, stream_of(pts_w))
    if model_id == cam.KB8:
        KB8_LAUNCHES[STEREO_FN] += 1
    return R, t, chi2


@functools.cache
def pose_max_points() -> int:
    """The most points one K3 problem may have (shared-memory capacity)."""
    return KERNEL.build().pose_max_points()


@functools.cache
def pose_max_points_stereo() -> int:
    """The most points one K3s problem may have (29 B a point)."""
    return KERNEL.build().pose_max_points_stereo()


def _plain_batched(args, kw):
    """The plain version over a batch, one problem after another."""
    R0 = args[0]
    if R0.dim() == 2:
        return pose_optimization_plain(*args, **kw)
    ur = kw.pop("obs_ur", None)
    outs = [pose_optimization_plain(
        *(a[i] for a in args[:6]), args[6], **kw,
        **({} if ur is None else {"obs_ur": ur[i]}))
        for i in range(R0.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def pose_optimization(R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params,
                      n_rounds: int = 4, n_iters: int = 10,
                      model_id: int = cam.PINHOLE):
    """The motion-only BA schedule: (R, t, chi2), optionally batched."""
    args = (R0, t0, pts_w, obs_uv, inv_sigma2, valid, cam_params)
    kw = dict(n_rounds=n_rounds, n_iters=n_iters, model_id=model_id)
    if pts_w.device.type != "cpu":
        return pose_optimization_kernel(*args, **kw)
    _check_camera(cam_params, model_id)
    return _plain_batched(args, kw)


def pose_optimization_stereo(R0, t0, pts_w, obs_uv, obs_ur, bf, inv_sigma2,
                             valid, cam_params, n_rounds: int = 4,
                             n_iters: int = 10, model_id: int = cam.PINHOLE):
    """The mixed mono/stereo schedule: (R, t, chi2), optionally batched.
    ``bf`` is a Python float."""
    args = (R0, t0, pts_w, obs_uv, obs_ur, bf, inv_sigma2, valid,
            cam_params)
    kw = dict(n_rounds=n_rounds, n_iters=n_iters, model_id=model_id)
    if pts_w.device.type != "cpu":
        return pose_optimization_stereo_kernel(*args, **kw)
    _check_camera(cam_params, model_id)
    return pose_optimization_stereo_plain(*args, **kw)
