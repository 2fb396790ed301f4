"""On-manifold IMU preintegration (Forster-style).

Port of ``orbslam3_byzyh_tpu/ops/imu.py`` (ORB-SLAM3's
``IMU::Preintegrated``: IntegrateNewMeasurement, the bias-corrected
getters, PredictStateIMU's dead reckoning). The covariance is ordered
[dR, dV, dP, bg, ba] (15 x 15); the noise as ``Calib::Set``, diag(ng^2 x3,
na^2 x3).

The JAX package integrates a fixed-capacity window in one ``lax.scan``
whose ``dt == 0`` padding rows are exact no-ops; :func:`integrate` keeps
that rule, and its callers pass the real rows padded to a few sizes
(``pipeline.inertial_system.preintegrate``), not the whole capacity. The
re-projection of dR onto SO(3) after each sample is
:func:`lie.project_rotation` (Newton polar iterations), not the SVD: on
CUDA the SVD synchronises the stream once per sample. Nothing here
reads a tensor back to the host. Every function takes leading batch
dimensions (one window per batch row).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_graph
from . import lie

GRAVITY = 9.81  # IMU::GRAVITY_VALUE


@dataclasses.dataclass
class ImuConfig:
    """IMU calibration (IMU::Calib). ``T_bc``: 4x4 body <- camera
    (``IMU.T_b_c1``). The noise densities are continuous-time; the
    per-sample discrete covariance scales by the rate."""

    T_bc: np.ndarray
    gyro_noise: float = 1.7e-4
    acc_noise: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    freq: float = 200.0

    def noise_cov(self) -> np.ndarray:
        d = np.array([self.gyro_noise ** 2 * self.freq] * 3
                     + [self.acc_noise ** 2 * self.freq] * 3, np.float32)
        return np.diag(d)

    def walk_cov(self) -> np.ndarray:
        d = np.array([self.gyro_walk ** 2 / self.freq] * 3
                     + [self.acc_walk ** 2 / self.freq] * 3, np.float32)
        return np.diag(d)

    def walk_var(self) -> np.ndarray:
        return np.array([self.gyro_walk ** 2] * 3 + [self.acc_walk ** 2] * 3,
                        np.float32)


@functools.cache
def _gravity_on(device: torch.device) -> torch.Tensor:
    # Made on the device: a copy from pageable host memory synchronises.
    g = torch.zeros(3, dtype=torch.float32, device=device)
    return g.index_fill(0, torch.full((1,), 2, device=device), -GRAVITY)


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -GRAVITY) as float32 on ``like``'s device."""
    return _gravity_on(like.device)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


class PreintState(NamedTuple):
    """Running preintegration state between two frames or keyframes."""

    dT: torch.Tensor      # (...) total time
    dR: torch.Tensor      # (..., 3, 3) delta rotation
    dV: torch.Tensor      # (..., 3) delta velocity
    dP: torch.Tensor      # (..., 3) delta position
    C: torch.Tensor       # (..., 15, 15) covariance [dR, dV, dP, bg, ba]
    JRg: torch.Tensor     # (..., 3, 3) d(dR)/d(bg)
    JVg: torch.Tensor     # (..., 3, 3) d(dV)/d(bg)
    JVa: torch.Tensor     # (..., 3, 3) d(dV)/d(ba)
    JPg: torch.Tensor     # (..., 3, 3) d(dP)/d(bg)
    JPa: torch.Tensor     # (..., 3, 3) d(dP)/d(ba)
    avg_a: torch.Tensor   # (..., 3) average rotated specific force
    avg_w: torch.Tensor   # (..., 3) average bias-corrected angular rate
    bias: torch.Tensor    # (..., 6) linearization bias [bg, ba]


def init_state(bias: torch.Tensor) -> PreintState:
    """The empty preintegration at linearization bias ``bias`` (..., 6)."""
    bias = bias.to(torch.float32)
    batch, dev = bias.shape[:-1], bias.device
    z3 = torch.zeros(batch + (3,), device=dev)
    z33 = torch.zeros(batch + (3, 3), device=dev)
    return PreintState(
        dT=torch.zeros(batch, device=dev),
        dR=torch.eye(3, device=dev).expand(batch + (3, 3)).clone(),
        dV=z3, dP=z3, C=torch.zeros(batch + (15, 15), device=dev),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33, avg_a=z3, avg_w=z3,
        bias=bias)


def _block3(rows) -> torch.Tensor:
    """A (..., 3r, 3c) matrix from rows of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(r, -1) for r in rows], -2)


def _update(state: PreintState, acc, gyr, dt, noise_cov,
            walk_cov) -> PreintState:
    """One measurement, IntegrateNewMeasurement's order: position and
    velocity with the old dR, then the rotation, then the covariance. ``dt``
    (...) > 0 for a real sample (:func:`integrate_step` discards the update
    of any other row)."""
    bg, ba = state.bias[..., :3], state.bias[..., 3:]
    a = acc - ba
    w = gyr - bg
    dt1 = dt[..., None]
    dt2 = dt[..., None, None]

    dT_new = state.dT + dt
    denom = torch.where(dT_new > 0, dT_new, torch.ones_like(dT_new))[..., None]
    dRa = _mv(state.dR, a)
    avg_a = (state.dT[..., None] * state.avg_a + dRa * dt1) / denom
    avg_w = (state.dT[..., None] * state.avg_w + w * dt1) / denom

    dP = state.dP + state.dV * dt1 + 0.5 * dRa * dt1 * dt1
    dV = state.dV + dRa * dt1

    Wacc = lie.skew(a)
    dR_dt_W = (state.dR * dt2) @ Wacc

    # Bias Jacobians; position uses the previous JRg.
    JPa = state.JPa + state.JVa * dt2 - 0.5 * state.dR * dt2 * dt2
    JPg = state.JPg + state.JVg * dt2 - 0.5 * dt2 * (dR_dt_W @ state.JRg)
    JVa = state.JVa - state.dR * dt2
    JVg = state.JVg - dR_dt_W @ state.JRg

    phi = w * dt1
    dRi = lie.so3_exp(phi)
    rightJ = lie.so3_right_jacobian(phi)
    dR = lie.project_rotation(state.dR @ dRi)
    dRi_T = dRi.transpose(-1, -2)
    JRg = dRi_T @ state.JRg - rightJ * dt2

    # Covariance: the 9x9 block through A (9x9) and B (9x6).
    z33 = torch.zeros_like(dRi)
    eye3 = torch.eye(3, device=dRi.device).expand(dRi.shape)
    A = _block3([[dRi_T, z33, z33],
                 [-dR_dt_W, eye3, z33],
                 [-0.5 * dt2 * dR_dt_W, eye3 * dt2, eye3]])
    B = _block3([[rightJ * dt2, z33],
                 [z33, state.dR * dt2],
                 [z33, 0.5 * state.dR * dt2 * dt2]])
    C9 = A @ state.C[..., :9, :9] @ A.transpose(-1, -2) \
        + B @ noise_cov @ B.transpose(-1, -2)
    Cb = state.C[..., 9:, 9:] + walk_cov * torch.where(
        dt > 0, 1.0, 0.0)[..., None, None]
    z = torch.zeros_like(C9[..., :6])
    C = torch.cat([torch.cat([C9, z], -1),
                   torch.cat([z.transpose(-1, -2), Cb], -1)], -2)
    return PreintState(dT_new, dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa,
                       avg_a, avg_w, state.bias)


def integrate_step(state: PreintState, acc, gyr, dt, noise_cov,
                   walk_cov) -> PreintState:
    """One measurement update; a ``dt <= 0`` row leaves the state as it
    was (the JAX package's padding rule)."""
    new = _update(state, acc, gyr, dt, noise_cov, walk_cov)
    pad = dt <= 0
    return PreintState(*(
        torch.where(pad.reshape(pad.shape + (1,) * (o.dim() - pad.dim())),
                    o, n_) for n_, o in zip(new, state)))


def integrate(acc, gyr, dts, bias, noise_cov, walk_cov) -> PreintState:
    """Integrate a window of measurements acc, gyr (..., N, 3), dts (..., N)
    from linearization bias ``bias`` (..., 6), a ``dt <= 0`` row a no-op
    (:func:`integrate_step`), as the JAX package's scan. On CUDA the loop
    replays as a CUDA graph (one per window shape,
    ``utils/cuda_graph.py``)."""
    return cuda_graph.call("imu_integrate", _integrate, acc, gyr, dts, bias,
                           noise_cov, walk_cov)


def _integrate(acc, gyr, dts, bias, noise_cov, walk_cov):
    state = init_state(bias)
    for i in range(dts.shape[-1]):
        state = integrate_step(state, acc[..., i, :], gyr[..., i, :],
                               dts[..., i], noise_cov, walk_cov)
    return state


# --- Bias-corrected getters (first order around the linearization bias) ---

def delta_rotation(state: PreintState, new_bias,
                   normalize: bool = True) -> torch.Tensor:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dR = state.dR @ lie.so3_exp(_mv(state.JRg, dbg))
    # normalize=False: the product of two rotations is orthonormal to
    # float32 precision (the JAX package skips the SVD for autodiff).
    return lie.project_rotation(dR) if normalize else dR


def delta_velocity(state: PreintState, new_bias) -> torch.Tensor:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dba = new_bias[..., 3:] - state.bias[..., 3:]
    return state.dV + _mv(state.JVg, dbg) + _mv(state.JVa, dba)


def delta_position(state: PreintState, new_bias) -> torch.Tensor:
    dbg = new_bias[..., :3] - state.bias[..., :3]
    dba = new_bias[..., 3:] - state.bias[..., 3:]
    return state.dP + _mv(state.JPg, dbg) + _mv(state.JPa, dba)


def predict_state(R_wb, v_w, p_w, state: PreintState, new_bias):
    """Dead-reckon the world-frame body state across the preintegrated
    window (Tracking::PredictStateIMU). Returns (R, v, p)."""
    t = state.dT[..., None]
    g = gravity_vec(R_wb)
    dR = delta_rotation(state, new_bias)
    dV = delta_velocity(state, new_bias)
    dP = delta_position(state, new_bias)
    R_new = lie.project_rotation(R_wb @ dR)
    v_new = v_w + g * t + _mv(R_wb, dV)
    p_new = p_w + v_w * t + 0.5 * g * t * t + _mv(R_wb, dP)
    return R_new, v_new, p_new


def split_interval(t0: float, t1: float, stamps: torch.Tensor) -> torch.Tensor:
    """Per-measurement dt within [t0, t1] with boundary splitting
    (Tracking::PreintegrateIMU): samples outside the window give 0,
    boundary samples are clipped."""
    lo = stamps[:-1].clamp_min(t0)
    hi = stamps[1:].clamp_max(t1)
    return (hi - lo).clamp_min(0.0)


def stack(preints) -> PreintState:
    """A list of PreintStates -> one batched PreintState."""
    return PreintState(*(torch.stack(xs) for xs in zip(*preints)))
