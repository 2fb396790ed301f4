"""Levenberg-Marquardt primitives. Port of ``orbslam3_byzyh_tpu/solver/lm.py``.

Robust weights, normal-equation assembly and damped solves, batched and
mask-aware (g2o's core machinery).
"""

from __future__ import annotations

import torch

# Chi2 thresholds (95%): 2-dof (mono) and 3-dof (stereo).
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """Huber IRLS weight: 1 if chi2 <= delta2 else delta / sqrt(chi2)."""
    safe = chi2.clamp_min(1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / safe))


def assemble_normal(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """H = sum_i w_i J_i^T J_i, b = sum_i w_i J_i^T r_i.

    J: (N, res_dim, P); r: (N, res_dim); w: (N,). Returns (H (P, P), b (P,)).
    """
    Jw = J * w[:, None, None]
    H = torch.einsum("nri,nrj->ij", Jw, J)
    b = torch.einsum("nri,nr->i", Jw, r)
    return H, b


def solve_damped(H: torch.Tensor, b: torch.Tensor, lam) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dx = b (Marquardt scaling)."""
    diag = torch.diagonal(H)
    Hd = H + torch.diag(lam * diag.clamp_min(1e-9))
    return torch.linalg.solve(Hd, b)


def lm_step(x, lam, cost, build_fn, retract_fn,
            lam_up: float = 10.0, lam_down: float = 0.5):
    """One accept/reject LM iteration without host synchronisation.

    build_fn(x) -> (H, b, cost); retract_fn(x, dx) -> x'. The candidate is
    accepted iff it lowers the cost; lambda adapts either way. ``x`` is a
    tuple of tensors.
    """
    H, b, _ = build_fn(x)
    dx = solve_damped(H, b, lam)
    x_new = retract_fn(x, dx)
    _, _, cost_new = build_fn(x_new)
    accept = cost_new < cost
    x = tuple(torch.where(accept, b_, a) for a, b_ in zip(x, x_new))
    lam = torch.where(accept, lam * lam_down, lam * lam_up)
    cost = torch.where(accept, cost_new, cost)
    return x, lam, cost
