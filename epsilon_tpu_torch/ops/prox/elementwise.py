"""Elementwise (separable) proximal operators.

Counterpart of ``epsilon_tpu/ops/prox/elementwise.py``; so far the scaled
zone family's prox and value, which the lasso's NORM_1 term needs.  Each
kernel solves ``argmin_x f(x) + sum_i (x_i - v_i)^2 / (2 lam_i)`` with
``lam`` a scalar or a per-coordinate tensor.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# scaled zone family
# f(x) = sum_i alpha_i*max(0, (x_i-C)-M) + beta_i*max(0, -(x_i-C)-M)
#   NORM_1:       alpha=beta=1, C=M=0
#   SUM_DEADZONE: alpha=beta=1, C=0, M=margin
#   SUM_HINGE:    alpha=1, beta=0, C=M=0
#   SUM_QUANTILE: alpha, beta vectors, C=M=0
# ---------------------------------------------------------------------------


def prox_scaled_zone(v, lam, alpha=1.0, beta=1.0, C=0.0, M=0.0):
    x = v - C
    la = lam * alpha
    lb = lam * beta
    shrunk = torch.where(
        x > M + la, x - la,
        torch.where(x < -M - lb, x + lb, torch.clamp(x, -M, M)))
    out = torch.where(torch.abs(x) <= M, x, shrunk)
    return out + C


def eval_scaled_zone(x, alpha=1.0, beta=1.0, C=0.0, M=0.0):
    y = x - C
    return torch.sum(alpha * torch.clamp(y - M, min=0.0)
                     + beta * torch.clamp(-y - M, min=0.0))


def prox_norm1(v, lam):
    return prox_scaled_zone(v, lam, 1.0, 1.0, 0.0, 0.0)
