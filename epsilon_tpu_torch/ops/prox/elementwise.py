"""Elementwise (separable) proximal operators.

Counterpart of ``epsilon_tpu/ops/prox/elementwise.py``.  Each kernel solves
``argmin_x f(x) + sum_i (x_i - v_i)^2 / (2 lam_i)`` with ``lam`` a number or
a tensor that broadcasts against ``v``, as a closed form or a fixed-count
safeguarded Newton (the JAX package's counts).  The epigraph projections
take a leading batch of problems (``s`` of the batch shape), as axis mode
needs.
"""

from __future__ import annotations

import torch

from ..kernels import epi_exp as epi_exp_kernel
from ..kernels import epi_neg_log, sum_inv_pos, sum_kl_div, sum_logistic, w_log_w
from .util import (as_tensor_like, newton_safeguarded, pwl_root,
                   solve_w_log_w, where_batch)

# ---------------------------------------------------------------------------
# non_negative: f = I(x >= 0)
# ---------------------------------------------------------------------------


def prox_non_negative(v, lam=None):
    return torch.clamp(v, min=0.0)


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
                     + beta * torch.clamp(-y - M, min=0.0), dim=-1)


def epi_scaled_zone(v, s, alpha=1.0, beta=1.0, C=0.0, M=0.0):
    """Projection onto {(x, t): f_scaled_zone(x) <= t}: with keys
    ``k_i = (|v_i - C| - M)/c_i`` and weights ``c_i^2`` (c = alpha or beta
    by side), lambda* solves ``sum_i c_i^2 max(0, k_i - lam) - s - lam = 0``."""
    alpha = torch.broadcast_to(as_tensor_like(alpha, v), v.shape)
    beta = torch.broadcast_to(as_tensor_like(beta, v), v.shape)
    s = as_tensor_like(s, v)
    y = v - C
    pos = y > M
    neg = y < -M
    zero = torch.zeros_like(v)
    c = torch.where(pos, alpha, torch.where(neg, beta, zero))
    active = (pos & (alpha > 0)) | (neg & (beta > 0))
    safe_c = torch.where(active, c, torch.ones_like(v))
    keys = torch.where(active, (torch.abs(y) - M) / safe_c, zero)
    w = torch.where(active, c * c, zero)

    fval = eval_scaled_zone(v, alpha, beta, C, M)
    lam = torch.clamp(pwl_root(-s, -1.0, keys, w), min=0.0)
    x = prox_scaled_zone(v, lam[..., None], alpha, beta, C, M)
    inactive = fval <= s
    return where_batch(inactive, v, x), torch.where(inactive, s, s + lam)


def prox_norm1(v, lam):
    return prox_scaled_zone(v, lam, 1.0, 1.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# sum_exp: f = sum exp(x);  x + lam*exp(x) = v  =>  x = v - W(lam * e^v)
# ---------------------------------------------------------------------------


def prox_sum_exp(v, lam):
    """x + lam e^x = v elementwise: the plain version
    (:func:`prox_sum_exp_reference`) on a CPU tensor, one launch of the
    ``w_log_w`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return prox_sum_exp_reference(v, lam)
    return w_log_w.prox_exp(v, lam)


def prox_sum_exp_reference(v, lam):
    """The 30-step Lambert solve, one eager operation a step."""
    c = torch.log(as_tensor_like(lam, v)) + v
    return v - solve_w_log_w(c)


def eval_sum_exp(x):
    return torch.sum(torch.exp(x), dim=-1)


# ---------------------------------------------------------------------------
# exp epigraph: project (v, s) onto {(x, t): e^x <= t} elementwise.  Active
# KKT: x = v - mu*e^x, t = e^x = s + mu; eliminating mu,
# g(x) = x + e^{2x} - s e^x - v = 0 on x < v, where g is increasing.
# ---------------------------------------------------------------------------


def epi_exp(v, s):
    """Projection of (v, s) onto {(x, t): e^x <= t} elementwise: the plain
    version (:func:`epi_exp_reference`) on a CPU tensor, one launch of the
    ``epi_exp`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return epi_exp_reference(v, s)
    return epi_exp_kernel.epi(v, s)


def epi_exp_reference(v, s):
    """The bracket's 40-step widening and the safeguarded Newton of 25
    steps, one eager operation a step."""
    s = as_tensor_like(s, v)
    inactive = torch.exp(v) <= s

    def g(x):
        ex = torch.exp(x)
        return x + ex * ex - s * ex - v

    def gp(x):
        ex = torch.exp(x)
        return 1.0 + 2.0 * ex * ex - s * ex

    hi = v
    lo = torch.clamp(v, max=0.0) - 1.0
    for _ in range(40):
        lo = torch.where(g(lo) > 0, lo - 2.0 * torch.abs(lo) - 2.0, lo)
    # the root has e^{x*} = s + mu > s, so x* > log(s/2): clamping the
    # bracket there keeps Newton's monotonicity precondition
    tiny = torch.finfo(v.dtype).tiny
    lo = torch.where(s > 0, torch.maximum(lo, torch.log(torch.clamp(s, min=tiny) * 0.5)), lo)
    x = newton_safeguarded(g, gp, 0.5 * (lo + hi), lo, hi, iters=25)
    return torch.where(inactive, v, x), torch.where(inactive, s, torch.exp(x))


# ---------------------------------------------------------------------------
# sum_logistic: f = sum log(1 + e^x);  x + lam*sigmoid(x) = v
# ---------------------------------------------------------------------------


def prox_sum_logistic(v, lam):
    """x + lam sigmoid(x) = v elementwise: the plain version
    (:func:`prox_sum_logistic_reference`) on a CPU tensor, one launch of
    the ``sum_logistic`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return prox_sum_logistic_reference(v, lam)
    return sum_logistic.prox(v, lam)


def prox_sum_logistic_reference(v, lam):
    """The safeguarded Newton of 40 steps, one eager operation a step."""
    lam = as_tensor_like(lam, v)

    def g(x):
        return x + lam * torch.sigmoid(x) - v

    def gp(x):
        sig = torch.sigmoid(x)
        return 1.0 + lam * sig * (1.0 - sig)

    x0 = v - lam * torch.sigmoid(v)
    return newton_safeguarded(g, gp, x0, v - lam - 1e-9, v + 1e-9, iters=40)


def eval_sum_logistic(x):
    return torch.sum(torch.logaddexp(torch.zeros_like(x), x), dim=-1)


# ---------------------------------------------------------------------------
# sum_inv_pos: f = sum 1/x, x > 0;  largest real root of x^3 - v x^2 - lam
# ---------------------------------------------------------------------------


def prox_sum_inv_pos(v, lam):
    """x^2 (x - v) = lam elementwise: the plain version
    (:func:`prox_sum_inv_pos_reference`) on a CPU tensor, one launch of the
    ``sum_inv_pos`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return prox_sum_inv_pos_reference(v, lam)
    return sum_inv_pos.prox(v, lam)


def prox_sum_inv_pos_reference(v, lam):
    """The bracket's 40-step widening and the safeguarded Newton of 50
    steps, one eager operation a step."""
    lam = torch.broadcast_to(as_tensor_like(lam, v), v.shape)

    def g(x):
        return x * x * (x - v) - lam

    def gp(x):
        return 3.0 * x * x - 2.0 * v * x

    hi = torch.clamp(v, min=0.0) + _cbrt(lam) + 1.0
    for _ in range(40):
        hi = torch.where(g(hi) < 0, 2.0 * hi, hi)
    lo = torch.full_like(v, 1e-12)
    x0 = torch.maximum(v, _cbrt(lam))
    return newton_safeguarded(g, gp, x0, lo, hi, iters=50)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def eval_sum_inv_pos(x):
    return torch.sum(1.0 / x, dim=-1)


# ---------------------------------------------------------------------------
# sum_neg_entr: f = sum x log x, x >= 0.  With x = lam*u:
#   u + log u = (v - lam)/lam - log lam
# ---------------------------------------------------------------------------


def prox_sum_neg_entr(v, lam):
    """lam (log x + 1) + x = v elementwise: the plain version
    (:func:`prox_sum_neg_entr_reference`) on a CPU tensor, one launch of the
    ``w_log_w`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return prox_sum_neg_entr_reference(v, lam)
    return w_log_w.prox_neg_entr(v, lam)


def prox_sum_neg_entr_reference(v, lam):
    """The 30-step Lambert solve, one eager operation a step."""
    lam = as_tensor_like(lam, v)
    c = (v - lam) / lam - torch.log(lam)
    return lam * solve_w_log_w(c)


def eval_sum_neg_entr(x):
    return torch.sum(torch.xlogy(x, x), dim=-1)


# ---------------------------------------------------------------------------
# sum_neg_log: f = -sum log x;  x = (v + sqrt(v^2 + 4 lam))/2
# ---------------------------------------------------------------------------


def prox_sum_neg_log(v, lam):
    return 0.5 * (v + torch.sqrt(v * v + 4.0 * lam))


def eval_sum_neg_log(x):
    return -torch.sum(torch.log(x), dim=-1)


def epi_sum_neg_log(v, s):
    """Projection of every row's (v, s) onto {(x, t): -sum log x_i <= t}:
    the plain version (:func:`epi_sum_neg_log_reference`) on a CPU tensor,
    one launch of the ``epi_neg_log`` kernel on a CUDA tensor; any other
    device raises."""
    if v.device.type == "cpu":
        return epi_sum_neg_log_reference(v, s)
    return epi_neg_log.epi_rows(v, s)


def epi_sum_neg_log_reference(v, s):
    """Projection onto {(x, t): -sum log x_i <= t} by implicit Newton on
    the epigraph's lambda."""
    from .newton_epi import make_epigraph
    floor = 1e-12 if v.dtype == torch.float64 else 1e-6
    epi = make_epigraph(
        eval_sum_neg_log,
        lambda x: -1.0 / x,
        fhess=lambda x: 1.0 / (x * x),
        proj=lambda x: torch.clamp(x, min=floor),
        dom=lambda u: torch.all(u > 0, dim=-1),
        prox=prox_sum_neg_log)
    return epi(v, s)


# ---------------------------------------------------------------------------
# sum_kl_div: f(x, y) = sum x log(x/y) - x + y.  Per-element Newton on
# r = x/y:  lam*r^2 + (v - lam)*r - u + lam*log r = 0, then
#   y = lam*r + v - lam,  x = y*r.
# ---------------------------------------------------------------------------


def prox_sum_kl_div(u, v, lam):
    """The SUM_KL_DIV prox of (u, v) elementwise, ``(x, y)``: the plain
    version (:func:`prox_sum_kl_div_reference`) on a CPU tensor, one launch
    of the ``sum_kl_div`` kernel on a CUDA tensor; any other device
    raises."""
    if u.device.type == "cpu":
        return prox_sum_kl_div_reference(u, v, lam)
    return sum_kl_div.prox(u, v, lam)


def prox_sum_kl_div_reference(u, v, lam):
    """The bracket's 60-step widening and the safeguarded Newton of 60
    steps, one eager operation a step."""
    eps = 1e-13 if u.dtype == torch.float64 else 1e-6
    lam = torch.broadcast_to(as_tensor_like(lam, u), u.shape)

    def g(r):
        return lam * r * r + (v - lam) * r - u + lam * torch.log(r)

    def gp(r):
        return 2.0 * lam * r + (v - lam) + lam / r

    # feasibility also needs y = lam*r + v - lam > 0, i.e. r > (lam - v)/lam
    lo = torch.clamp((lam - v) / lam + eps, min=eps)
    hi = torch.clamp(lo * 2.0, min=1.0)
    for _ in range(60):
        hi = torch.where(g(hi) < 0, 2.0 * hi, hi)
    r0 = torch.minimum(torch.maximum(
        torch.clamp((0.5 + lam - v) / lam, min=eps), lo), hi)
    r = newton_safeguarded(g, gp, r0, lo, hi, iters=60)
    y = lam * r + v - lam
    x = y * r
    tiny = (torch.abs(u) < eps * eps) & (torch.abs(v) < eps * eps)
    return torch.where(tiny, u, x), torch.where(tiny, v, y)


def eval_sum_kl_div(x, y):
    # rel_entr(x, y) = x log(x/y) for x, y > 0, 0 at x = 0 <= y, else inf
    both = (x > 0) & (y > 0)
    rel = torch.where(both, x * torch.log(x / y),
                      torch.where((x == 0) & (y >= 0), torch.zeros_like(x),
                                  torch.full_like(x, float("inf"))))
    return torch.sum(rel - x + y, dim=-1)


def epi_sum_kl_div(u, v, s):
    """Projection onto {(x, y, t): KL(x, y) <= t} by implicit Newton with
    per-element 2x2 Hessian blocks."""
    from .newton_epi import epi_sum_kl_div as _newton_kl
    return _newton_kl(u, v, s)
