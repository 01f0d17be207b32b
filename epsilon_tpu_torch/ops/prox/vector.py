"""Vector (non-separable) proximal operators.

Counterpart of ``epsilon_tpu/ops/prox/vector.py``: max, sum_largest,
norm_2, norm_inf, the row-wise second-order-cone projection and
log_sum_exp, each one sort plus :func:`~.util.pwl_root` prefix sums or a
fixed-count Newton.  Every kernel takes a leading batch of problems (axis
mode runs one per row or column): vectors along the last axis, ``lam`` and
``s`` numbers or tensors of the batch shape.
"""

from __future__ import annotations

import torch

from ..kernels import lse_rows
from .util import (as_tensor_like, newton_safeguarded, pwl_root,
                   solve_w_log_w, where_batch)


def _b(a):
    """A per-problem scalar broadcast against the vectors."""
    return a[..., None]


def _lam(lam, v):
    return torch.broadcast_to(as_tensor_like(lam, v), v.shape[:-1])

# ---------------------------------------------------------------------------
# max: f(x) = max_i x_i;  x = min(v, t) with sum_i max(0, v_i - t) = lam
# ---------------------------------------------------------------------------


def prox_max(v, lam):
    lam = _lam(lam, v)
    t = pwl_root(-lam, 0.0, v, torch.ones_like(v))
    x = torch.minimum(v, _b(t))
    return where_batch(lam <= 0, v, x)


def eval_max(x):
    return torch.amax(x, dim=-1)


def epi_max(v, s):
    """delta solves sum_i max(0, (v_i - s) - delta) = delta."""
    s = torch.broadcast_to(as_tensor_like(s, v), v.shape[:-1])
    delta = torch.clamp(pwl_root(0.0, -1.0, v - _b(s), torch.ones_like(v)), min=0.0)
    t = s + delta
    x = torch.minimum(v, _b(t))
    inactive = torch.amax(v, dim=-1) <= s
    return where_batch(inactive, v, x), torch.where(inactive, s, t)


# ---------------------------------------------------------------------------
# sum_largest: f(x) = sum of the k largest entries;
# x = v - clip(v - q, 0, lam) with sum_i clip(v_i - q, 0, lam) = k*lam
# ---------------------------------------------------------------------------


def prox_sum_largest(v, lam, k):
    lam = _lam(lam, v)
    keys = torch.cat([v, v - _b(lam)], dim=-1)
    w = torch.cat([torch.ones_like(v), -torch.ones_like(v)], dim=-1)
    q = pwl_root(-k * lam, 0.0, keys, w)
    x = v - torch.minimum(torch.clamp(v - _b(q), min=0.0), _b(lam))
    return where_batch(lam <= 0, v, x)


def eval_sum_largest(x, k):
    return torch.sum(torch.topk(x, min(k, x.shape[-1]), dim=-1).values, dim=-1)


# ---------------------------------------------------------------------------
# norm_2: f(x) = ||x||_2
# ---------------------------------------------------------------------------


def prox_norm2(v, lam):
    lam = _lam(lam, v)
    nrm = torch.linalg.vector_norm(v, dim=-1)
    tiny = torch.finfo(v.dtype).tiny
    scale = torch.clamp(1.0 - lam / torch.clamp(nrm, min=tiny), min=0.0)
    return _b(scale) * v


def eval_norm2(x):
    return torch.linalg.vector_norm(x, dim=-1)


def epi_norm2(v, s):
    """Projection onto the second-order cone {(x, t): ||x|| <= t}."""
    s = torch.broadcast_to(as_tensor_like(s, v), v.shape[:-1])
    nrm = torch.linalg.vector_norm(v, dim=-1)
    tiny = torch.finfo(v.dtype).tiny
    inside = nrm <= s
    polar = nrm <= -s
    t = 0.5 * (nrm + s)
    scale = t / torch.clamp(nrm, min=tiny)
    x = where_batch(inside, v, where_batch(polar, torch.zeros_like(v), _b(scale) * v))
    tt = torch.where(inside, s, torch.where(polar, torch.zeros_like(t), t))
    return x, tt


# ---------------------------------------------------------------------------
# norm_inf: f(x) = max_i |x_i|;  x = clip(v, -t, t) with
# sum_i max(0, |v_i| - t) = lam
# ---------------------------------------------------------------------------


def prox_norm_inf(v, lam):
    lam = _lam(lam, v)
    a = torch.abs(v)
    t = _b(torch.clamp(pwl_root(-lam, 0.0, a, torch.ones_like(a)), min=0.0))
    x = torch.minimum(torch.maximum(v, -t), t)
    return where_batch(lam <= 0, v, x)


def eval_norm_inf(x):
    return torch.amax(torch.abs(x), dim=-1)


def epi_norm_inf(v, s):
    """t* solves s - t + sum_i max(0, |v_i| - t) = 0, clamped at t >= 0."""
    s = torch.broadcast_to(as_tensor_like(s, v), v.shape[:-1])
    a = torch.abs(v)
    t = torch.clamp(pwl_root(s, -1.0, a, torch.ones_like(a)), min=0.0)
    x = torch.minimum(torch.maximum(v, -_b(t)), _b(t))
    inactive = eval_norm_inf(v) <= s
    return where_batch(inactive, v, x), torch.where(inactive, s, t)


# ---------------------------------------------------------------------------
# second_order_cone: row-wise projection onto ||x_i|| <= beta * t_i
# ---------------------------------------------------------------------------


def project_soc_rows(X, t, beta=1.0):
    """Project each row x_i of X and scalar t_i onto {||x|| <= beta*t}."""
    nrm = torch.linalg.vector_norm(X, dim=-1)
    tiny = torch.finfo(X.dtype).tiny
    beta2 = beta * beta
    alpha = (beta2 + beta * t / torch.clamp(nrm, min=tiny)) / (beta2 + 1.0)
    inside = (nrm <= beta * t) | (nrm <= tiny)
    polar = alpha < 0
    alpha = torch.clamp(alpha, 0.0, 1.0)
    alpha = torch.where(inside, torch.ones_like(alpha), alpha)
    t_out = torch.where(inside, t, torch.where(polar, torch.zeros_like(t),
                                               alpha * nrm / beta))
    return alpha[..., None] * X, t_out


# ---------------------------------------------------------------------------
# log_sum_exp: f(x) = log sum_i exp(x_i)
# ---------------------------------------------------------------------------


def prox_log_sum_exp(v, lam):
    """``prox_{lam LSE}`` of every row: the plain version
    (:func:`prox_log_sum_exp_reference`) on a CPU tensor, one launch of the
    ``lse_rows`` kernel on a CUDA tensor; any other device raises."""
    if v.device.type == "cpu":
        return prox_log_sum_exp_reference(v, lam)
    return lse_rows.prox_rows(v, lam)


def prox_log_sum_exp_reference(v, lam):
    """Moreau-dual solve, robust for all lam: prox(v) = v - q with
    ``q_i + log q_i = v_i + log lam - 1 - nu`` (``q = solve_w_log_w``),
    closed by the monotone scalar condition sum_i q_i = lam, solved with
    bracketed safeguarded Newton on nu."""
    lam = _lam(lam, v)
    n = v.shape[-1]
    c0 = v + _b(torch.log(lam)) - 1.0
    lse_c0 = torch.logsumexp(c0, dim=-1)
    # W(c) <= e^c  =>  at hi = LSE(c0) - log lam + 1, sum q <= lam/e < lam;
    # W(lam/n + log(lam/n)) = lam/n  =>  at lo, every q_i >= lam/n
    lo = torch.amin(c0, dim=-1) - lam / n - torch.log(lam / n)
    hi = lse_c0 - torch.log(lam) + 1.0

    def g(nu):
        return lam - torch.sum(solve_w_log_w(c0 - _b(nu)), dim=-1)

    def g_and_gp(nu):
        q = solve_w_log_w(c0 - _b(nu))
        return lam - torch.sum(q, dim=-1), torch.sum(q / (1.0 + q), dim=-1)

    nu0 = torch.minimum(torch.maximum(lse_c0 - torch.log(lam), lo), hi)
    nu = newton_safeguarded(g, None, nu0, lo, hi, iters=25, g_and_gprime=g_and_gp)
    return v - solve_w_log_w(c0 - _b(nu))


def eval_log_sum_exp(x):
    return torch.logsumexp(x, dim=-1)


def epi_log_sum_exp(v, s):
    """Projection onto {(x, t): logsumexp(x) <= t}."""
    from .newton_epi import epi_log_sum_exp as _newton_lse
    return _newton_lse(v, s)
