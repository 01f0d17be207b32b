"""Numerical utilities shared by the prox kernels.

Counterpart of ``epsilon_tpu/ops/prox/util.py``.  Every routine works on a
leading batch of problems (axis mode runs one kernel per row or column of a
matrix argument): vectors lie along the last axis and per-problem scalars
have the batch shape.  The JAX package's fixed-count ``fori_loop`` loops
are Python loops with the same counts, so both packages compute the same
numbers; on a CUDA tensor the LOG_SUM_EXP prox and epigraph, the
SUM_SQUARE and SUM_NEG_LOG epigraphs, the EXP epigraph and the
SUM_LOGISTIC, SUM_KL_DIV, SUM_INV_POS, SUM_EXP and SUM_NEG_ENTR proxes run
their loops in one hand-written kernel each (``ops/kernels/lse_rows.py``,
``epi_sum_square.py``, ``epi_neg_log.py``, ``epi_exp.py``,
``sum_logistic.py``, ``sum_kl_div.py``, ``sum_inv_pos.py``,
``w_log_w.py``), with these routines as their plain versions.

- :func:`pwl_root` - root of a monotone piecewise-linear function by one
  sort and prefix sums.
- :func:`bisect` - fixed-iteration elementwise bisection.
- :func:`newton_safeguarded` - Newton with a maintained bracket and an
  Illinois regula-falsi fallback.
- :func:`solve_w_log_w` - ``w + log w = c`` (Lambert W of ``e^c``).
- :func:`implicit_epigraph` - epigraph projection by outer bisection on
  lambda.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pwl_root", "bisect", "newton_safeguarded", "solve_w_log_w",
           "implicit_epigraph", "as_tensor_like", "where_batch"]


def as_tensor_like(a, ref: torch.Tensor) -> torch.Tensor:
    """``a`` (a number or a tensor) as a tensor of ``ref``'s dtype and
    device."""
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def where_batch(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``torch.where`` with a per-problem condition (batch shape) selecting
    between per-problem vectors (batch shape + (n,))."""
    if cond.dim() < a.dim():
        cond = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
    return torch.where(cond, a, b)


def pwl_root(c0, d0, keys: torch.Tensor, weights: torch.Tensor):
    """Root of ``h(t) = c0 + d0*t + sum_i w_i * max(0, k_i - t)`` along the
    last axis.

    ``h`` must be non-increasing with a unique root (d0 <= 0; mixed signs in
    ``w`` are allowed as long as the sum stays non-increasing).  ``c0`` and
    ``d0`` are numbers or tensors of the batch shape; returns the roots,
    of the batch shape."""
    c0 = as_tensor_like(c0, keys)
    d0 = as_tensor_like(d0, keys)
    c0e, d0e = c0[..., None], d0[..., None]
    order = torch.argsort(-keys, dim=-1, stable=True)
    k = torch.take_along_dim(keys, order, dim=-1)
    w = torch.take_along_dim(weights, order, dim=-1)

    S = torch.cumsum(w * k, dim=-1)           # S_j = sum_{i<=j} w_i k_i
    W = torch.cumsum(w, dim=-1)               # W_j = sum_{i<=j} w_i
    zero = torch.zeros_like(S[..., :1])
    S = torch.cat([zero, S], dim=-1)          # index j = #active terms
    W = torch.cat([zero, W], dim=-1)

    inf = torch.full_like(k[..., :1], float("inf"))
    upper = torch.cat([inf, k], dim=-1)
    lower = torch.cat([k, -inf], dim=-1)

    denom = W - d0e
    nz = denom != 0
    cand = torch.where(nz, (c0e + S) / torch.where(nz, denom, torch.ones_like(denom)),
                       float("inf"))
    valid = (cand >= lower - 1e-30) & (cand <= upper + 1e-30) & nz
    # ties at shared endpoints all equal the root: take the first valid one
    idx = torch.argmax(valid.to(torch.int8), dim=-1, keepdim=True)
    root = torch.take_along_dim(cand, idx, dim=-1)[..., 0]
    # plateau: the zero set of h is a flat segment, so no sloped segment
    # brackets a crossing; take the breakpoint minimizing |h|
    h_at_k = c0e + d0e * k + (S[..., 1:] - W[..., 1:] * k)
    plateau = torch.take_along_dim(
        k, torch.argmin(torch.abs(h_at_k), dim=-1, keepdim=True), dim=-1)[..., 0]
    return torch.where(valid.any(dim=-1), root, plateau)


def bisect(g: Callable, lo, hi, iters: int = 80):
    """Elementwise bisection for a root of non-decreasing ``g`` on [lo, hi]."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        gm = g(mid)
        lo = torch.where(gm < 0, mid, lo)
        hi = torch.where(gm >= 0, mid, hi)
    return 0.5 * (lo + hi)


def newton_safeguarded(g: Callable, gprime: Callable, x0, lo, hi,
                       iters: int = 30, g_and_gprime: Callable = None):
    """Elementwise Newton for non-decreasing ``g`` safeguarded by a
    maintained bracket [lo, hi] with endpoint values: a Newton candidate
    outside the bracket falls back to the Illinois-damped regula falsi
    point (the midpoint when the endpoint residuals are not finite).
    ``g_and_gprime(x) -> (g(x), g'(x))``, where given, evaluates both at
    once (for kinds whose g and g' share their costly part)."""
    x = x0
    lo = torch.broadcast_to(as_tensor_like(lo, x), x.shape)
    hi = torch.broadcast_to(as_tensor_like(hi, x), x.shape)
    glo = g(lo)
    ghi = g(hi)
    for _ in range(iters):
        if g_and_gprime is None:
            gx, gp = g(x), gprime(x)
        else:
            gx, gp = g_and_gprime(x)
        neg = gx < 0
        lo = torch.where(neg, torch.maximum(lo, x), lo)
        glo = torch.where(neg, gx, glo)
        ghi = torch.where(neg, 0.5 * ghi, ghi)
        hi = torch.where(neg, hi, torch.minimum(hi, x))
        ghi = torch.where(neg, ghi, gx)
        glo = torch.where(neg, glo, 0.5 * glo)

        gp_nz = gp != 0
        step = torch.where(gp_nz, gx / torch.where(gp_nz, gp, torch.ones_like(gp)),
                           torch.zeros_like(gx))
        xn = x - step
        denom = ghi - glo
        d_nz = denom != 0
        mid = 0.5 * (lo + hi)
        falsi = torch.where(d_nz, (lo * ghi - hi * glo)
                            / torch.where(d_nz, denom, torch.ones_like(denom)), mid)
        falsi = torch.where(torch.isfinite(falsi),
                            torch.minimum(torch.maximum(falsi, lo), hi), mid)
        bad = (xn <= lo) | (xn >= hi) | ~torch.isfinite(xn)
        x = torch.where(bad, falsi, xn)
    return x


def solve_w_log_w(c: torch.Tensor) -> torch.Tensor:
    """Solve ``w + log(w) = c`` for w > 0 (= LambertW(e^c)), elementwise."""
    tiny = torch.finfo(c.dtype).tiny
    w = torch.where(c > 1.0, c - torch.log(torch.clamp(c, min=1.1)),
                    torch.exp(torch.clamp(c, max=1.0)))
    w = torch.clamp(w, min=tiny)
    for _ in range(30):
        # Newton on h(w) = w + log w - c;  h' = 1 + 1/w
        w = torch.clamp(w - (w + torch.log(w) - c) * w / (w + 1.0), min=tiny)
    return w


def implicit_epigraph(prox: Callable, feval: Callable, v, s,
                      lam_max: float = 1e12, iters: int = 100):
    """Project (v, s) onto ``{(x, t): f(x) <= t}`` by outer bisection on
    ``g(lam) = f(prox_lam(v)) - s - lam`` (non-increasing in lam).  ``v``
    is a tensor or a pair of tensors (two-argument kinds); ``prox(v, lam)``
    and ``feval(x)`` take the same form, with per-problem ``lam`` and
    values of the batch shape."""
    s = as_tensor_like(s, v[0] if isinstance(v, tuple) else v)

    def g(lam):
        return feval(prox(v, lam)) - s - lam

    lam = bisect(lambda t: -g(t), torch.zeros_like(s),
                 torch.full_like(s, lam_max), iters=iters)
    x = prox(v, lam)
    inactive = feval(v) <= s
    if isinstance(v, tuple):
        x = tuple(where_batch(inactive, a, b) for a, b in zip(v, x))
    else:
        x = where_batch(inactive, v, x)
    return x, torch.where(inactive, s, s + lam)
