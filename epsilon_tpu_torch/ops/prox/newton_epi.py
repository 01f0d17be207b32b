"""Newton epigraph projections for smooth prox kinds.

Counterpart of ``epsilon_tpu/ops/prox/newton_epi.py``: the projection

    minimize ||x - v||^2/2 + (t - s)^2/2   s.t.  f(x) <= t

solved by Newton on the arrowhead KKT system (:func:`newton_epigraph`) or by
safeguarded Newton on the scalar implicit function
``h(lam) = f(prox(v, lam)) - s - lam`` (:func:`implicit_newton_epigraph`),
with the JAX package's fixed iteration counts.  Every routine takes a
leading batch of problems: vectors along the last axis, ``s`` and ``lam``
of the batch shape.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels import lse_rows
from .util import as_tensor_like, where_batch

__all__ = ["newton_epigraph", "implicit_newton_epigraph", "make_epigraph",
           "lse_metric_solve", "epi_log_sum_exp", "epi_log_sum_exp_reference",
           "epi_sum_kl_div"]


def _domain_eps(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-6


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _diag_metric(fhess):
    def metric_solve(x, lam, r):
        return r / (1.0 + lam[..., None] * fhess(x))
    return metric_solve


def newton_epigraph(v, s, feval: Callable, fgrad: Callable,
                    fhess: Optional[Callable] = None,
                    proj: Optional[Callable] = None,
                    metric_solve: Optional[Callable] = None,
                    prox: Optional[Callable] = None,
                    iters: int = 13, n_alphas: int = 6):
    """Active-case epigraph projection by joint Newton on the arrowhead KKT
    system with a backtracking search over ``n_alphas`` step sizes, all
    evaluated at once; returns ``(x, t)``."""
    dtype = v.dtype
    s = as_tensor_like(s, v)
    if proj is None:
        proj = lambda x: x   # noqa: E731
    if metric_solve is None:
        if fhess is None:
            raise ValueError("need fhess or metric_solve")
        metric_solve = _diag_metric(fhess)

    floor = _domain_eps(dtype)
    alphas = 0.5 ** torch.arange(n_alphas, dtype=dtype, device=v.device)

    def res_norm(x, lam):
        r1 = x - v + lam[..., None] * fgrad(x)
        r2 = feval(x) - s - lam
        return torch.sqrt(torch.sum(r1 * r1, dim=-1) + r2 * r2)

    if prox is not None:
        lam = torch.ones_like(s)
        x = proj(prox(v, lam[..., None]))
    else:
        x = proj(v)
        lam = torch.clamp(0.5 * (feval(x) - s), floor, 1e6)

    for _ in range(iters):
        g = fgrad(x)
        r1 = x - v + lam[..., None] * g
        r2 = feval(x) - s - lam
        Minv_r1 = metric_solve(x, lam, r1)
        Minv_g = metric_solve(x, lam, g)
        dlam = (r2 - _dot(g, Minv_r1)) / (1.0 + _dot(g, Minv_g))
        dx = -(Minv_r1 + Minv_g * dlam[..., None])
        rn0 = torch.sqrt(torch.sum(r1 * r1, dim=-1) + r2 * r2)
        # every trial step size at once: (n_alphas,) + batch shape
        a = alphas.reshape((n_alphas,) + (1,) * s.dim())
        xt = proj(x + a[..., None] * dx)
        lt = torch.clamp(lam + a * dlam, min=floor)
        rns = res_norm(xt, lt)
        rns = torch.where(torch.isfinite(rns), rns, float("inf"))
        ok = rns <= (1.0 - 0.1 * a) * rn0
        idx = torch.where(ok.any(dim=0), torch.argmax(ok.to(torch.int8), dim=0),
                          torch.argmin(rns, dim=0))
        a_sel = alphas[idx]
        x_new = proj(x + a_sel[..., None] * dx)
        lam_new = torch.clamp(lam + a_sel * dlam, min=floor)
        # never move to a worse point than the incumbent
        better = torch.gather(rns, 0, idx[None])[0] <= rn0
        x = where_batch(better, x_new, x)
        lam = torch.where(better, lam_new, lam)
    return x, s + lam


def implicit_newton_epigraph(v, s, feval: Callable, fgrad: Callable,
                             prox: Callable,
                             fhess: Optional[Callable] = None,
                             proj: Optional[Callable] = None,
                             metric_solve: Optional[Callable] = None,
                             iters: int = 24):
    """Active-case epigraph projection by safeguarded Newton on the
    decreasing ``h(lam) = f(prox(v, lam)) - s - lam``, with
    ``h'(lam) = -g^T (I + lam*Hess f)^{-1} g - 1``: a bracket is kept and
    out-of-bracket steps fall back to growth or bisection."""
    dtype = v.dtype
    s = as_tensor_like(s, v)
    if proj is None:
        proj = lambda x: x   # noqa: E731
    if metric_solve is None:
        if fhess is None:
            raise ValueError("need fhess or metric_solve")
        metric_solve = _diag_metric(fhess)

    floor = _domain_eps(dtype)
    big = torch.finfo(dtype).max / 4
    lam = torch.ones_like(s)
    lo = torch.full_like(s, floor)
    hi = torch.full_like(s, big * 2)
    for _ in range(iters):
        x = proj(prox(v, lam[..., None]))
        h = feval(x) - s - lam
        g = fgrad(x)
        hp = -_dot(g, metric_solve(x, lam, g)) - 1.0
        lo = torch.where(h > 0, torch.maximum(lo, lam), lo)
        hi = torch.where(h <= 0, torch.minimum(hi, lam), hi)
        lam_n = lam - h / hp
        fallback = torch.where(hi >= big, torch.clamp(4.0 * lam, min=1.0),
                               0.5 * (lo + hi))
        # a step that lands exactly on a bracket end is the converged root
        # (h/h' rounds to 0), not an escape: the JAX package's non-strict
        # test sends it to the bisection fallback, which can move lam off
        # the root in the remaining iterations
        bad = (lam_n < lo) | (lam_n > hi) | ~torch.isfinite(lam_n)
        lam = torch.where(bad, fallback, lam_n)
    x = proj(prox(v, lam[..., None]))
    return x, s + torch.maximum(feval(x) - s, lam)


def make_epigraph(feval, fgrad, fhess=None, proj=None, metric_solve=None,
                  dom=None, prox=None, iters: int = 13):
    """A full epigraph kernel ``epi(v, s) -> (x, t)`` including the
    inactive-case passthrough (``f(v) <= s``, and ``dom(v)`` where f is
    finite but meaningless outside its domain)."""

    def epi(v, s, **_):
        s = as_tensor_like(s, v)
        if prox is not None:
            x, t = implicit_newton_epigraph(
                v, s, feval, fgrad, prox, fhess=fhess, proj=proj,
                metric_solve=metric_solve, iters=iters + 11)
        else:
            x, t = newton_epigraph(v, s, feval, fgrad, fhess=fhess,
                                   proj=proj, metric_solve=metric_solve,
                                   iters=iters)
        inactive = feval(v) <= s
        if dom is not None:
            inactive = inactive & dom(v)
        return where_batch(inactive, v, x), torch.where(inactive, s, t)

    return epi


# -- log_sum_exp: Hessian diag(p) - p p^T, Sherman-Morrison metric solve ----

def lse_metric_solve(x, lam, r):
    p = torch.softmax(x, dim=-1)
    lam = lam[..., None]
    d = 1.0 + lam * p
    Dinv_r = r / d
    Dinv_p = p / d
    # 1 - lam*p'D^-1 p == sum_i p_i/(1+lam p_i): the sum form avoids the
    # cancellation of the difference form at lam >> 1
    denom = torch.sum(Dinv_p, dim=-1, keepdim=True)
    return Dinv_r + lam * Dinv_p * _dot(p, Dinv_r)[..., None] / denom


def epi_log_sum_exp(v, s):
    """Project every row's (v, s) onto {(x, t): logsumexp(x) <= t}: the
    plain version (:func:`epi_log_sum_exp_reference`) on a CPU tensor, one
    launch of the ``lse_rows`` kernel on a CUDA tensor; any other device
    raises."""
    if v.device.type == "cpu":
        return epi_log_sum_exp_reference(v, s)
    return lse_rows.epi_rows(v, s)


def epi_log_sum_exp_reference(v, s):
    from .vector import eval_log_sum_exp, prox_log_sum_exp_reference
    epi = make_epigraph(eval_log_sum_exp, lambda x: torch.softmax(x, dim=-1),
                        metric_solve=lse_metric_solve,
                        prox=lambda vv, lam: prox_log_sum_exp_reference(vv, lam[..., 0]))
    return epi(v, s)


# -- sum_kl_div: two arguments with per-element 2x2 Hessian blocks ---------

def epi_sum_kl_div(u, w, s):
    """Project (u, w, s) onto {(x, y, t): KL(x, y) <= t}.  The two argument
    vectors are packed into one so the generic machinery applies; the
    metric solve inverts the per-element [[1+lam/x, -lam/y],
    [-lam/y, 1+lam*x/y^2]] blocks directly."""
    from .elementwise import eval_sum_kl_div, prox_sum_kl_div
    w = w.to(u.dtype)
    n = u.shape[-1]
    eps = _domain_eps(u.dtype)

    def unpack(z):
        return z[..., :n], z[..., n:]

    def feval(z):
        return eval_sum_kl_div(*unpack(z))

    def fgrad(z):
        x, y = unpack(z)
        return torch.cat([torch.log(x / y), 1.0 - x / y], dim=-1)

    def proj(z):
        return torch.clamp(z, min=eps)

    def metric_solve(z, lam, r):
        x, y = unpack(z)
        r1, r2 = unpack(r)
        lam = lam[..., None]
        a = 1.0 + lam / x
        b = -lam / y
        c = 1.0 + lam * x / (y * y)
        det = a * c - b * b
        return torch.cat([(c * r1 - b * r2) / det, (a * r2 - b * r1) / det], dim=-1)

    def prox(z, lam):
        x, y = prox_sum_kl_div(*unpack(z), lam)
        return torch.cat([x, y], dim=-1)

    vz = torch.cat([u, w], dim=-1)
    s = as_tensor_like(s, u)
    xz, t = implicit_newton_epigraph(vz, s, feval, fgrad, prox, proj=proj,
                                     metric_solve=metric_solve)
    x, y = unpack(xz)
    fv = eval_sum_kl_div(torch.clamp(u, min=eps), torch.clamp(w, min=eps))
    inactive = torch.all(u > 0, dim=-1) & torch.all(w > 0, dim=-1) & (fv <= s)
    return (where_batch(inactive, u, x), where_batch(inactive, w, y),
            torch.where(inactive, s, t))
