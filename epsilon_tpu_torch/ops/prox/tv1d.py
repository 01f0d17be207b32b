"""Total-variation 1-D prox (fused lasso signal approximator).

Counterpart of the registry path of ``epsilon_tpu/ops/prox/tv1d.py``:

    argmin_x  (1/2)||x - v||^2 + lam * ||D x||_1

by a primal-dual active-set method (semismooth Newton) on the dual box QP
``min_z (1/2)||D^T z - v||^2, |z| <= lam`` with parallel cyclic reduction
for its tridiagonal systems (:func:`prox_tv1d_pdas`), certified by the
duality gap of :func:`tv1d_gap`.  The JAX package's ``lax.while_loop``
becomes a Python loop whose continuation test (one host sync per round)
mirrors the JAX termination exactly.  Inside ADMM the kernel is warm
started from the previous iteration's dual (:func:`prox_tv1d_registry_warm`).

:func:`tv1d_exact_numpy` (the exact taut-string algorithm on the host) is
the test oracle.  The Douglas-Rachford, certified and multiscale variants
of the JAX module are not on the registry path and are not ported, nor is
the registry's uncertified-gap warning (a debug callback there; here it
would cost a host sync per call): :func:`prox_tv1d_pdas` returns the gap.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prox_tv1d_pdas", "prox_tv1d_registry", "prox_tv1d_registry_warm",
           "tv1d_state_init", "pcr_tridiag_solve", "eval_tv1d", "tv1d_gap",
           "tv_gap_tol", "default_tv_tol", "pdas_default_tol",
           "tv1d_exact_numpy"]


def default_tv_tol(dtype):
    """Certifiable sqrt-precision gap tolerance: 1e-7 (f64) / 3e-4 (f32)."""
    return 1e-7 if dtype == torch.float64 else 3e-4


def pdas_default_tol(dtype):
    """Tighter default for the PDAS kernel (it exits on the active-set fixed
    point when the dtype's gap floor is hit)."""
    return 1e-9 if dtype == torch.float64 else 3e-6


def tv_gap_tol(v, tol):
    """Gap threshold for ``||x - x*||_2 <= tol*scale``:
    ``0.5*(tol*scale)^2`` with ``scale = max(1, ||v||_2)``."""
    scale = torch.clamp(torch.sqrt(torch.sum(v * v)), min=1.0)
    return 0.5 * (tol * scale) ** 2


def _diff(x):
    return x[..., 1:] - x[..., :-1]


def _diff_t(w):
    """D^T w for the forward-difference operator."""
    pad = torch.zeros_like(w[..., :1])
    return torch.cat([-w, pad], dim=-1) + torch.cat([pad, w], dim=-1)


def tv1d_gap(v, lam, z):
    """Primal-dual gap of the feasible dual ``z`` (``|z| <= lam``): returns
    ``(x_d, gap)`` with ``x_d = v - D^T z`` and ``gap = sum_i lam*|d_i| -
    z_i*d_i`` (``d = D x_d``); ``||x_d - x*||^2 <= 2*gap``."""
    xd = v - _diff_t(z)
    d = _diff(xd)
    return xd, torch.sum(lam * torch.abs(d) - z * d, dim=-1)


def pcr_tridiag_solve(a, b, c, d):
    """Solve ``a_i z_{i-1} + b_i z_i + c_i z_{i+1} = d_i`` by parallel cyclic
    reduction: ceil(log2 n) rounds of elementwise operations and shifts.
    Out-of-range neighbours are identity rows."""
    n = a.shape[-1]
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))

    def shift(x, s, fill):
        # result[i] = x[i - s] (s may be negative)
        if s >= 0:
            k = min(s, n)
            return torch.cat([torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                                         device=x.device), x[..., :n - k]], dim=-1)
        k = min(-s, n)
        return torch.cat([x[..., k:], torch.full(x.shape[:-1] + (k,), fill,
                                                 dtype=x.dtype, device=x.device)], dim=-1)

    for k in range(steps):
        s = 1 << k
        bm, bp = shift(b, s, 1.0), shift(b, -s, 1.0)
        am, ap = shift(a, s, 0.0), shift(a, -s, 0.0)
        cm, cp = shift(c, s, 0.0), shift(c, -s, 0.0)
        dm, dp = shift(d, s, 0.0), shift(d, -s, 0.0)
        alpha = -a / bm
        gamma = -c / bp
        a = alpha * am
        c = gamma * cp
        b = b + alpha * cm + gamma * ap
        d = d + alpha * dm + gamma * dp
    return d / b


def prox_tv1d_pdas(v, lam, tol=None, max_iters: int = 40, z0=None,
                   return_dual: bool = False):
    """TV prox by PDAS on the dual box QP, with a projected line search on
    the exactly quadratic dual objective; stops when the active set is a
    fixed point with a full step, after ``max_iters`` rounds, or as soon as
    the duality gap meets ``tv_gap_tol(v, tol)``.  Returns
    ``(x, gap, iters)`` (and the dual with ``return_dual``)."""
    dt = v.dtype
    n = v.shape[-1]
    if n <= 1:
        out = (v, torch.zeros((), dtype=dt, device=v.device), 0)
        return out + (v.new_zeros((0,)),) if return_dual else out
    lamd = float(lam)
    dv = _diff(v)
    m = n - 1
    if tol is None:
        tol = pdas_default_tol(dt)
    gap_tol = tv_gap_tol(v, tol)
    if z0 is None:
        z = v.new_zeros((m,))
    else:
        # warm duals may come from another lam: project into the current box
        z = torch.clamp(z0.to(dt), -lamd, lamd)

    def qmul(e):
        return _diff(_diff_t(e))        # D D^T e (tridiagonal [-1, 2, -1])

    alphas = 0.5 ** torch.arange(6, dtype=dt, device=v.device)
    # descent slack at the roundoff scale of the quadratic form
    tol0 = 64.0 * torch.finfo(dt).eps * (1.0 + torch.dot(dv, dv))
    one = torch.ones_like(dv)
    zero = torch.zeros_like(dv)
    act_prev = None
    it = 0
    while True:
        g = qmul(z) - dv
        act_hi = (-g + (z - lamd)) > 0
        act_lo = (-g + (z + lamd)) < 0
        act = act_hi.to(torch.int8) - act_lo.to(torch.int8)
        inactive = act == 0
        b = torch.where(inactive, 2.0 * one, one)
        a = torch.where(inactive, -one, zero)
        pin = torch.where(act_hi, lamd * one, -lamd * one)
        d = torch.where(inactive, dv, pin)
        z_new = pcr_tridiag_solve(a, b, a, d)
        # trial steps of the projected line search, all at once: the change
        # of J = ||D^T z - v||^2 is 2 e.(Qz - dv) + e.Qe for each step e
        E = torch.clamp(z + alphas[:, None] * (z_new - z), -lamd, lamd) - z
        trials = 2.0 * (E @ g) + torch.sum(E * qmul(E), dim=-1)
        full_ok = trials[0] <= tol0
        idx = torch.where(full_ok, torch.zeros_like(torch.argmin(trials)),
                          torch.argmin(trials))
        z_next = torch.clamp(z + alphas[idx] * (z_new - z), -lamd, lamd)
        z = torch.where(trials[idx] > tol0, z, z_next)
        # the first round never settles (the JAX loop starts from a
        # sentinel active set)
        settled = (torch.zeros_like(full_ok) if act_prev is None
                   else torch.all(act == act_prev) & full_ok)
        act_prev = act
        it += 1
        _, gap = tv1d_gap(v, lamd, z)
        go = (~settled) & (gap > gap_tol)
        if it >= max_iters or not bool(go):    # the round's one host sync
            break
    z = torch.clamp(z, -lamd, lamd)
    x, gap = tv1d_gap(v, lamd, z)
    if return_dual:
        return x, gap, it, z
    return x, gap, it


def prox_tv1d_registry(v, lam):
    """Registry entry for ``ProxKind.TOTAL_VARIATION_1D``: PDAS at the inner
    tolerance the solver set (``config.set_prox_inner_tol``)."""
    from ... import config
    x, _gap, _iters = prox_tv1d_pdas(v, lam, tol=config.prox_inner_tol())
    return x


def tv1d_state_init(dim, dtype):
    """Cold PDAS dual for the stateful kernel: z = 0."""
    from ... import config
    return torch.zeros(max(dim - 1, 0), dtype=dtype, device=config.device())


def prox_tv1d_registry_warm(v, lam, z_prev):
    """Stateful registry kernel: PDAS warm-started from the previous ADMM
    iteration's dual, which usually certifies in 1-3 rounds against 8-16
    cold.  Returns ``(x, z)``."""
    from ... import config
    x, _gap, _iters, z = prox_tv1d_pdas(v, lam, tol=config.prox_inner_tol(),
                                        z0=z_prev, return_dual=True)
    return x, z


def eval_tv1d(x):
    return torch.sum(torch.abs(_diff(x)), dim=-1)


def tv1d_exact_numpy(v, lam):
    """Exact O(n) taut-string solution on the host (numpy, Condat 2013),
    the test oracle."""
    v = np.asarray(v, dtype=np.float64)
    n = v.size
    if n == 0:
        return v.copy()
    if n == 1 or lam <= 0:
        return v.copy()
    x = np.empty(n)
    k = k0 = 0
    vmin = v[0] - lam
    vmax = v[0] + lam
    umin = lam
    umax = -lam
    kminus = kplus = 0
    while True:
        if k == n - 1:
            if umin < 0.0:
                x[k0:kminus + 1] = vmin
                k = k0 = kminus = kminus + 1
                vmin = v[k]
                umin = lam
                umax = vmin + lam - vmax
            elif umax > 0.0:
                x[k0:kplus + 1] = vmax
                k = k0 = kplus = kplus + 1
                vmax = v[k]
                umax = -lam
                umin = vmax - lam - vmin
            else:
                x[k0:] = vmin + umin / (k - k0 + 1)
                return x
            if k == n - 1:
                x[k] = vmin + umin
                return x
            continue
        if v[k + 1] + umin < vmin - lam:
            # negative jump: the minorant breaks
            x[k0:kminus + 1] = vmin
            k = k0 = kminus = kplus = kminus + 1
            vmin = v[k]
            vmax = v[k] + 2 * lam
            umin = lam
            umax = -lam
        elif v[k + 1] + umax > vmax + lam:
            # positive jump: the majorant breaks
            x[k0:kplus + 1] = vmax
            k = k0 = kminus = kplus = kplus + 1
            vmin = v[k] - 2 * lam
            vmax = v[k]
            umin = lam
            umax = -lam
        else:
            k += 1
            umin += v[k] - vmin
            umax += v[k] - vmax
            if umin >= lam:
                vmin += (umin - lam) / (k - k0 + 1)
                umin = lam
                kminus = k
            if umax <= -lam:
                vmax += (umax + lam) / (k - k0 + 1)
                umax = -lam
                kplus = k
