"""Total-variation 1-D prox (fused lasso signal approximator).

Counterpart of the registry path of ``epsilon_tpu/ops/prox/tv1d.py``:

    argmin_x  (1/2)||x - v||^2 + lam * ||D x||_1

by a primal-dual active-set method (semismooth Newton) on the dual box QP
``min_z (1/2)||D^T z - v||^2, |z| <= lam`` with parallel cyclic reduction
for its tridiagonal systems (:func:`prox_tv1d_pdas`), certified by the
duality gap of :func:`tv1d_gap`.  The JAX package's ``lax.while_loop``
becomes, in the plain version (:func:`prox_tv1d_pdas_reference`), a Python
loop whose continuation test (one host sync per round) mirrors the JAX
termination exactly; on a CUDA tensor one cooperative kernel launch
(``ops/kernels/tv1d_pdas.py``) runs the whole loop, its stop test on the
device.  Inside ADMM the kernel is warm
started from the previous iteration's dual (:func:`prox_tv1d_registry_warm`).

Off the registry path, as in the JAX module: Douglas-Rachford/ADMM
splitting whose x-update ``(I + rho D^T D)^{-1} r`` is solved exactly in the
DCT-II basis by one FFT pair (:func:`neumann_laplacian_solve`) or by the
decaying Toeplitz inverse kernel as a framed matmul
(:func:`neumann_laplacian_solve_conv`): a fixed count (:func:`prox_tv1d`),
epochs until the duality gap certifies, with residual-balancing rho
(:func:`prox_tv1d_certified`), and coarse-to-fine continuation for long
signals (:func:`prox_tv1d_multiscale`).

:func:`tv1d_exact_numpy` (the exact taut-string algorithm on the host) is
the test oracle.  The registry's uncertified-gap warning of the JAX module
(a debug callback there; here it would cost a host sync per call) is not
ported: :func:`prox_tv1d_pdas` returns the gap.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.timing import count
from ..kernels import tv1d_pdas

__all__ = ["prox_tv1d", "prox_tv1d_certified", "prox_tv1d_multiscale",
           "neumann_laplacian_solve", "neumann_laplacian_solve_conv",
           "prox_tv1d_pdas", "prox_tv1d_pdas_reference", "prox_tv1d_registry",
           "prox_tv1d_registry_warm",
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


def neumann_laplacian_solve(r, rho):
    """Solve ``(I + rho * D^T D) x = r`` exactly, where D^T D is the
    free-boundary (Neumann) 1-D Laplacian, by the mirror-extension FFT
    trick: on the even-symmetric length-2n extension the operator is a
    circulant, so the solve is one rfft / irfft pair."""
    n = r.shape[-1]
    ext = torch.cat([r, torch.flip(r, dims=(-1,))], dim=-1)
    R = torch.fft.rfft(ext, dim=-1)
    k = torch.arange(R.shape[-1], dtype=r.dtype, device=r.device)
    eig = 2.0 - 2.0 * torch.cos(torch.pi * k / n)
    x = torch.fft.irfft(R / (1.0 + rho * eig), n=2 * n, dim=-1)
    return x[..., :n].to(r.dtype)


def neumann_laplacian_solve_conv(r, rho, taps: int = 256, block: int = 256):
    """Same solve as :func:`neumann_laplacian_solve` through the decaying
    Toeplitz inverse kernel instead of the FFT.  The infinite-grid inverse
    of ``I + rho*D^T D`` is ``g[d] = q^|d| / sqrt(1+4 rho)`` with
    ``q = (1+2 rho - sqrt(1+4 rho)) / (2 rho)`` (|q| < 1), so the solve is a
    (2*taps-1)-tap correlation of the symmetrically padded signal, computed
    as overlapping frames times a banded Toeplitz matrix built from ``rho``
    (a number or a 0-d tensor).  The truncation error is
    ``O(q^taps * ||r||_inf)``; callers that need exactness certify a
    posteriori (:func:`prox_tv1d_certified`)."""
    dt, dev = r.dtype, r.device
    n = r.shape[-1]
    K, C = taps, block
    W = C + 2 * K - 2
    F = -(-n // C)
    rho = torch.as_tensor(rho, dtype=dt, device=dev)
    s = torch.sqrt(1.0 + 4.0 * rho)
    q = torch.where(rho > 0, (1.0 + 2.0 * rho - s) / (2.0 * rho),
                    torch.zeros_like(rho))

    # banded Toeplitz (W, C): T[w, j] = q^|w-j-(K-1)| / s inside the band
    d = (torch.arange(W, device=dev)[:, None]
         - torch.arange(C, device=dev)[None, :] - (K - 1))
    band = (d > -K) & (d < K)
    T = torch.where(band, torch.pow(q, torch.abs(d).to(dt)) / s,
                    torch.zeros((), dtype=dt, device=dev))

    # frame f reads positions C*f - (K-1) + [0, W) of the signal, extended
    # symmetrically (the edge sample repeats) on both sides
    pos = (C * torch.arange(F, device=dev)[:, None]
           + torch.arange(W, device=dev)[None, :] - (K - 1)) % (2 * n)
    idx = torch.where(pos >= n, 2 * n - 1 - pos, pos)
    frames = r[..., idx]                             # (..., F, W)
    y = frames @ T
    return y.reshape(r.shape[:-1] + (F * C,))[..., :n]


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def prox_tv1d(v, lam, iters: int = 150, rho: float = 1.0):
    """ADMM with the exact DCT-based x-update, a fixed count of iterations:
    minimize (1/2)||x-v||^2 + lam ||w||_1  s.t.  D x = w."""
    w = _soft(_diff(v), lam)
    u = torch.zeros_like(w)
    x = v
    for _ in range(iters):
        x = neumann_laplacian_solve(v + rho * _diff_t(w - u), rho)
        dx = _diff(x)
        w = _soft(dx + u, lam / rho)
        u = u + dx - w
    return x


def prox_tv1d_certified(v, lam, tol=None, max_iters=3000, check_every=32,
                        rho0=1.0, w0=None, u0=None):
    """Gap-certified TV prox: Douglas-Rachford/ADMM epochs of
    ``check_every`` iterations with residual-balancing rho, until the
    certified duality gap satisfies ``gap <= 0.5*(tol*scale)^2``
    (``scale = max(1, ||v||_2)``), i.e. ``||x - x*||_2 <= tol*scale``, or
    ``max_iters``; one host sync per epoch.  Returns ``(x_d, gap, iters)``
    with ``x_d`` the dual-certified primal point."""
    dt = v.dtype
    n = v.shape[-1]
    lam = torch.as_tensor(lam, dtype=dt, device=v.device)
    if tol is None:
        tol = default_tv_tol(dt)
    gap_tol = tv_gap_tol(v, tol)

    # x-update: the truncated inverse kernel for long signals (rho clamped
    # so that the kernel's tail stays below about 1e-8), the exact FFT
    # solve for short ones (where the framing would pad past the signal)
    taps = 256
    if n >= 2 * taps:
        rho_hi = torch.full_like(lam, 200.0)

        def solve(r, rho):
            return neumann_laplacian_solve_conv(r, rho, taps=taps)
    else:
        rho_hi = torch.full_like(lam, float("inf"))
        solve = neumann_laplacian_solve

    w = _soft(_diff(v), lam) if w0 is None else w0
    u = torch.zeros_like(w) if u0 is None else u0
    # the w-update's threshold is lam/rho: start rho near lam
    rho = torch.minimum(torch.maximum(torch.as_tensor(rho0, dtype=dt,
                                                      device=v.device), lam),
                        rho_hi)
    iters = 0
    gap = torch.full_like(lam, float("inf"))
    while iters < max_iters and bool(gap > gap_tol):
        w_prev = w
        for _ in range(check_every):
            x = solve(v + rho * _diff_t(w - u), rho)
            # over-relaxation (alpha = 1.8) on the splitting variable
            dx = 1.8 * _diff(x) + (1.0 - 1.8) * w
            w_prev, w = w, _soft(dx + u, lam / rho)
            u = u + dx - w
        # residual balancing: the scaled dual u tracks y/rho
        x = solve(v + rho * _diff_t(w - u), rho)
        r_p = torch.sqrt(torch.sum((_diff(x) - w) ** 2))
        r_d = rho * torch.sqrt(torch.sum(_diff_t(w - w_prev) ** 2))
        fac = torch.where(r_p > 10.0 * r_d, torch.full_like(rho, 2.0),
                          torch.where(r_d > 10.0 * r_p,
                                      torch.full_like(rho, 0.5),
                                      torch.ones_like(rho)))
        rho_new = torch.minimum(rho * fac, rho_hi)
        u = u * (rho / rho_new)
        rho = rho_new
        _, gap = tv1d_gap(v, lam, torch.clamp(rho * u, -lam, lam))
        iters += check_every
    xd, gap = tv1d_gap(v, lam, torch.clamp(rho * u, -lam, lam))
    return xd, gap, iters


def prox_tv1d_multiscale(v, lam, tol=1e-6, coarse_n: int = 2048,
                         fine_iters: int = 512, check_every: int = 32):
    """Gap-certified TV prox for LONG signals by multiscale continuation.

    Pair-decimation of the prox is again a TV prox (averaging pairs gives
    ``prox_{(lam/2) TV}(v_c)``), so recurse to at most ``coarse_n`` points,
    upsample, and rebuild the *dual* from the primal candidate through the
    KKT identity ``z = -cumsum(v - x)``: a warm primal-dual start for a
    short certified solve at the fine level.  The returned gap is the FINE
    level's certificate, so an error at a coarse level never goes unseen.
    Returns ``(x, gap, iters_at_finest)``."""
    n = v.shape[-1]
    if n <= coarse_n:
        return prox_tv1d_certified(v, lam, tol=tol)
    lamd = torch.as_tensor(lam, dtype=v.dtype, device=v.device)
    # the edge padding to an even length only shapes the warm start: the
    # certified solve below runs on the original signal
    v_even = v if n % 2 == 0 else torch.cat([v, v[-1:]])
    vc = 0.5 * (v_even[0::2] + v_even[1::2])
    xc, _, _ = prox_tv1d_multiscale(vc, 0.5 * lamd, tol=tol,
                                    coarse_n=coarse_n, fine_iters=fine_iters)
    x_hat = torch.repeat_interleave(xc, 2)[:n]
    # dual candidate from stationarity v - x = D^T z: z_k = -sum_{i<=k}(v-x)
    z = torch.clamp(-torch.cumsum(v - x_hat, dim=-1)[:-1], -lamd, lamd)
    rho0 = torch.clamp(lamd, min=1.0)
    return prox_tv1d_certified(v, lam, tol=tol, max_iters=fine_iters,
                               check_every=check_every, w0=_diff(x_hat),
                               u0=z / torch.clamp(rho0, max=200.0))


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


def pcr_tiled_solve(a, b, c, d, levels: int, tile: int, group: int = 0):
    """:func:`pcr_tridiag_solve` of vectors on the schedule of the TV-1D
    kernel's tile build (``csrc/tv1d_pdas.cu`` ``tile_stage``), in plain
    PyTorch, for the tests: tiles of ``tile`` rows, each in a window of the
    tile and ``2^levels - 1`` rows on each side, run levels ``0..levels-1``,
    each level over the rows still needed after it; the tiles' rows of
    level ``levels`` make the system that the remaining levels solve over
    the whole row, or, with ``group`` > 0, class by class in the residue
    stage, ``group`` classes a window (``residue_stage``:
    :func:`_residue_solve`).  With ``levels`` at or past the solve's steps
    the whole row is one window.  A row a window lacks reads NaN, and a row
    outside a level's range becomes NaN, so a schedule that reads a row it
    has not computed shows in the solve."""
    m = a.shape[-1]
    steps = tv1d_pdas.pcr_steps(m)
    nan = float("nan")

    def level(sys, first, lo, hi, k):
        # level k over rows [lo, hi) of the window `sys` (row `first` in slot 0)
        w = sys[0].shape[-1]
        s = 1 << k
        rows = torch.arange(lo, hi, device=a.device)

        def at(x, off, fill):
            j = rows + off
            slot = j - first
            got = torch.where((slot >= 0) & (slot < w), x[slot.clamp(0, w - 1)],
                              torch.full_like(x[:1], nan))
            return torch.where((j >= 0) & (j < m), got, torch.full_like(x[:1], fill))

        ai, bi, ci, di = (x[rows - first] for x in sys)
        bm, bp = at(sys[1], -s, 1.0), at(sys[1], s, 1.0)
        am, ap = at(sys[0], -s, 0.0), at(sys[0], s, 0.0)
        cm, cp = at(sys[2], -s, 0.0), at(sys[2], s, 0.0)
        dm, dp = at(sys[3], -s, 0.0), at(sys[3], s, 0.0)
        alpha = -ai / bm
        gamma = -ci / bp
        new = (alpha * am, bi + alpha * cm + gamma * ap, gamma * cp, di + alpha * dm + gamma * dp)
        out = tuple(torch.full_like(x, nan) for x in sys)
        for o, x in zip(out, new):
            o[rows - first] = x
        return out

    if levels >= steps:
        sys = (a, b, c, d)
        for k in range(steps):
            sys = level(sys, 0, 0, m, k)
        return sys[3] / sys[1]
    halo = (1 << levels) - 1
    held = tuple(torch.full_like(a, nan) for _ in range(4))
    for t0 in range(0, m, tile):
        t1 = min(t0 + tile, m)
        first, end = max(t0 - halo, 0), min(t1 + halo, m)
        sys = tuple(x[first:end] for x in (a, b, c, d))
        for k in range(levels):
            keep = halo - ((2 << k) - 1)
            sys = level(sys, first, max(t0 - keep, 0), min(t1 + keep, m), k)
        for h, x in zip(held, sys):
            h[t0:t1] = x[t0 - first:t1 - first]
    if group:
        return _residue_solve(held, levels, steps, group)
    for k in range(levels, steps):
        held = level(held, 0, 0, m, k)
    return held[3] / held[1]


def _residue_solve(held, levels: int, steps: int, group: int):
    """Levels ``levels..steps-1`` of the system ``held`` (level ``levels``
    of m rows) and its solve, on the kernel's residue stage: the system laid
    out class by class (row i at (i mod P) m_r + i // P, P = 2^levels, m_r =
    ceil(m / P)), windows of ``group`` classes, row j of class r0 + q at
    slot q m_r + j.  Every level tests the class's own ends (a neighbour
    past them an identity row).  A slot that holds no row is NaN and never
    computed, and a read past the window or of another class's row is
    NaN."""
    m = held[0].shape[-1]
    p, nan = 1 << levels, float("nan")
    rows = -(-m // p)
    dev = held[0].device
    # every group at once, one a row of the batch (the last group's missing
    # classes have no rows)
    x = torch.arange(group * rows, device=dev)
    q = x // rows
    cls = torch.arange(0, p, group, device=dev)[:, None] + q      # the slot's class
    j = (x - q * rows).expand_as(cls)
    held_rows = torch.where(cls < p, (m - 1 - cls) // p + 1, 0)   # the class's rows
    valid = j < held_rows
    i = (cls + j * p).clamp(0, m - 1)                              # the slot's row
    sys = tuple(torch.where(valid, h[i], torch.full_like(h[:1], nan)) for h in held)
    width = x.shape[0]
    for k in range(levels, steps):
        s = 1 << (k - levels)
        left = valid & (j >= s)
        right = valid & (s < held_rows - j)

        def at(t, off, ok, fill):
            # a slot past the window, or another class's row, reads NaN
            y = x + off
            inside = (y >= 0) & (y < width)
            y = y.clamp(0, width - 1)
            own = inside & ~(valid[:, y] & (cls[:, y] != cls))
            got = torch.where(own, t[:, y], torch.full_like(t[:1, :1], nan))
            return torch.where(ok, got, torch.full_like(t[:1, :1], fill))

        bm, bp = at(sys[1], -s, left, 1.0), at(sys[1], s, right, 1.0)
        am, ap = at(sys[0], -s, left, 0.0), at(sys[0], s, right, 0.0)
        cm, cp = at(sys[2], -s, left, 0.0), at(sys[2], s, right, 0.0)
        dm, dp = at(sys[3], -s, left, 0.0), at(sys[3], s, right, 0.0)
        ai, bi, ci, di = sys
        alpha = -ai / bm
        gamma = -ci / bp
        new = (alpha * am, bi + alpha * cm + gamma * ap, gamma * cp,
               di + alpha * dm + gamma * dp)
        sys = tuple(torch.where(valid, t, old) for t, old in zip(new, sys))
    out = torch.full_like(held[0], nan)
    out[(cls + j * p)[valid]] = (sys[3] / sys[1])[valid]
    return out


def prox_tv1d_pdas(v, lam, tol=None, max_iters: int = 40, z0=None,
                   return_dual: bool = False):
    """TV prox by PDAS on the dual box QP, with a projected line search on
    the exactly quadratic dual objective; stops when the active set is a
    fixed point with a full step, after ``max_iters`` rounds, or as soon as
    the duality gap meets ``tv_gap_tol(v, tol)``.  Returns
    ``(x, gap, iters)`` (and the dual with ``return_dual``).

    On a CPU tensor (and for n <= 1) this is the plain version,
    :func:`prox_tv1d_pdas_reference`, and ``iters`` an ``int``; on a CUDA
    tensor one launch of the ``tv1d_pdas`` kernel runs every round with its
    stop test on the device, and ``iters`` is a 0-d int32 tensor there
    (reading it is the caller's sync); any other device raises.  While a
    profiler records, each call, of either version, counts ``tv1d.calls``
    and adds its rounds to ``tv1d.rounds``
    (:func:`epsilon_tpu_torch.utils.timing.count`, no sync); K7's launch
    adds 1 to ``tv1d.residue`` where its plan runs the residue stage, else
    0, and the plain version 0."""
    if v.device.type == "cpu" or v.shape[-1] <= 1:
        out = prox_tv1d_pdas_reference(v, lam, tol=tol, max_iters=max_iters, z0=z0,
                                       return_dual=return_dual)
        count("tv1d.residue", 0)     # K7's launch counts its own plan
    else:
        if tol is None:
            tol = pdas_default_tol(v.dtype)
        x, z, gap, it = tv1d_pdas.pdas(v, lam, tol, max_iters=max_iters, z0=z0)
        out = (x, gap, it, z) if return_dual else (x, gap, it)
    count("tv1d.calls")
    count("tv1d.rounds", out[2])
    return out


def prox_tv1d_pdas_reference(v, lam, tol=None, max_iters: int = 40, z0=None,
                             return_dual: bool = False):
    """The plain version of :func:`prox_tv1d_pdas`: each round as eager
    operations, its stop test read on the host once a round."""
    dt = v.dtype
    n = v.shape[-1]
    if n <= 1:
        out = (v, torch.zeros((), dtype=dt, device=v.device), 0)
        return out + (v.new_zeros((0,)),) if return_dual else out
    # lam stays where it is: a number, or a 0-d tensor on the device (the
    # adaptive solver's lam/rho), never read back to the host
    lamd = lam.to(dt) if isinstance(lam, torch.Tensor) else float(lam)
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
