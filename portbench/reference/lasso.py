"""The lasso, solved again in plain PyTorch:

    minimize  F(x) = ||A x - b||^2 + lam ||x||_1

by FISTA (Beck and Teboulle, "A fast iterative shrinkage-thresholding
algorithm", 2009) with gradient-based adaptive restart (O'Donoghue and
Candes, 2015), and, at every check, a polish on the iterate's support: the
stationarity equations A_S^T (A_S x_S - b) + (lam / 2) sign(x_S) = 0 solved
on the support S with the iterate's signs.  Stopped by a certified duality
gap: the dual is  maximize D(nu) = nu^T b - ||nu||^2 / 4  over
||A^T nu||_inf <= lam, and nu = 2 (b - A x), scaled into that box, is a
dual point for any x, so F(x) - D(nu) bounds x's suboptimality.  A polished
point is taken only once its own gap certifies it.

Float64 on the device it is given.  ``control`` rounds the inputs of every
matrix product (A, the iterates, the residuals, b) to bfloat16, the
precision control: its answer is that of the problem in bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class LassoResult:
    x: torch.Tensor         # the primal point, float64
    primal: float           # F(x)
    dual: float             # D(nu(x)), a lower bound on the optimum
    iterations: int


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float64)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def lipschitz(A) -> float:
    """2 ||A||_2^2, the gradient's Lipschitz constant, from the smaller Gram
    matrix's largest eigenvalue."""
    G = A @ A.T if A.shape[0] <= A.shape[1] else A.T @ A
    return 2.0 * float(torch.linalg.eigvalsh(G)[-1])


# iterations between two certificates (each with a polish)
CHECK_EVERY = 10


def lasso(A, b, lam: float, gap_tol: float = 1e-10, max_iterations: int = 20000,
          control: bool = False, L: float = None) -> LassoResult:
    """Solve to a relative duality gap of ``gap_tol`` (or stop at
    ``max_iterations`` with the best point seen).  ``L``: a precomputed
    :func:`lipschitz` of the same A."""
    q = _bf16 if control else _same
    A, b = A.to(torch.float64), b.to(torch.float64)
    Aq, bq = q(A), q(b)
    lam = float(lam)
    L = L or lipschitz(Aq)
    n = A.shape[1]

    def grad(x):
        return 2.0 * (Aq.T @ q(Aq @ q(x) - bq))

    def certificate(x):
        r = bq - Aq @ q(x)
        primal = float(r @ r + lam * x.abs().sum())
        nu = 2.0 * r
        top = float((Aq.T @ q(nu)).abs().max())
        if top > lam:
            nu = nu * (lam / top)
        dual = float(nu @ bq - 0.25 * (nu @ nu))
        return primal, dual

    x = torch.zeros(n, dtype=torch.float64, device=A.device)
    x_prev, t = x, 1.0
    best = (math.inf, -math.inf, x)
    it = 0
    while it < max_iterations:
        it += 1
        t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = x + ((t - 1.0) / t_next) * (x - x_prev)
        v = y - grad(y) / L
        x_new = torch.sign(v) * torch.clamp(v.abs() - lam / L, min=0.0)
        if float((y - x_new) @ (x_new - x)) > 0.0:
            t_next = 1.0                # restart the momentum
        x_prev, x, t = x, x_new, t_next
        if it % CHECK_EVERY and it < max_iterations:
            continue
        for cand in (x, _polish(Aq, bq, lam, x)):
            if cand is None:
                continue
            primal, dual = certificate(cand)
            if primal < best[0]:
                best = (primal, max(dual, best[1]), cand)
            if primal - dual <= gap_tol * abs(primal):
                return LassoResult(cand, primal, dual, it)
    return LassoResult(best[2], best[0], best[1], it)


def _polish(Aq, bq, lam, x):
    """The point that solves the stationarity equations on ``x``'s support
    with ``x``'s signs, or None where the support is empty, larger than
    the rows, or the signs do not hold."""
    S = torch.nonzero(x).flatten()
    if S.numel() == 0 or S.numel() > Aq.shape[0]:
        return None
    AS = Aq[:, S]
    s = torch.sign(x[S])
    rhs = AS.T @ bq - 0.5 * lam * s
    chol, info = torch.linalg.cholesky_ex(AS.T @ AS)
    if int(info) != 0:
        return None
    xs = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    if not torch.equal(torch.sign(xs), s):
        return None
    out = torch.zeros_like(x)
    out[S] = xs
    return out
