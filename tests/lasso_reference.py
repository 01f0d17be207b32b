"""A plain reference for the lasso, independent of both packages:

    minimize  F(x) = ||A x - b||^2 + lam ||x||_1

by the feature-sign search (Lee, Battle, Raina and Ng, "Efficient sparse
coding algorithms", NIPS 2006): an active-set method that solves the
stationarity equations on a signed support exactly, line-searches to the
best point where a sign changes, and adds the coordinate whose zero most
violates optimality, in float64 torch.  The answer is exact up to rounding;
it is returned with a certified duality gap: the dual is  maximize D(nu) =
nu^T b - ||nu||^2 / 4  over ||A^T nu||_inf <= lam, and nu = 2 (b - A x)
scaled into that box is a dual point for any x.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Solution:
    x: np.ndarray           # float64
    primal: float           # F(x)
    dual: float             # D(nu), nu the scaled dual point below
    nu: np.ndarray


def objective(A, b, lam, x) -> float:
    A, b, x = (torch.as_tensor(np.asarray(t), dtype=torch.float64) for t in (A, b, x))
    r = A @ x - b
    return float(r @ r + lam * x.abs().sum())


def dual_point(A, b, lam, x):
    """(nu, D(nu)): the residual's dual point, scaled into the box."""
    A, b, x = (torch.as_tensor(np.asarray(t), dtype=torch.float64) for t in (A, b, x))
    nu = 2.0 * (b - A @ x)
    top = float((A.T @ nu).abs().max())
    if top > lam:
        nu = nu * (lam / top)
    return nu.numpy(), float(nu @ b - 0.25 * (nu @ nu))


def lam_max(A, b) -> float:
    """The least lam at which x* = 0: 2 ||A^T b||_inf."""
    return 2.0 * float(np.abs(np.asarray(A).T @ np.asarray(b)).max())


MAX_STEPS = 10000


def lasso_fss(A, b, lam, x0=None, gap_tol=1e-11) -> Solution:
    """Solve exactly and certify a relative duality gap of ``gap_tol``;
    ``x0`` warm-starts (a path's previous answer: its support and signs)."""
    At = torch.as_tensor(np.asarray(A), dtype=torch.float64)
    bt = torch.as_tensor(np.asarray(b), dtype=torch.float64)
    G, c = At.T @ At, At.T @ bt
    n = At.shape[1]
    x = torch.zeros(n, dtype=torch.float64) if x0 is None else \
        torch.as_tensor(np.asarray(x0), dtype=torch.float64).clone()
    theta = torch.sign(x)
    tol = 1e-12 * max(lam, float(c.abs().max()))

    def F(z):
        return float(z @ (G @ z) - 2.0 * (c @ z) + lam * z.abs().sum())

    for _ in range(MAX_STEPS):
        grad = 2.0 * (G @ x - c)                 # of ||A x - b||^2
        nonzero = x != 0
        if not nonzero.any() or float((grad + lam * theta)[nonzero].abs().max()) <= tol:
            # the nonzeros are optimal: add the zero that most violates
            # |grad_j| <= lam, or stop
            viol = torch.where(nonzero, torch.zeros_like(grad), grad.abs())
            j = int(torch.argmax(viol))
            if float(viol[j]) <= lam + tol:
                break
            theta[j] = -torch.sign(grad[j])
        # the feature-sign step on the signed support
        S = torch.nonzero(theta).flatten()
        target = torch.zeros_like(x)
        target[S] = torch.linalg.solve(G[S][:, S], c[S] - 0.5 * lam * theta[S])
        d = target - x
        crossing = (x != 0) & (torch.sign(target) != torch.sign(x))
        cands = [target]
        for i in torch.nonzero(crossing).flatten().tolist():
            z = x - (x[i] / d[i]) * d
            z[i] = 0.0
            cands.append(z)
        x = min(cands, key=F)
        theta = torch.sign(x)
    else:
        raise RuntimeError(f"no answer in {MAX_STEPS} steps")
    xs = x.numpy()
    primal = objective(A, b, lam, xs)
    nu, dual = dual_point(A, b, lam, xs)
    if primal - dual > gap_tol * abs(primal):
        raise RuntimeError(f"gap {primal - dual!r} of {primal!r} is not certified")
    return Solution(xs, primal, dual, nu)


def lasso_path(A, b, lams, gap_tol=1e-11):
    """Each lam's answer, warm-started from the previous one's."""
    out, x = [], None
    for lam in lams:
        sol = lasso_fss(A, b, float(lam), x0=x, gap_tol=gap_tol)
        out.append(sol)
        x = sol.x
    return out
