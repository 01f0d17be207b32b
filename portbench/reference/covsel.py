"""The graphical lasso, solved again in plain PyTorch:

    minimize  lam * sum_ij W_ij |Theta_ij| + <S, Theta> - log det Theta

by ADMM on Theta = Z (Boyd et al., "Distributed optimization and
statistical learning via ADMM", 2011, section 6.5: the Theta-update by one
symmetric eigendecomposition, the Z-update by soft thresholding), with
residual balancing of rho, stopped by a duality gap: the dual of the
problem is  maximize log det(S + G) + p  over |G_ij| <= lam W_ij, and
G = clip(Theta^-1 - S) is a dual point for any iterate, so
F(Theta) - D(G) bounds Theta's suboptimality.

Float64 on the device it is given.  ``matmul_tf32`` runs the same
arithmetic in float32 with TF32 matrix products, the precision control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class GlassoResult:
    theta: torch.Tensor     # the primal iterate, symmetric positive definite
    primal: float           # F(theta)
    dual: float             # D(G(theta)), a lower bound on the optimum
    iterations: int


def objective(S, W, lam, theta) -> float:
    """F(theta) in float64; +inf where theta is not positive definite."""
    theta = theta.to(torch.float64)
    L, info = torch.linalg.cholesky_ex(0.5 * (theta + theta.T))
    if int(info) != 0:
        return math.inf
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return float(lam * (W * theta).abs().sum() + (S * theta).sum() - logdet)


def _dual(S, W, lam, theta_inv) -> float:
    G = torch.maximum(torch.minimum(theta_inv - S, lam * W), -lam * W)
    L, info = torch.linalg.cholesky_ex(S + G)
    if int(info) != 0:
        return -math.inf
    return float(2.0 * torch.log(torch.diagonal(L)).sum() + S.shape[0])


def glasso(S, W, lam: float, rho: float = 1.0, gap_tol: float = 1e-9,
           max_iterations: int = 5000, check_every: int = 10, start=None,
           matmul_tf32: bool = False) -> GlassoResult:
    """Solve to a relative duality gap of ``gap_tol`` (or stop at
    ``max_iterations``).  ``start`` is an earlier result's ``(Z, U, rho)``
    from :attr:`state`, for a path of lam values."""
    dtype = torch.float32 if matmul_tf32 else torch.float64
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(matmul_tf32)
    try:
        return _glasso(S.to(dtype), W.to(dtype), float(lam), float(rho), gap_tol,
                       max_iterations, check_every, start)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _glasso(S, W, lam, rho, gap_tol, max_iterations, check_every, start):
    p = S.shape[0]
    if start is None:
        Z = torch.diag(1.0 / torch.diagonal(S))
        U = torch.zeros_like(S)
    else:
        Z, U, rho = (t.to(S.dtype) if torch.is_tensor(t) else t for t in start)
    S64, W64 = S.to(torch.float64), W.to(torch.float64)
    it = 0
    primal, dual = math.inf, -math.inf
    while it < max_iterations:
        it += 1
        d, Q = torch.linalg.eigh(rho * (Z - U) - S)
        th = (d + torch.sqrt(d * d + 4.0 * rho)) / (2.0 * rho)
        theta = (Q * th) @ Q.T
        theta = 0.5 * (theta + theta.T)
        V = theta + U
        Z_old = Z
        Z = torch.sign(V) * torch.clamp(V.abs() - (lam / rho) * W, min=0.0)
        U = U + theta - Z
        if it % check_every == 0 or it == max_iterations:
            theta_inv = (Q * (1.0 / th)) @ Q.T
            primal = objective(S64, W64, lam, theta)
            dual = _dual(S64, W64, lam, theta_inv.to(torch.float64))
            if primal - dual <= gap_tol * abs(primal):
                break
            # residual balancing (Boyd et al. 3.4.1), U rescaled with rho
            r = float(torch.linalg.norm(theta - Z))
            s = rho * float(torch.linalg.norm(Z - Z_old))
            if r > 10.0 * s:
                rho *= 2.0
                U = U / 2.0
            elif s > 10.0 * r:
                rho /= 2.0
                U = U * 2.0
    res = GlassoResult(theta, primal, dual, it)
    res.state = (Z, U, rho)
    return res
