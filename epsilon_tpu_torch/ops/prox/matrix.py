"""Matrix (orthogonally invariant) proximal operators.

Counterpart of ``epsilon_tpu/ops/prox/matrix.py``: eigendecompose the
symmetric part of the argument (``torch.linalg.eigh``, cuSOLVER on the
card) or take its SVD, apply a vector prox or epigraph to the spectrum and
reconstruct.  Valid by the Lewis/Davis theorem for spectral functions.
"""

from __future__ import annotations

import torch

from . import elementwise, vector


def _sym(V):
    return 0.5 * (V + V.transpose(-1, -2))


def _rebuild(U, x, Vt):
    return (U * x[..., None, :]) @ Vt


def _spectral_prox(V, prox_eigs):
    """U diag(prox(d)) U^T on the symmetric part of V."""
    d, U = torch.linalg.eigh(_sym(V))
    return _rebuild(U, prox_eigs(d), U.transpose(-1, -2))


def _spectral_epi(V, s, epi_eigs):
    d, U = torch.linalg.eigh(_sym(V))
    x, t = epi_eigs(d, s)
    return _rebuild(U, x, U.transpose(-1, -2)), t


def _svd(V):
    return torch.linalg.svd(V, full_matrices=False)


# semidefinite: I(X >= 0)

def prox_semidefinite(V, lam=None):
    return _spectral_prox(V, lambda d: torch.clamp(d, min=0.0))


# neg_log_det: f(X) = -log det X

def prox_neg_log_det(V, lam):
    return _spectral_prox(V, lambda d: elementwise.prox_sum_neg_log(d, lam))


def eval_neg_log_det(X):
    return -torch.sum(torch.log(torch.linalg.eigvalsh(_sym(X))), dim=-1)


def epi_neg_log_det(V, s):
    return _spectral_epi(V, s, elementwise.epi_sum_neg_log)


# lambda_max: f(X) = largest eigenvalue

def prox_lambda_max(V, lam):
    return _spectral_prox(V, lambda d: vector.prox_max(d, lam))


def eval_lambda_max(X):
    return torch.amax(torch.linalg.eigvalsh(_sym(X)), dim=-1)


def epi_lambda_max(V, s):
    return _spectral_epi(V, s, vector.epi_max)


# norm_nuclear: f(X) = sum of singular values (singular-value thresholding)

def prox_norm_nuclear(V, lam):
    U, sv, Vt = _svd(V)
    return _rebuild(U, torch.clamp(sv - lam, min=0.0), Vt)


def eval_norm_nuclear(X):
    return torch.sum(torch.linalg.svdvals(X), dim=-1)


def epi_norm_nuclear(V, s):
    """The norm-1 epigraph on the singular values."""
    U, sv, Vt = _svd(V)
    x, t = elementwise.epi_scaled_zone(sv, s)
    return _rebuild(U, x, Vt), t


# sigma_max: f(X) = largest singular value (norm_inf on the spectrum)

def prox_sigma_max(V, lam):
    U, sv, Vt = _svd(V)
    return _rebuild(U, vector.prox_norm_inf(sv, lam), Vt)


def eval_sigma_max(X):
    return torch.amax(torch.linalg.svdvals(X), dim=-1)


def epi_sigma_max(V, s):
    U, sv, Vt = _svd(V)
    x, t = vector.epi_norm_inf(sv, s)
    return _rebuild(U, x, Vt), t
