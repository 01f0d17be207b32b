"""Sparse inverse covariance selection (``problems/covsel.py:5-24``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(m, n, lam):
    np.random.seed(0)
    m = int(n)
    n = int(n)
    lam = float(lam)

    A = sp.rand(n, n, 0.01)
    A = np.asarray((A.T @ A).todense()) + 0.1 * np.eye(n)
    L = np.linalg.cholesky(np.linalg.inv(A))
    X = np.random.randn(m, n).dot(L.T)
    S = X.T.dot(X) / m
    W = np.ones((n, n)) - np.eye(n)

    Theta = ep.Variable(n, n)
    return ep.Problem(ep.Minimize(
        lam * ep.norm1(ep.vec(ep.mul_elemwise(W, Theta)))
        + ep.sum_entries(ep.mul_elemwise(S, Theta))
        - ep.log_det(Theta)))
