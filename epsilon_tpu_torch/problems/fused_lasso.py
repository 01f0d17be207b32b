"""Fused lasso (``problems/fused_lasso.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(m, ni, k, rho=0.05, sigma=0.05):
    np.random.seed(0)
    A = np.random.randn(m, ni * k)
    A /= np.sqrt(np.sum(A ** 2, 0))

    x0 = np.zeros(ni * k)
    for i in range(k):
        if np.random.rand() < rho:
            x0[i * ni:(i + 1) * ni] = np.random.rand()
    b = A.dot(x0) + sigma * np.random.randn(m)

    lam = 0.1 * sigma * np.sqrt(m * np.log(ni * k))
    x = ep.Variable(A.shape[1])
    f = (ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)
         + lam * ep.tv(x))
    return ep.Problem(ep.Minimize(f))
