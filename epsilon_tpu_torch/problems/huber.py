"""Huber regression (``problems/huber.py``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(m, n):
    np.random.seed(0)
    x0 = np.random.randn(n)
    A = np.random.randn(m, n)
    A = A @ sp.diags(1.0 / np.sqrt(np.sum(A ** 2, 0)))
    b = A.dot(x0) + np.sqrt(0.01) * np.random.randn(m)
    b = b + 10 * np.asarray(sp.rand(m, 1, 0.05).todense()).ravel()

    x = ep.Variable(n)
    return ep.Problem(ep.Minimize(
        ep.sum_entries(ep.huber(ep._wrap(A) * x - b))))
