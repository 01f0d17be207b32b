"""Least absolute deviations with outliers (``problems/least_abs_dev.py``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(m, n):
    np.random.seed(0)
    A = np.random.randn(m, n)
    A = A @ sp.diags(1.0 / np.sqrt(np.sum(A ** 2, 0)))
    b = A.dot(10 * np.random.randn(n))
    k = max(m // 50, 1)
    idx = np.random.randint(0, m, k)
    b[idx] += 100 * np.random.randn(k)

    x = ep.Variable(n)
    return ep.Problem(ep.Minimize(ep.norm1(ep._wrap(A) * x - b)))
