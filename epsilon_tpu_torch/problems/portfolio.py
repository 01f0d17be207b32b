"""Factor-model portfolio optimization (``problems/portfolio.py:5-21``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(m, n, density=0.1):
    np.random.seed(0)
    mu = np.exp(0.01 * np.random.randn(n)) - 1
    D = np.random.rand(n) / 10
    F = sp.rand(n, m, density)
    F.data = np.random.randn(len(F.data)) / 10
    gamma = 1.0
    B = 1.0

    x = ep.Variable(n)
    f = (ep._wrap(mu.reshape(1, -1)) * x
         - gamma * (ep.sum_squares(ep._wrap(F.T) * x)
                    + ep.sum_squares(ep.mul_elemwise(D.reshape(-1, 1), x))))
    C = [ep.sum_entries(x) == B, x >= 0]
    return ep.Problem(ep.Maximize(f), C)
