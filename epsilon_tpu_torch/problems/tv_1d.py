"""1-D total variation smoothing (``problems/tv_1d.py:5-20``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(n):
    np.random.seed(0)
    k = max(int(np.sqrt(n) / 2), 1)
    x0 = np.ones(n)
    idxs = np.random.randint(0, n, (k, 2))
    idxs.sort()
    for a, b in idxs:
        x0[a:b] += 10 * (np.random.rand() - 0.5)
    b = x0 + np.random.randn(n)

    lam = np.sqrt(n)
    x = ep.Variable(n)
    f = 0.5 * ep.sum_squares(x - b) + lam * ep.tv(x)
    return ep.Problem(ep.Minimize(f))
