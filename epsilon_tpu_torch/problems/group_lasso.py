"""Group lasso (``problems/group_lasso.py``)."""

import numpy as np

import epsilon_tpu_torch as ep
from . import problem_util


def create(m, ni, K):
    np.random.seed(0)
    part = np.random.randint(1, ni, K)
    n = int(np.sum(part))
    p = 0.2
    pb = np.cumsum(part)
    pa = np.hstack((0, pb[:-1]))

    x0 = np.zeros(n)
    for i in range(K):
        if np.random.rand() < p:
            x0[pa[i]:pb[i]] = np.random.randn(part[i])

    A = problem_util.normalized_data_matrix(m, n, 1)
    b = A.dot(x0) + np.sqrt(0.001) * np.random.randn(m)
    lam = 0.1 * max(np.linalg.norm(A[:, pa[i]:pb[i]].T.dot(b))
                    for i in range(K))

    x = ep.Variable(n)
    f = 0.5 * ep.sum_squares(ep._wrap(A) * x - b)
    for i in range(K):
        f = f + lam * ep.norm2(x[int(pa[i]):int(pb[i])])
    return ep.Problem(ep.Minimize(f))
