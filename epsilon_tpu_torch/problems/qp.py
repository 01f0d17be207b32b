"""Box-constrained QP (``problems/qp.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(n):
    np.random.seed(0)
    P = np.random.rand(n, n)
    P = P.T.dot(P) + np.eye(n)
    q = np.random.randn(n)
    lb = np.random.randn(n)
    ub = np.random.randn(n)
    lb, ub = np.minimum(lb, ub), np.maximum(lb, ub)

    # 0.5 x'Px + q'x via sum_squares of the Cholesky factor (quad_form)
    L = np.linalg.cholesky(P)
    x = ep.Variable(n)
    f = 0.5 * ep.sum_squares(ep._wrap(L.T) * x) + ep._wrap(q.reshape(1, -1)) * x
    C = [x >= lb, x <= ub]
    return ep.Problem(ep.Minimize(f), C)
