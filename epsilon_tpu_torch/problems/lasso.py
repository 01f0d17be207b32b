"""Lasso (``problems/lasso.py:8-16``)."""

import numpy as np

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    A, B = problem_util.create_regression(**kwargs)
    A_dense = A if isinstance(A, np.ndarray) else A.toarray()
    lambda_max = np.abs(A_dense.T.dot(B)).max()
    lam = 0.5 * lambda_max

    k = B.shape[1] if B.ndim > 1 else 1
    X = ep.Variable(A.shape[1], k)
    f = ep.sum_squares(ep._wrap(A) * X - B.reshape(-1, k)) + lam * ep.norm1(ep.vec(X))
    return ep.Problem(ep.Minimize(f))
