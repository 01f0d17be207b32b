"""Basis pursuit (``problems/basis_pursuit.py``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(m, n):
    np.random.seed(0)
    A = np.random.randn(m, n)
    x0 = sp.rand(n, 1, 0.1)
    b = (A @ x0.toarray()).ravel()

    x = ep.Variable(n)
    return ep.Problem(ep.Minimize(ep.norm1(x)), [ep._wrap(A) * x == b])
