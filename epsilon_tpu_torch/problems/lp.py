"""Standard-form LP (``problems/lp.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(m, n):
    np.random.seed(0)
    A = np.abs(np.random.randn(m, n))
    b = A.dot(np.abs(np.random.randn(n)))
    c = np.random.rand(n) + 0.5

    x = ep.Variable(n)
    return ep.Problem(ep.Minimize(ep._wrap(c.reshape(1, -1)) * x),
                      [ep._wrap(A) * x == b, x >= 0])
