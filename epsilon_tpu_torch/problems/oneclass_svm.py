"""One-class SVM (``problems/oneclass_svm.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(m, n):
    np.random.seed(0)
    A = np.random.randn(m, n)
    A /= np.sqrt(np.sum(A ** 2, axis=1))[:, np.newaxis]
    A *= (np.random.rand(m) ** (1.0 / n))[:, np.newaxis]
    k = max(m // 50, 1)
    idx = np.random.randint(0, m, k)
    A[idx, :] += np.random.randn(k, n)
    lam = 1.0

    x = ep.Variable(n)
    rho = ep.Variable(1)
    t = ep.Variable(1)
    z = np.sum(A ** 2, axis=1) - 2 * ep._wrap(A) * x + t
    f = ((1.0 / n) * ep.sum_entries(ep.max_elemwise(z - rho, 0))
         + lam * ep.sum_entries(ep.max_elemwise(rho, 0)))
    C = [ep.sum_squares(x) <= t]
    f_eval = lambda: None
    return ep.Problem(ep.Minimize(f), C), f_eval
