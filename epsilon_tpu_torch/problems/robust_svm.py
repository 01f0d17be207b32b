"""Robust SVM with norm-ball uncertainty (``problems/robust_svm.py``)."""

import numpy as np
import scipy.linalg as la
import scipy.sparse as sp

import epsilon_tpu_torch as ep
from . import problem_util


def create(m, n):
    np.random.seed(0)
    mu, rho, sigma = 1, 1, 0.1
    A = problem_util.normalized_data_matrix(m, n, mu)
    x0 = sp.rand(n, 1, rho)
    x0.data = np.random.randn(x0.nnz)
    x0 = x0.toarray().ravel()
    b = np.sign(A.dot(x0) + sigma * np.random.randn(m))
    b[b == 0] = 1
    A[b > 0, :] += 0.7 * np.tile([x0], (int(np.sum(b > 0)), 1))
    A[b < 0, :] -= 0.7 * np.tile([x0], (int(np.sum(b < 0)), 1))
    P = la.block_diag(np.random.randn(n - 1, n - 1), 0)
    lam = 1.0

    x = ep.Variable(n)
    t = ep.Variable(1)
    z = 1 - ep._wrap(sp.diags(b) @ A) * x + t
    f = lam * ep.sum_squares(x) + ep.sum_entries(ep.max_elemwise(z, 0))
    C = [ep.norm1(ep._wrap(P.T) * x) <= t]
    f_eval = lambda: None
    return ep.Problem(ep.Minimize(f), C), f_eval
