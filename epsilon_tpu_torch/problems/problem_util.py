"""Shared generators for the problem library (``problems/problem_util.py``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def hinge(x):
    return ep.sum_entries(ep.max_elemwise(x, 0))


def normalized_data_matrix(m, n, mu):
    """Column-normalized dense (mu=1) or sparse (mu<1 density) data matrix
    (``problem_util.py:9-22``)."""
    if mu == 1:
        A = np.random.randn(m, n)
        A /= np.sqrt(np.sum(A ** 2, 0))
    else:
        A = sp.rand(m, n, mu, format="csc")
        A.data = np.random.randn(A.nnz)
        N = A.copy()
        N.data = N.data ** 2
        col_norms = np.sqrt(np.ravel(N.sum(axis=0)))
        col_norms[col_norms == 0] = 1.0
        A = A @ sp.diags(1.0 / col_norms)
    return A


def create_regression(m, n, k=1, rho=1, mu=1, sigma=0.05):
    """Random (multivariate) regression instance (``problem_util.py:24-42``)."""
    A = normalized_data_matrix(m, n, mu)
    if k == 1:
        x0 = sp.rand(n, 1, rho)
        x0.data = np.random.randn(x0.nnz)
        x0 = x0.toarray().ravel()
        b = A.dot(x0) + sigma * np.random.randn(m)
        return A, b
    X0 = sp.rand(n, k, rho)
    X0.data = np.random.randn(X0.nnz)
    X0 = X0.toarray()
    B = A.dot(X0) + sigma * np.random.randn(m, k)
    return A, B


def create_classification(m, n, rho=1, mu=1, sigma=0.05):
    """Random classification instance (``problem_util.py:44-52``)."""
    A = normalized_data_matrix(m, n, mu)
    x0 = sp.rand(n, 1, rho)
    x0.data = np.random.randn(x0.nnz)
    x0 = x0.toarray().ravel()
    b = np.sign(A.dot(x0) + sigma * np.random.randn(m))
    b[b == 0] = 1
    return A, b
