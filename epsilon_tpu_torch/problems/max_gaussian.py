"""Max-likelihood Gaussian covariance w/ sum-largest (``problems/max_gaussian.py``)."""

import numpy as np

import epsilon_tpu_torch as ep


def create(**kwargs):
    m, n, k = kwargs["m"], kwargs["n"], kwargs["k"]
    np.random.seed(0)
    A = np.random.rand(m, n)
    A -= np.mean(A, axis=0)
    K = np.array([np.outer(A[i], A[i]).flatten(order="F") for i in range(m)])

    sigma = ep.Variable(n, n)
    t = ep.Variable(m)
    tdet = ep.Variable(1)
    f = ep.sum_largest(t + tdet, k)
    z = ep._wrap(K) * ep.reshape(sigma, n * n, 1)
    C = [-ep.log_det(sigma) <= tdet, t == z]
    f_eval = lambda: None
    return ep.Problem(ep.Minimize(f), C), f_eval
