"""Robust PCA (``problems/robust_pca.py``)."""

import numpy as np
import scipy.sparse as sp

import epsilon_tpu_torch as ep


def create(n, r=10, density=0.1):
    np.random.seed(0)
    L1 = np.random.randn(n, r)
    L2 = np.random.randn(r, n)
    L0 = L1.dot(L2)
    S0 = sp.rand(n, n, density)
    S0.data = 10 * np.random.randn(len(S0.data))
    M = L0 + S0.toarray()
    lam = 0.1

    L = ep.Variable(n, n)
    S = ep.Variable(n, n)
    f = ep.norm_nuc(L) + lam * ep.norm1(ep.vec(S))
    C = [L + S == M]
    return ep.Problem(ep.Minimize(f), C)
