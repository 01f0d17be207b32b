"""L1-regularized logistic regression (``problems/logreg_l1.py:7-19``)."""

import numpy as np

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    A, b = problem_util.create_classification(**kwargs)
    A_dense = A if isinstance(A, np.ndarray) else A.toarray()
    ratio = float(np.sum(b == 1)) / len(b)
    lambda_max = np.abs((1 - ratio) * A_dense[b == 1, :].sum(axis=0)
                        + ratio * A_dense[b == -1, :].sum(axis=0)).max()
    lam = 0.5 * lambda_max

    x = ep.Variable(A.shape[1])
    f = ep.logistic_loss(x, A, b) + lam * ep.norm1(x)
    return ep.Problem(ep.Minimize(f))
