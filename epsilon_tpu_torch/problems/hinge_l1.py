"""L1 SVM (``problems/hinge_l1.py``)."""

import numpy as np

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    A, b = problem_util.create_classification(**kwargs)
    m, n = kwargs["m"], kwargs["n"]
    sigma = 0.05
    mu = kwargs.get("mu", 1)
    lam = 0.5 * sigma * np.sqrt(m * np.log(mu * n))

    x = ep.Variable(A.shape[1])
    f = ep.hinge_loss(x, A, b) + lam * ep.norm1(x)
    return ep.Problem(ep.Minimize(f))
