"""Standard SVM: hinge loss w/ l2 regularization (``problems/hinge_l2.py``)."""

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    A, b = problem_util.create_classification(**kwargs)
    lam = 1.0
    x = ep.Variable(A.shape[1])
    f = ep.hinge_loss(x, A, b) + lam * ep.sum_squares(x)
    return ep.Problem(ep.Minimize(f))
