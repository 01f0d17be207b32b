"""Unregularized hinge loss (``problems/hinge.py``)."""

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    A, b = problem_util.create_classification(**kwargs)
    x = ep.Variable(A.shape[1])
    return ep.Problem(ep.Minimize(ep.hinge_loss(x, A, b)))
