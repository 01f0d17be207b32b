"""Infinite-push ranking (``problems/infinite_push.py``)."""

import epsilon_tpu_torch as ep
from . import problem_util


def create(m, n, d):
    Xp = problem_util.normalized_data_matrix(m, d, 1)
    Xn = problem_util.normalized_data_matrix(n, d, 1)
    lam = 1.0

    theta = ep.Variable(d)
    f = ep.infinite_push(theta, Xp, Xn) + lam * ep.sum_squares(theta)
    f_eval = lambda: None
    return ep.Problem(ep.Minimize(f)), f_eval
