"""Top-p softmax loss (``problems/max_softmax.py``)."""

import numpy as np

import epsilon_tpu_torch as ep
from ..frontend.functions import one_hot
from . import problem_util


def create(**kwargs):
    k, m, n = kwargs["k"], kwargs["m"], kwargs["n"]
    p = 5
    np.random.seed(0)
    X = problem_util.normalized_data_matrix(m, n, 1)
    Y = np.random.randint(0, k, m)

    Theta = ep.Variable(n, k)
    t = ep.Variable(1)
    texp = ep.Variable(m)
    f = t + ep.sum_largest(texp, p) + ep.sum_squares(Theta)
    C = [ep.log_sum_exp(ep._wrap(X) * Theta, axis=1) <= texp]
    Yi = one_hot(Y, k)
    C.append(-ep.sum_entries(ep.mul_elemwise(X.T.dot(Yi), Theta)) == t)
    f_eval = lambda: None
    return ep.Problem(ep.Minimize(f), C), f_eval
