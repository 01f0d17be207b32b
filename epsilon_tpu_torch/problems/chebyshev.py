"""Chebyshev-style minimax with SOC constraints (``problems/chebyshev.py``)."""

import numpy as np

import epsilon_tpu_torch as ep
from . import problem_util


def create(**kwargs):
    m, n = kwargs["m"], kwargs["n"]
    k = 10
    A = [problem_util.normalized_data_matrix(m, n, 1) for _ in range(k)]
    B = problem_util.normalized_data_matrix(k, n, 1)
    c = np.random.rand(k)

    x = ep.Variable(n)
    t = ep.Variable(k)
    f = ep.max_entries(t + ep.abs(ep._wrap(B) * x - c))
    C = [ep.norm2(ep._wrap(A[i]) * x) <= t[i] for i in range(k)]

    def f_eval():
        tv = np.array([np.linalg.norm(A[i] @ x.value.ravel()) for i in range(k)])
        return np.max(tv + np.abs(B @ x.value.ravel() - c))

    return ep.Problem(ep.Minimize(f), C), f_eval
