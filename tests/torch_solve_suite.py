"""The oracle matrix of ``tests/test_solve_suite.py`` run on the port.

Each case calls one of the suite's test functions with its module global
``ep`` pointed at ``epsilon_tpu_torch``: the suite builds its problem with
the port, solves it under one of the three parameter sets and holds the
objective to its independent oracle (scipy, sklearn, numpy), as it does for
the JAX package.  The suite's oracle data made with the JAX package's
helpers (``one_hot``, ``tv1d_exact_numpy``) are numpy arrays and stay as
the suite has them.

``tests/test_torch_solve_suite_{a,b,c}.py`` split the cases in three files
of similar load (the tier-1 run hands each file to one worker).
"""

import importlib

import pytest
import torch

import epsilon_tpu_torch as et
import test_solve_suite as suite
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.solvers import ProxADMMSolver, ProxADMMTwoBlockSolver, SolverKind

# the module (the package's ``frontend.solve`` is its function of that name)
tsolve = importlib.import_module("epsilon_tpu_torch.frontend.solve")

# the suite's three parameter sets in the port's terms, by the suite's ids
PARAMS = {
    "two_block": {},
    "n_block": {"solver": SolverKind.PROX_ADMM},
    "no_epi": {"use_epigraph": False},
}
# the solver each set must build
SOLVER_CLASS = {
    "two_block": ProxADMMTwoBlockSolver,
    "n_block": ProxADMMSolver,
    "no_epi": ProxADMMTwoBlockSolver,
}
# the suite's 27 rows: its test function and the leading arguments
ROW_TESTS = {
    **{v: ("test_lasso_family", v) for v in ("lasso", "mv_lasso", "sparse_lasso")},
    **{v: ("test_hinge_family", v) for v in ("hinge", "hinge_l1", "hinge_l2")},
    **{r: ("test_" + r,) for r in (
        "logreg_l1", "basis_pursuit", "least_abs_dev", "lp", "qp", "chebyshev",
        "covsel", "fused_lasso", "group_lasso", "huber", "infinite_push",
        "max_gaussian", "max_softmax", "oneclass_svm", "portfolio", "quantile",
        "robust_pca", "robust_svm", "tv_1d", "tv_denoise", "mnist")},
}
# the rows that test_port_meets_solve_suite_oracle in
# tests/test_torch_library_{a,b,c}.py holds under two_block
MET = {"basis_pursuit", "chebyshev", "covsel", "huber", "infinite_push", "logreg_l1", "lp",
       "max_gaussian", "quantile", "robust_pca", "tv_1d", "portfolio"}
# a case that takes more than 60 s alone on an 8-core CPU: on the CPU the
# port runs the plain full-count LOG_SUM_EXP loops (mnist's 10-wide prox,
# max_softmax's epigraph)
SLOW = {("max_softmax", "two_block"), ("max_softmax", "n_block"),
        ("mnist", "two_block"), ("mnist", "n_block"), ("mnist", "no_epi")}


def cases(rows):
    """pytest params ``(row, params)`` for ``rows`` under every set, but
    under two_block only those not in ``MET``; ``SLOW`` cases marked."""
    return [pytest.param(row, params, id=f"{row}-{params}",
                         marks=[pytest.mark.slow] if (row, params) in SLOW else [])
            for row in rows for params in PARAMS
            if params != "two_block" or row not in MET]


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    # the cases are small: eager loops of small tensor operations, which
    # run many times slower with every worker's intra-op threads competing
    tconfig.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(monkeypatch, row, params):
    """Calls the suite's function of ``row`` with the set ``params`` on the
    port and checks that every solver ``Problem.solve`` made is the set's
    own."""
    monkeypatch.setattr(suite, "ep", et)
    made = []

    def create_solver(problem, solver_params):
        solver = real(problem, solver_params)
        made.append(solver)
        return solver

    real = tsolve.create_solver
    monkeypatch.setattr(tsolve, "create_solver", create_solver)
    test, *args = ROW_TESTS[row]
    getattr(suite, test)(*args, dict(PARAMS[params]))
    assert made, f"{row}: Problem.solve made no solver"
    kinds = {type(s).__name__ for s in made}
    assert kinds == {SOLVER_CLASS[params].__name__}, f"{row} under {params}: {kinds}"
