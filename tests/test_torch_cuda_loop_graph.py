"""The ADMM epoch replayed as a CUDA graph (``solvers/epoch_graph.py``) on
the card: lasso paths through ``Problem.solve`` against the same paths with
every epoch issued eagerly (``graph_capturable`` patched to False), the
same iteration count at every lambda and bitwise the same x; one capture a
solve whose operators were rebuilt; what a solve returned left alone by
the next; and device memory that does not grow over a path.  They skip
without a CUDA device; this file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_loop_graph.py
"""

import collections
import gc
import importlib

import numpy as np
import pytest
import torch

import epsilon_tpu_torch as et
from epsilon_tpu_torch import config
from epsilon_tpu_torch.solvers import admm, epoch_graph
from epsilon_tpu_torch.solvers.admm import ProxADMMTwoBlockSolver

pytestmark = pytest.mark.cuda

# the benchmark's lasso cell: 3e-4, abs_tol 1e-7
SOLVE = dict(warm_start=True, rel_tol=3e-4, abs_tol=1e-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config.set_device("cuda")
    yield
    config.set_device("cpu")


def _data(m, n, seed=3):
    """The upstream generator's recipe: A of unit-norm columns, x0 sparse,
    b = A x0 + 0.05 noise."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    A /= np.sqrt((A ** 2).sum(axis=0))
    x0 = np.zeros(n)
    x0[rng.choice(n, size=max(1, round(0.01 * n)), replace=False)] = rng.standard_normal(
        max(1, round(0.01 * n)))
    return A, A @ x0 + 0.05 * np.random.default_rng(seed + 1).standard_normal(m)


def _path(A, b, count):
    return 2 * np.abs(A.T @ b).max() * np.exp(np.linspace(0.0, np.log(0.01), count))


def _problem(A, b, lam):
    x = et.Variable(A.shape[1])
    p = et.Parameter(1, 1, value=np.array([[lam]]))
    return et.Problem(et.Minimize(et.sum_squares(A * x - b) + p * et.norm1(x))), x, p


def _walk(A, b, lams, **kw):
    prob, x, p = _problem(A, b, lams[0])
    xs, iters = [], []
    for lam in lams:
        p.value = np.array([[lam]])
        prob.solve(**SOLVE, **kw)
        xs.append(np.array(x.value))
        iters.append(prob.solver_status.num_iterations)
    return xs, iters, prob


# adaptive rho at the small size alone: its set-up is a host eigh of n x n
@pytest.mark.parametrize("m,n,adaptive", [(150, 500, False), (1500, 5000, False),
                                          (150, 500, True)])
def test_graphed_path_is_the_eager_path_bitwise(cuda, monkeypatch, m, n, adaptive):
    A, b = _data(m, n)
    lams = _path(A, b, 20)
    # the program's counters, taken as the loop counts them: a profiler
    # opened here would leave later profiled windows in this process
    # without device events (tests/test_torch_cuda.py)
    counts = collections.Counter()

    def record(name, n=1):
        counts[name] += n

    with monkeypatch.context() as mp:
        mp.setattr(admm, "count", record)
        mp.setattr(epoch_graph, "count", record)
        graphed, g_iters, prob = _walk(A, b, lams, adaptive_rho=adaptive)
    assert _solver_of(prob)._graph.graph is not None
    with monkeypatch.context() as mp:
        mp.setattr(ProxADMMTwoBlockSolver, "graph_capturable", lambda self: False)
        eager, e_iters, _ = _walk(A, b, lams, adaptive_rho=adaptive)
    assert g_iters == e_iters
    for got, want in zip(graphed, eager):
        assert np.array_equal(got, want)
    # the cold solve's first epoch eager, every other epoch replayed
    assert counts["admm.graph_epochs"] == counts["admm.epochs"] - 1
    # a capture in the cold solve, and one in each warm step, whose lam
    # rebuilt the norm's operator
    assert g_iters[0] > 10 and counts["update.rebuilt_terms"] == len(lams) - 1
    assert counts["admm.graph_captures"] == 1 + counts["update.rebuilt_terms"]


def _solver_of(prob):
    return importlib.import_module("epsilon_tpu_torch.frontend.solve")._PROBLEM_CACHE[prob][1]


def test_a_solve_keeps_what_it_returned(cuda):
    A, b = _data(150, 500)
    lams = _path(A, b, 3)
    prob, x, p = _problem(A, b, lams[1])
    prob.solve(**SOLVE)
    solver = _solver_of(prob)
    captures = solver._graph.graph
    returned = solver.solve()            # the same lam again: replays alone
    assert solver._graph.graph is captures
    kept = {k: v.clone() for k, v in returned.items()}
    value, held = np.array(x.value), x.value
    p.value = np.array([[lams[2]]])
    prob.solve(**SOLVE)
    assert not np.array_equal(np.array(x.value), value)
    # neither what a solve returned nor a variable's earlier value moved
    assert all(torch.equal(returned[k], v) for k, v in kept.items())
    assert np.array_equal(held, value)


def test_old_graphs_are_released_over_a_path(cuda):
    # what earlier tests left in reference cycles goes first; then no
    # collection runs, so the readings also count what the path's own steps
    # leave in cycles
    gc.collect()
    gc.disable()
    try:
        A, b = _data(150, 500)
        lams = _path(A, b, 10)
        prob, _, p = _problem(A, b, lams[0])
        prob.solve(**SOLVE)
        allocated = []
        for step in range(100):
            # each step a new lam: the norm's operator is rebuilt, the epoch
            # captured anew
            p.value = np.array([[lams[1 + step % 9] * (1.0 + 1e-3 * step)]])
            prob.solve(**SOLVE)
            if step in (9, 99):
                torch.cuda.synchronize()
                allocated.append(torch.cuda.memory_allocated())
    finally:
        gc.enable()
    assert abs(allocated[1] - allocated[0]) <= 2 ** 20
