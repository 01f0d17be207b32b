"""Which ADMM loops a card replays as a CUDA graph of the epoch
(``solvers/epoch_graph.py``), decided on the CPU from the operators alone:
the lasso's (the sum of squares' and the constraint's KKT solves by the
explicit inverse, the l1 norm's elementwise prox) are capturable, in both
rho modes; TV-1D (K7's launch and warm dual), the graphical lasso (eigh,
which checks its info on the host), a meshed solver and the N-block solver
are not.  On the CPU every epoch runs eagerly, and the loop counts its
epochs (``admm.epochs``) and none replayed."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import epsilon_tpu_torch as et
from epsilon_tpu_torch import compiler, config
from epsilon_tpu_torch.solvers import SolverParams
from epsilon_tpu_torch.solvers.admm import ProxADMMSolver, ProxADMMTwoBlockSolver
from epsilon_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    config.set_device("cpu")
    # the card's solve mode: every cached factor applies as its explicit inverse
    monkeypatch.setattr(config, "FACTOR_SOLVE_MODE", "inverse")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.reset_counters()
    yield
    timing.reset_counters()
    torch.set_num_threads(prev)


def _lasso(m=60, n=200, seed=0):
    rng = np.random.default_rng(seed)
    A, b = rng.standard_normal((m, n)), rng.standard_normal(m)
    x = et.Variable(n)
    lam = et.Parameter(1, 1, value=np.array([[0.1 * np.abs(A.T @ b).max()]]))
    return et.Problem(et.Minimize(et.sum_squares(A * x - b) + lam * et.norm1(x)))


def _tv(n=60, seed=0):
    b = np.random.default_rng(seed).standard_normal(n)
    x = et.Variable(n)
    return et.Problem(et.Minimize(0.5 * et.sum_squares(x - b) + 2.0 * et.tv(x)))


def _covsel(p=8, seed=1):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((p, 2 * p))
    S = F @ F.T / (2 * p)
    theta = et.Variable(p, p)
    return et.Problem(et.Minimize(et.sum_entries(et.mul_elemwise(S, theta))
                                  - et.log_det(theta) + 0.1 * et.norm1(theta)))


def _solver(prob, cls=ProxADMMTwoBlockSolver, **params):
    prox = compiler.compile_problem(prob.expression_problem(), use_epigraph=True)
    return cls(prox, SolverParams(**params))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_rho", "adaptive_rho"])
def test_the_lasso_is_capturable(adaptive):
    solver = _solver(_lasso(), adaptive_rho=adaptive)
    kinds = sorted(t.spec.kind.value for t in solver.problem.terms)
    assert kinds == ["norm_1", "sum_square"]
    assert all(op.capturable() for op in solver.term_ops)
    assert solver.constr_prox.capturable()
    assert solver.graph_capturable()
    # on the CPU the epoch runs eagerly all the same
    assert solver._graph_key() is None


def test_the_lasso_by_triangular_solves_is_not(monkeypatch):
    """A factor applied by its triangular solves is not counted capturable;
    the explicit inverse (the card's mode) is."""
    monkeypatch.setattr(config, "FACTOR_SOLVE_MODE", "triangular")
    solver = _solver(_lasso(m=150, n=5000))
    assert not solver.graph_capturable()


def test_a_packed_factor_is_not_and_is_asked_anew(monkeypatch):
    """A factor that K2 applies (``apply_mode`` "packed") is not capturable,
    and the predicate asks the factors at each call: constants changed
    between two solves decide whether the second replays."""
    solver = _solver(_lasso())
    assert solver.graph_capturable()
    monkeypatch.setattr(config, "SYM_PACKED_MIN_DIM", 1)
    assert not solver.graph_capturable()
    monkeypatch.setattr(config, "SYM_PACKED_MIN_DIM", 8192)
    assert solver.graph_capturable()


@pytest.mark.parametrize("build,kind", [(_tv, "total_variation_1d"), (_covsel, "neg_log_det")])
def test_tv_and_the_graphical_lasso_are_not_capturable(build, kind):
    solver = _solver(build())
    ops = {t.spec.kind.value: op for t, op in zip(solver.problem.terms, solver.term_ops)}
    assert not ops[kind].capturable()
    assert not solver.graph_capturable()


def test_the_n_block_solver_runs_its_epochs_eagerly():
    solver = _solver(_lasso(), cls=ProxADMMSolver)
    assert solver._graph_key() is None


@pytest.fixture
def group(tmp_path):
    if dist.is_initialized():
        pytest.fail("a process group is already initialized in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_a_meshed_solver_is_not_capturable(group):
    solver = _solver(_lasso(), mesh=group)
    assert solver.mesh is group
    assert not solver.graph_capturable()


@pytest.mark.parametrize("solver_kind", ["prox_admm_two_block", "prox_admm"])
def test_the_loop_counts_its_epochs_and_replays_none(solver_kind):
    prob = _lasso()
    with profile(activities=[ProfilerActivity.CPU]):
        prob.solve(rel_tol=1e-3, solver=solver_kind)
    iters = prob.solver_status.num_iterations
    assert iters >= 20
    counts = timing.counters()
    assert counts["admm.epochs"] == iters // 10
    assert "admm.graph_epochs" not in counts and "admm.graph_captures" not in counts
