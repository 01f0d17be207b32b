"""The port's N-block Gauss-Seidel solver against the JAX package's, f64
on the CPU, from the same compiled problem: the same iteration count,
residual series (rtol 1e-6), iterates (atol 1e-8) and objective (rtol
1e-9), for any fixed rho, across a rho rebuild with warm state, and from a
state carried over with ``interop``."""

import numpy as np
import pytest

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu.frontend import api as japi
from epsilon_tpu.solvers import ProxADMMSolver as JNBlock
from epsilon_tpu.solvers import ProxADMMTwoBlockSolver as JTwoBlock
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.frontend import api as tapi
from epsilon_tpu_torch.solvers import ProxADMMSolver as TNBlock
from epsilon_tpu_torch.solvers import ProxADMMTwoBlockSolver as TTwoBlock
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate

import torch_library_rows as rows
import torch_solver_cases as cases

TIGHT = dict(rel_tol=1e-5, abs_tol=1e-7, max_iterations=8000,
             solver="prox_admm")


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


@pytest.mark.parametrize("drive", ["device", "host"])
@pytest.mark.parametrize("rho", [0.25, 1.0, 4.0])
@pytest.mark.parametrize("name", ["lasso", "nnls", "eqls"])
def test_nblock_matches_jax(name, rho, drive):
    jprob, tprob = cases.pair(name)
    kw = dict(TIGHT, rho=rho, drive=drive)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    assert isinstance(js, JNBlock) and isinstance(ts, TNBlock)
    xj, xt = js.solve(), ts.solve()
    assert ts.status.state.value == "optimal"
    cases.assert_same_solve(js, ts, xj, xt)


def test_nblock_state_is_padded_to_all_rows():
    """Every y spans the full constraint row space, whichever rows its term
    touches, and b sits on the device once."""
    _, tprob = cases.pair("lasso")
    ts = TNBlock(tprob, TParams(**dict(TIGHT, warm_start=True, max_iterations=10)))
    ts.solve()
    u, ys = ts._warm_state
    assert len(ys) == len(tprob.terms)
    for y in ys:
        assert set(y.keys()) == set(ts.row_dims) == set(u.keys())
    assert ts.b.to_device() is ts.b.to_device()


@pytest.mark.parametrize("rho2", [4.0, 0.25])
def test_nblock_rho_rebuild_with_warm_state_matches_jax(rho2):
    jprob, tprob = cases.pair("lasso", seed=5, m=20, n=10, lam=0.4)
    kw = dict(TIGHT, warm_start=True)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    cases.assert_same_solve(js, ts, js.solve(), ts.solve())
    cold = ts.status.num_iterations
    js.params, ts.params = JParams(**dict(kw, rho=rho2)), TParams(**dict(kw, rho=rho2))
    cases.assert_same_solve(js, ts, js.solve(), ts.solve())
    assert ts._init_rho == rho2 and ts.sqrt_rho == np.sqrt(rho2)
    assert ts.status.num_iterations < cold     # the warm state survived


def test_nblock_warm_state_from_jax():
    jprob, tprob = cases.pair("nnls")
    early = dict(TIGHT, warm_start=True, max_iterations=20, rho=2.0)
    js = jcreate(jprob, JParams(**early))
    js.solve()
    u, ys = js._warm_state
    ts = tcreate(tprob, TParams(**dict(early, max_iterations=8000)))
    ts._warm_state = interop.nblock_state_from_numpy(
        {k: np.asarray(v) for k, v in u.items()},
        [{k: np.asarray(v) for k, v in y.items()} for y in ys])
    js.params = JParams(**dict(early, max_iterations=8000))
    cases.assert_same_solve(js, ts, js.solve(), ts.solve())


@pytest.mark.parametrize("kwargs, cls", [
    (dict(solver="prox_admm"), "ProxADMMSolver"),
    (dict(solver="prox_admm", adaptive_rho=True), "ProxADMMTwoBlockSolver"),
    (dict(solver="prox_admm_two_block"), "ProxADMMTwoBlockSolver"),
    (dict(), "ProxADMMTwoBlockSolver"),
    (dict(adaptive_rho=True), "ProxADMMTwoBlockSolver"),
])
def test_create_solver_routing_matches_jax(kwargs, cls):
    jprob, tprob = cases.pair("lasso")
    js, ts = jcreate(jprob, JParams(**kwargs)), tcreate(tprob, TParams(**kwargs))
    assert type(ts).__name__ == type(js).__name__ == cls


def test_nblock_rejects_adaptive_rho():
    jprob, tprob = cases.pair("lasso")
    for cls, prob, params in ((JNBlock, jprob, JParams), (TNBlock, tprob, TParams)):
        with pytest.raises(ValueError, match="adaptive_rho"):
            cls(prob, params(adaptive_rho=True))


def test_solvers_reject_other_cones():
    from epsilon_tpu_torch.ir import Cone
    _, tprob = cases.pair("lasso")
    tprob.constraints[0].cone = Cone.NON_NEGATIVE
    with pytest.raises(ValueError, match="ZERO cones only"):
        TNBlock(tprob, TParams())
    with pytest.raises(ValueError, match="ZERO cones only"):
        TTwoBlock(tprob, TParams())


@pytest.mark.parametrize("name", ["lasso", "least_abs_dev", "qp", "tv_1d",
                                  "basis_pursuit", "huber"])
def test_nblock_library_row_matches_jax(name, monkeypatch):
    """Library rows through ``Problem.solve(solver="prox_admm")``."""
    pj, pt = rows.build(name, monkeypatch)
    cases.assert_same_problem_solve(
        pj, pt, japi, tapi, solver="prox_admm", max_iterations=3000, **rows.SOLVE)
    assert pt.status == "optimal"


def test_nblock_through_frontend_agrees_with_two_block():
    rng = np.random.RandomState(5)
    A, b = rng.randn(20, 10), rng.randn(20)
    objs = []
    for solver in ("prox_admm", "prox_admm_two_block"):
        x = et.Variable(10)
        prob = et.Problem(et.Minimize(
            0.5 * et.sum_squares(et._wrap(A) * x - b) + 0.4 * et.norm1(x)))
        objs.append(prob.solve(solver=solver, rel_tol=1e-6, abs_tol=1e-8))
        assert prob.status == "optimal"
    np.testing.assert_allclose(objs[0], objs[1], rtol=1e-4)
