"""The port's slice end to end against the JAX package: lasso through
``Problem.solve`` and through the two-block solver alone on the identical
compiled problem (carried across with ``interop``), on the collapsed KKT
path and on the sym_packed (K2) path.

Tolerances: per-epoch residual series rtol 1e-6, iterates atol 1e-8,
objective rtol 1e-9, and the same iteration count.  Both sides run in f64
on the CPU; they differ only in the order of floating-point sums."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu import config as jconfig
from epsilon_tpu.compiler import compiler as jcompiler
from epsilon_tpu.ops.prox import operator as jop
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.ops.kernels import sym_packed as sp
from epsilon_tpu_torch.ops.prox import operator as top
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate

SETTINGS = dict(rel_tol=1e-3, abs_tol=1e-6, rho=1.0)


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def workload(m, n, seed=0):
    """bench.py's flagship generator at a small size."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n) * (rng.rand(n) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()
    return A, b, lam


def lasso(ep, A, b, lam):
    x = ep.Variable(A.shape[1])
    return x, ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))


def assert_series_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.r_norm, g.s_norm, g.epsilon_primal, g.epsilon_dual],
                                   [w.r_norm, w.s_norm, w.epsilon_primal, w.epsilon_dual],
                                   rtol=1e-6)


@pytest.fixture(params=["collapsed", "sym_packed", "sym_packed_factored"])
def path(request, monkeypatch):
    """collapsed: the default CPU path (the SUM_SQUARE KKT folds into one
    dense solve).  sym_packed: explicit-inverse mode with the packed path
    from n = 64 on in both packages (the JAX package's forced on by its
    environment switch, the port's by its config constants alone), so the
    80-dimensional pivot applies through K2 (at set-up, when the KKT
    collapses).
    sym_packed_factored: the same with the collapse off, so K2 runs every
    iteration, as at n = 8192 on the card."""
    if request.param != "collapsed":
        for cfg in (jconfig, tconfig):
            monkeypatch.setattr(cfg, "FACTOR_SOLVE_MODE", "inverse")
            monkeypatch.setattr(cfg, "SYM_PACKED_MIN_DIM", 64)
        monkeypatch.setenv("EPSILON_TPU_SYM_PACKED", "1")   # the JAX package's
    if request.param == "sym_packed_factored":
        monkeypatch.setattr(jop, "_COLLAPSE_MAX_ENTRIES", 0.0)
        monkeypatch.setattr(top, "_COLLAPSE_MAX_ENTRIES", 0.0)
    calls = []
    real = sp.sym_packed_matmul_reference
    monkeypatch.setattr(sp, "sym_packed_matmul_reference",
                        lambda *a: calls.append(1) or real(*a))
    return request.param, calls


def _shape(name):
    return (200, 100) if name == "collapsed" else (96, 80)


def test_problem_solve_matches_jax(path):
    name, calls = path
    A, b, lam = workload(*_shape(name))
    xj, pj = lasso(ej, A, b, lam)
    xt, pt = lasso(et, A, b, lam)
    obj_j = pj.solve(**SETTINGS)
    obj_t = pt.solve(**SETTINGS)
    assert pt.status == pj.status == "optimal"
    assert pt.solver_status.num_iterations == pj.solver_status.num_iterations
    assert_series_close(pt.solver_status.series, pj.solver_status.series)
    np.testing.assert_allclose(xt.value, xj.value, rtol=0, atol=1e-8)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-9)
    n_iter = pt.solver_status.num_iterations
    if name == "collapsed":
        assert not calls
    elif name == "sym_packed":
        assert len(calls) == 2       # the collapse's basis and offset solves
    else:
        assert len(calls) >= n_iter


def test_solver_on_identical_problem_matches_jax(path):
    name, calls = path
    A, b, lam = workload(*_shape(name))
    _, pj = lasso(ej, A, b, lam)
    jprob = jcompiler.compile_problem(pj.expression_problem())
    tprob = interop.prox_problem_from_numpy(jprob)
    js, ts = jcreate(jprob, JParams(**SETTINGS)), tcreate(tprob, TParams(**SETTINGS))
    xj, xt = js.solve(), ts.solve()
    assert ts.status.state.value == js.status.state.value == "optimal"
    assert ts.status.num_iterations == js.status.num_iterations
    assert_series_close(ts.status.series, js.status.series)
    assert set(xt.keys()) == set(xj.keys())
    for k in xj.keys():
        np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(ts.objective_value(xt)),
                               float(js.objective_value(xj)), rtol=1e-9)
    if name != "collapsed":
        assert calls


def test_warm_state_from_jax_matches(path):
    """Both solvers resume from the JAX solver's state after 20 iterations."""
    name, _ = path
    A, b, lam = workload(*_shape(name))
    _, pj = lasso(ej, A, b, lam)
    jprob = jcompiler.compile_problem(pj.expression_problem())
    early = dict(SETTINGS, warm_start=True, max_iterations=20)
    js = jcreate(jprob, JParams(**early))
    js.solve()
    z, u = js._warm_state
    ts = tcreate(interop.prox_problem_from_numpy(jprob), TParams(**dict(early, max_iterations=10000)))
    ts._warm_state = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in z.items()}, {k: np.asarray(v) for k, v in u.items()})
    js.params = JParams(**dict(early, max_iterations=10000))
    xj, xt = js.solve(), ts.solve()
    assert ts.status.num_iterations == js.status.num_iterations
    assert_series_close(ts.status.series, js.status.series)
    for k in xj.keys():
        np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=0, atol=1e-8)


def test_warm_started_resolve_and_rho_change():
    A, b, lam = workload(60, 30)
    xj, pj = lasso(ej, A, b, lam)
    xt, pt = lasso(et, A, b, lam)
    for kwargs in (dict(SETTINGS, warm_start=True),
                   dict(SETTINGS, warm_start=True, rho=2.0),
                   dict(SETTINGS, warm_start=True, rel_tol=1e-5)):
        obj_j, obj_t = pj.solve(**kwargs), pt.solve(**kwargs)
        assert pt.solver_status.num_iterations == pj.solver_status.num_iterations
        np.testing.assert_allclose(xt.value, xj.value, rtol=0, atol=1e-8)
        np.testing.assert_allclose(obj_t, obj_j, rtol=1e-9)


def test_max_iterations_state_matches_jax():
    A, b, lam = workload(60, 30)
    xj, pj = lasso(ej, A, b, lam)
    xt, pt = lasso(et, A, b, lam)
    kwargs = dict(rel_tol=1e-9, abs_tol=1e-12, max_iterations=25)
    pj.solve(**kwargs)
    pt.solve(**kwargs)
    assert pt.status == pj.status == "max_iterations"
    assert pt.solver_status.num_iterations == pj.solver_status.num_iterations == 20
    np.testing.assert_allclose(xt.value, xj.value, rtol=0, atol=1e-8)


def test_single_prox_fast_path_matches_jax():
    rng = np.random.RandomState(4)
    A, b = rng.randn(30, 10), rng.randn(30)
    vals = []
    for ep in (ej, et):
        x = ep.Variable(10)
        obj = ep.Problem(ep.Minimize(ep.sum_squares(ep._wrap(A) * x - b))).solve()
        vals.append((obj, np.asarray(x.value)))
    np.testing.assert_allclose(vals[1][1], vals[0][1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(vals[1][0], vals[0][0], rtol=1e-9)
    np.testing.assert_allclose(vals[1][1].ravel(), np.linalg.lstsq(A, b, rcond=None)[0],
                               atol=1e-6)


def test_port_imports_no_jax():
    root = Path(et.__file__).resolve().parent
    for f in root.rglob("*.py"):
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f
    code = ("import sys, epsilon_tpu_torch, epsilon_tpu_torch.interop, "
            "epsilon_tpu_torch.problems.benchmark; "
            "assert 'jax' not in sys.modules and 'epsilon_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root.parent)
