"""The rest of the port's one-device solver surface against the JAX
package, f64 on the CPU: over-relaxation (same series at alpha 1.5 and
1.8), ``update_problem`` and Parameter re-solves (with a Parameter on the
constraint side held to a *fresh* solve), stop callbacks, the two ``drive``
values, and ``eval_prox`` per kind (values within 1e-8)."""

import numpy as np
import pytest

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu.frontend import api as japi
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.compiler import compiler as tcompiler
from epsilon_tpu_torch.frontend import api as tapi
from epsilon_tpu_torch.frontend.solve import _PROBLEM_CACHE
from epsilon_tpu_torch.solvers import (ProxADMMSolver, ProxADMMTwoBlockSolver,
                                       SolverParams as TParams)
from epsilon_tpu_torch.solvers import create_solver as tcreate

import torch_solver_cases as cases

TIGHT = dict(rel_tol=1e-6, abs_tol=1e-9, max_iterations=20000)
SOLVERS = ["prox_admm_two_block", "prox_admm"]


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


# -- over-relaxation ---------------------------------------------------------

@pytest.mark.parametrize("alpha", [1.5, 1.8])
@pytest.mark.parametrize("name", ["lasso", "nnls", "eqls"])
def test_over_relaxation_matches_jax(name, alpha):
    jprob, tprob = cases.pair(name)
    kw = dict(TIGHT, over_relaxation=alpha)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    xj, xt = js.solve(), ts.solve()
    assert ts.status.state.value == "optimal"
    cases.assert_same_solve(js, ts, xj, xt)


def test_over_relaxation_takes_fewer_iterations():
    _, tprob = cases.pair("lasso", seed=4, m=25, n=12, lam=0.4)
    plain = tcreate(tprob, TParams(**TIGHT))
    relaxed = tcreate(tprob, TParams(**dict(TIGHT, over_relaxation=1.7)))
    x0, x1 = plain.solve(), relaxed.solve()
    assert relaxed.status.num_iterations < plain.status.num_iterations
    np.testing.assert_allclose(x1["x"].numpy(), x0["x"].numpy(), atol=1e-4)


# -- update_problem ----------------------------------------------------------

def _compiled_lasso(A, b, lam):
    x = et.Variable(A.shape[1], name="var:x")
    prob = et.Problem(et.Minimize(
        0.5 * et.sum_squares(et._wrap(A) * x - b) + lam * et.norm1(x)))
    return tcompiler.compile_problem(prob.expression_problem())


def _assert_close(x, y, atol):
    assert set(x.keys()) == set(y.keys())
    for k in x.keys():
        np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), atol=atol)


def _max_diff(x, y):
    return max(float((x[k] - y[k]).abs().max()) for k in x.keys())


@pytest.mark.parametrize("cls", [ProxADMMTwoBlockSolver, ProxADMMSolver])
def test_update_problem_serves_new_data(cls):
    rng = np.random.RandomState(0)
    A, b1, b2, lam = rng.randn(20, 8), rng.randn(20), rng.randn(20), 0.3
    params = TParams(rel_tol=1e-6, abs_tol=1e-9)
    solver = cls(_compiled_lasso(A, b1, lam), params)
    x1 = solver.solve()
    ops_before = list(solver.term_ops)
    solver.update_problem(_compiled_lasso(A, b2, lam))
    x2 = solver.solve()
    # the term whose data changed was rebuilt, the others were kept
    changed = [a is not b for a, b in zip(ops_before, solver.term_ops)]
    assert any(changed) and not all(changed)
    x2_fresh = cls(_compiled_lasso(A, b2, lam), params).solve()
    _assert_close(x2, x2_fresh, 1e-6)
    assert _max_diff(x1, x2) > 1e-3


def test_sparse_kkt_update_problem():
    """A sparse difference operator in the constraint system."""
    import scipy.sparse as sp
    rng = np.random.RandomState(1)
    n = 12
    D = sp.diags([np.ones(n - 1), -np.ones(n - 1)], [0, 1],
                 shape=(n - 1, n)).tocsr()

    def make(y):
        x = et.Variable(n, name="var:x")
        prob = et.Problem(et.Minimize(
            0.5 * et.sum_squares(x - y) + 0.7 * et.norm1(et._wrap(D) * x)))
        return tcompiler.compile_problem(prob.expression_problem())

    y1, y2 = np.cumsum(rng.randn(n)), np.cumsum(rng.randn(n))
    params = TParams(rel_tol=1e-7, abs_tol=1e-10)
    solver = ProxADMMTwoBlockSolver(make(y1), params)
    x1 = solver.solve()
    constr_prox = solver.constr_prox
    solver.update_problem(make(y2))
    x2 = solver.solve()
    assert solver.constr_prox is constr_prox   # the constraints did not change
    _assert_close(x2, ProxADMMTwoBlockSolver(make(y2), params).solve(), 1e-6)
    assert _max_diff(x1, x2) > 1e-3


@pytest.mark.parametrize("solver", SOLVERS)
def test_parameter_resolve_through_frontend_matches_jax(solver):
    """A Parameter change with warm_start re-solves on the cached solver,
    with the JAX package's numbers."""
    rng = np.random.RandomState(2)
    m, n = 15, 6
    A, b1, b2 = rng.randn(m, n), rng.randn(m), rng.randn(m)
    probs = []
    for ep in (ej, et):
        bp = ep.Parameter(m, value=b1)
        x = ep.Variable(n)
        probs.append((bp, x, ep.Problem(ep.Minimize(
            0.5 * ep.sum_squares(ep._wrap(A) * x - bp) + 0.2 * ep.norm1(x)))))
    (bj, xj, pj), (bt, xt, pt) = probs
    # the N-block primal residual here is zero up to roundoff (1e-16)
    kw = dict(rel_tol=1e-6, abs_tol=1e-9, warm_start=True, solver=solver,
              series_atol=1e-13)
    cases.assert_same_problem_solve(pj, pt, japi, tapi, **kw)
    x1 = xt.value.copy()
    cached = _PROBLEM_CACHE[pt][1]
    bj.value, bt.value = b2, b2
    cases.assert_same_problem_solve(pj, pt, japi, tapi, **kw)
    assert _PROBLEM_CACHE[pt][1] is cached
    assert np.max(np.abs(x1 - xt.value)) > 1e-4
    xf = et.Variable(n)
    fresh = et.Problem(et.Minimize(
        0.5 * et.sum_squares(et._wrap(A) * xf - b2) + 0.2 * et.norm1(xf)))
    fresh.solve(rel_tol=1e-6, abs_tol=1e-9, solver=solver)
    np.testing.assert_allclose(xt.value.ravel(), xf.value.ravel(), atol=1e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_constraint_side_parameter_matches_fresh_solve(solver):
    """``C x == d`` with d a Parameter: the cached solver rebuilds what
    holds the constraint data, so the re-solve is the fresh solve's answer
    (the JAX package keeps the first problem's constraint data there)."""
    rng = np.random.RandomState(3)
    m, n, p = 20, 10, 3
    A, b, C = rng.randn(m, n), rng.randn(m), rng.randn(p, n)
    d1, d2 = rng.randn(p), rng.randn(p)
    kw = dict(rel_tol=1e-7, abs_tol=1e-10, max_iterations=20000, solver=solver)

    def make(d):
        x = et.Variable(n)
        return x, et.Problem(et.Minimize(et.sum_squares(et._wrap(A) * x - b)),
                             [et._wrap(C) * x == d])

    dp = et.Parameter(p, value=d1)
    x, prob = make(dp)
    prob.solve(warm_start=True, **kw)
    np.testing.assert_allclose(C @ x.value.ravel(), d1, atol=1e-5)
    cached = _PROBLEM_CACHE[prob][1]
    dp.value = d2
    prob.solve(warm_start=True, **kw)
    assert prob.status == "optimal" and _PROBLEM_CACHE[prob][1] is cached
    xf, fresh = make(d2)
    fresh.solve(**kw)
    np.testing.assert_allclose(C @ x.value.ravel(), d2, atol=1e-5)
    np.testing.assert_allclose(x.value, xf.value, atol=1e-5)
    K = np.block([[2 * A.T @ A, C.T], [C, np.zeros((p, p))]])
    want = np.linalg.solve(K, np.concatenate([2 * A.T @ b, d2]))[:n]
    np.testing.assert_allclose(x.value.ravel(), want, atol=1e-4)


@pytest.mark.parametrize("cls", [ProxADMMTwoBlockSolver, ProxADMMSolver])
def test_update_problem_with_new_constraint_data(cls):
    """The same at the solver's level, on the hand-built problem."""
    rng = np.random.RandomState(9)
    d1, d2 = rng.randn(3), rng.randn(3)
    p1 = interop.prox_problem_from_numpy(cases.equality_constrained_ls(d=d1))
    p2 = interop.prox_problem_from_numpy(cases.equality_constrained_ls(d=d2))
    params = TParams(rel_tol=1e-7, abs_tol=1e-10, max_iterations=20000,
                     warm_start=True)
    solver = cls(p1, params)
    x1 = solver.solve()
    solver.update_problem(p2)
    x2 = solver.solve()
    _assert_close(x2, cls(p2, params).solve(), 1e-6)
    assert _max_diff(x1, x2) > 1e-3


# -- stop callbacks and drive ------------------------------------------------

def _fires_after(k):
    calls = []

    def cb():
        calls.append(1)
        return len(calls) >= k
    return cb, calls


@pytest.mark.parametrize("solver", SOLVERS)
def test_stop_callback_host_drive_matches_jax(solver):
    jprob, tprob = cases.pair("lasso")
    kw = dict(TIGHT, drive="host", solver=solver)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    (cbj, _), (cbt, calls) = _fires_after(3), _fires_after(3)
    js.register_stop_callback(cbj)
    ts.register_stop_callback(cbt)
    xj, xt = js.solve(), ts.solve()
    assert ts.status.num_iterations == 30 and len(calls) == 3
    assert ts.status.state.value == "max_iterations_reached"
    cases.assert_same_solve(js, ts, xj, xt)


@pytest.mark.parametrize("solver", SOLVERS)
def test_stop_callback_ignored_under_device_drive(solver):
    _, tprob = cases.pair("lasso")
    ts = tcreate(tprob, TParams(**dict(TIGHT, drive="device", solver=solver)))
    cb, calls = _fires_after(1)
    ts.register_stop_callback(cb)
    ts.solve()
    assert ts.status.state.value == "optimal" and not calls


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("max_iterations", [25, 40])
def test_drive_budgets_match_jax(solver, max_iterations):
    """``device`` stops at the budget's multiple of the epoch length,
    ``host`` at the first epoch end at or past the budget, as in the JAX
    package; the series are identical as far as both go."""
    jprob, tprob = cases.pair("lasso")
    got = {}
    for drive in ("device", "host"):
        kw = dict(TIGHT, drive=drive, solver=solver, max_iterations=max_iterations)
        js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
        xj, xt = js.solve(), ts.solve()
        cases.assert_same_solve(js, ts, xj, xt)
        got[drive] = ts.status
    assert got["device"].num_iterations == (max_iterations // 10) * 10
    assert got["host"].num_iterations == -(-max_iterations // 10) * 10
    n = len(got["device"].series)
    cases.assert_series_close(got["host"].series[:n], got["device"].series, 1e-12)


def test_drive_value_is_checked():
    with pytest.raises(ValueError, match="drive"):
        TParams(drive="tpu")


def test_verbose_logs_progress(caplog):
    import logging
    _, tprob = cases.pair("lasso")
    with caplog.at_level(logging.INFO, logger="epsilon_tpu_torch"):
        tcreate(tprob, TParams(**dict(TIGHT, verbose=True, log_iterations=10))).solve()
    assert any("iter" in r.getMessage().lower() for r in caplog.records)


# -- eval_prox ---------------------------------------------------------------

N = 6


def _sym(rng, n):
    V = rng.randn(n, n)
    return 0.5 * (V + V.T)


# name -> (shape, build(ep, x), kind, make_v(rng), lam)
EVAL_PROX = {
    "norm1": ((N,), lambda ep, x: ep.norm1(x), "NORM_1", None, 0.7),
    "norm1_weighted": ((N,), lambda ep, x: ep.norm1(ep.mul_elemwise(
        (np.arange(N) / N + 0.5).reshape(-1, 1), x)), "NORM_1", None, 0.7),
    "hinge": ((N,), lambda ep, x: ep.sum_entries(ep.max_elemwise(x, 0)),
              "SUM_HINGE", None, 1.3),
    "deadzone": ((N,), lambda ep, x: ep.sum_entries(ep.max_elemwise(ep.abs(x) - 0.5, 0)),
                 "SUM_DEADZONE", None, 0.9),
    "sum_square": ((N,), lambda ep, x: ep.sum_squares(x), "SUM_SQUARE", None, 0.4),
    "sum_square_affine": ((N,), lambda ep, x: ep.sum_squares(
        ep._wrap(np.random.RandomState(1).randn(8, N)) * x
        - np.random.RandomState(2).randn(8)), "SUM_SQUARE", None, 0.8),
    "norm2": ((N,), lambda ep, x: ep.norm2(x), "NORM_2", None, 0.6),
    "max": ((N,), lambda ep, x: ep.max_entries(x), "MAX", None, 1.1),
    "sum_largest": ((N,), lambda ep, x: ep.sum_largest(x, 3), "SUM_LARGEST", None, 0.5),
    "log_sum_exp": ((N,), lambda ep, x: ep.log_sum_exp(x), "LOG_SUM_EXP", None, 2.0),
    "sum_exp": ((N,), lambda ep, x: ep.sum_entries(ep.exp(x)), "SUM_EXP", None, 0.3),
    "sum_logistic": ((N,), lambda ep, x: ep.sum_entries(ep.logistic(x)),
                     "SUM_LOGISTIC", None, 1.7),
    "sum_neg_log": ((N,), lambda ep, x: ep.sum_entries(-ep.log(x)), "SUM_NEG_LOG", None, 0.6),
    "sum_neg_entr": ((N,), lambda ep, x: ep.sum_entries(-ep.entr(x)),
                     "SUM_NEG_ENTR", None, 0.8),
    "sum_inv_pos": ((N,), lambda ep, x: ep.sum_entries(ep.power(x, -1)), "SUM_INV_POS",
                    lambda rng: np.abs(rng.randn(N)) + 0.5, 0.5),
    "total_variation_1d": ((30,), lambda ep, x: ep.tv(x), "TOTAL_VARIATION_1D",
                           lambda rng: np.cumsum(rng.randn(30)), 0.8),
    "neg_log_det": ((4, 4), lambda ep, x: -ep.log_det(x), "NEG_LOG_DET",
                    lambda rng: _sym(rng, 4), 0.5),
    "norm_nuclear": ((5, 4), lambda ep, x: ep.norm_nuc(x), "NORM_NUCLEAR",
                     lambda rng: rng.randn(5, 4), 0.6),
    "lambda_max": ((4, 4), lambda ep, x: ep.lambda_max(x), "LAMBDA_MAX",
                   lambda rng: _sym(rng, 4), 0.7),
}
EVAL_PROX_EPI = {
    "epi_norm1": (lambda ep, x, t: ep.norm1(x) <= t, "NORM_1"),
    "epi_max": (lambda ep, x, t: ep.max_entries(x) <= t, "MAX"),
    "epi_sum_square": (lambda ep, x, t: ep.sum_squares(x) <= t, "SUM_SQUARE"),
    "epi_log_sum_exp": (lambda ep, x, t: ep.log_sum_exp(x) <= t, "LOG_SUM_EXP"),
}


@pytest.mark.parametrize("name", list(EVAL_PROX) + list(EVAL_PROX_EPI))
def test_eval_prox_matches_jax(name):
    rng = np.random.RandomState(100)
    values = []
    for ep in (ej, et):
        if name in EVAL_PROX:
            shape, build, kind, make_v, lam = EVAL_PROX[name]
            v = make_v(np.random.RandomState(7)) if make_v else \
                np.random.RandomState(7).randn(*shape)
            x = ep.Variable(*shape)
            out = ep.eval_prox(build(ep, x), {x: v}, lam=lam,
                               expected_kind=getattr(ep.ProxKind, kind))
            values.append([x.value])
        else:
            build, kind = EVAL_PROX_EPI[name]
            r = np.random.RandomState(7)
            v, s = r.randn(N) * 2, r.randn()
            x, t = ep.Variable(N), ep.Variable(1)
            out = ep.eval_prox(build(ep, x, t), {x: v, t: np.array([s])}, lam=1.0,
                               expected_kind=getattr(ep.ProxKind, kind), epigraph=True)
            values.append([x.value, t.value])
        assert all(isinstance(a, np.ndarray) for a in out.values())
    for a, b in zip(*values):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-8)


def test_eval_prox_tv_against_exact():
    from epsilon_tpu_torch.ops.prox.tv1d import tv1d_exact_numpy
    v = np.cumsum(np.random.RandomState(3).randn(30))
    x = et.Variable(30)
    et.eval_prox(et.tv(x), {x: v}, lam=0.8,
                 expected_kind=et.ProxKind.TOTAL_VARIATION_1D)
    np.testing.assert_allclose(x.value.ravel(), tv1d_exact_numpy(v, 0.8), atol=5e-4)


def test_eval_prox_rejects_what_is_no_single_prox():
    x = et.Variable(N)
    with pytest.raises(ValueError, match="expected"):
        et.eval_prox(et.norm1(x), {x: np.zeros(N)}, lam=1.0,
                     expected_kind=et.ProxKind.NORM_2)
    with pytest.raises(ValueError, match="expected"):
        et.eval_prox(et.norm1(x), {x: np.zeros(N)}, lam=1.0,
                     expected_kind=et.ProxKind.NORM_1, epigraph=True)
    y = et.Variable(N)
    with pytest.raises(ValueError, match="single term"):
        et.eval_prox(et.norm1(x) + et.norm2(y), {x: np.zeros(N)})


def test_eval_prox_resets_the_inner_tolerance():
    tconfig.set_prox_inner_tol(0.1)
    x = et.Variable(N)
    et.eval_prox(et.norm1(x), {x: np.ones(N)})
    assert tconfig.prox_inner_tol() is None
