"""Adaptive rho in the port against the JAX package, f64 on the CPU: each
rho-parameterized operator at three values of rho (atol 1e-10), and whole
adaptive solves from the same compiled problem with the same iteration
count, residual series (rtol 1e-6), iterates (atol 1e-8), objective (rtol
1e-9) and rho trajectory."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu.frontend import api as japi
from epsilon_tpu.ir import (AffineOperator, ProxFunctionSpec, ProxKind,
                            ProxProblem, ProxTerm, arg_key)
from epsilon_tpu.ops import linop as jlinop
from epsilon_tpu.ops.block import BlockMatrix, BlockVector
from epsilon_tpu.ops.prox import operator as jop
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.frontend import api as tapi
from epsilon_tpu_torch.ops.block import BlockVector as TBlockVector
from epsilon_tpu_torch.ops.prox import operator as top
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate

import torch_library_rows as rows
import torch_solver_cases as cases

TIGHT = dict(rel_tol=1e-5, abs_tol=1e-7, max_iterations=5000)


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


# -- operators ---------------------------------------------------------------

def _term(kind, rng):
    """(spec, affine argument, var_dims, expected wrapper class)."""
    n = 6
    ident = AffineOperator(
        BlockMatrix({(arg_key(0), "x"): jlinop.identity(n)}), BlockVector())
    if kind == "sum_square":
        H, g = rng.randn(8, n), rng.randn(8)
        return (ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, alpha=0.7),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.dense(H)}),
                               BlockVector({arg_key(0): jnp.asarray(g)})),
                {"x": n}, "RhoSumSquareProxOperator")
    if kind == "sum_square_two_vars":
        # H touches x only: y is a zero column of the dense H
        H, g = rng.randn(8, n), rng.randn(8)
        return (ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, alpha=0.3),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.dense(H)}),
                               BlockVector({arg_key(0): jnp.asarray(g)})),
                {"x": n, "y": 3}, "RhoSumSquareProxOperator")
    if kind == "affine":
        c = rng.randn(n)
        return (ProxFunctionSpec(kind=ProxKind.AFFINE, alpha=2.0),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.dense(c[None, :])}),
                               BlockVector()),
                {"x": n}, "RhoAffineProxOperator")
    if kind == "zero":
        return (ProxFunctionSpec(kind=ProxKind.ZERO),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.identity(n),
                                            (arg_key(0), "y"): jlinop.scalar(-1.0, n)}),
                               BlockVector()),
                {"x": n, "y": n}, "RhoProjectionOperator")
    if kind == "norm1":
        return (ProxFunctionSpec(kind=ProxKind.NORM_1, alpha=1.3), ident,
                {"x": n}, "VectorProxOperator")
    if kind == "norm1_offset":
        return (ProxFunctionSpec(kind=ProxKind.NORM_1, alpha=0.4),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.scalar(2.0, n)}),
                               BlockVector({arg_key(0): jnp.asarray(rng.randn(n))})),
                {"x": n}, "VectorProxOperator")
    if kind == "norm2":
        return (ProxFunctionSpec(kind=ProxKind.NORM_2, alpha=0.8), ident,
                {"x": n}, "VectorProxOperator")
    if kind == "tv":
        return (ProxFunctionSpec(kind=ProxKind.TOTAL_VARIATION_1D, alpha=0.6),
                ident, {"x": n}, "VectorProxOperator")
    if kind == "norm1_epigraph":
        return (ProxFunctionSpec(kind=ProxKind.NORM_1, epigraph=True,
                                 arg_sizes=[(n, 1), (1, 1)]),
                AffineOperator(BlockMatrix({(arg_key(0), "x"): jlinop.identity(n),
                                            (arg_key(1), "t"): jlinop.identity(1)}),
                               BlockVector()),
                {"x": n, "t": 1}, "RhoProjectionOperator")
    raise KeyError(kind)


OPERATOR_KINDS = ["sum_square", "sum_square_two_vars", "affine", "zero",
                  "norm1", "norm1_offset", "norm2", "tv", "norm1_epigraph"]


@pytest.mark.parametrize("rho", [0.25, 1.0, 7.5])
@pytest.mark.parametrize("kind", OPERATOR_KINDS)
def test_rho_operator_matches_jax(kind, rho):
    rng = np.random.RandomState(1)
    spec, aff, var_dims, cls = _term(kind, rng)
    jo = jop.create_rho_prox_operator(spec, aff, var_dims)
    tprob = interop.prox_problem_from_numpy(ProxProblem(
        terms=[ProxTerm(spec, aff)], constraints=[], var_dims=var_dims,
        var_shapes={k: (n, 1) for k, n in var_dims.items()}))
    to = top.create_rho_prox_operator(tprob.terms[0].spec, tprob.terms[0].H,
                                      var_dims)
    assert type(to).__name__ == type(jo).__name__ == cls
    v = {k: rng.randn(n) for k, n in var_dims.items()}
    xj = jo.apply_rho(BlockVector({k: jnp.asarray(a) for k, a in v.items()}),
                      jnp.asarray(rho))
    xt = to.apply_rho(TBlockVector({k: torch.tensor(a) for k, a in v.items()}),
                      torch.tensor(rho, dtype=torch.float64))
    assert set(xt.keys()) == set(xj.keys())
    for k in xj.keys():
        np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=0,
                                   atol=1e-10)


def test_rho_sum_square_is_the_closed_form():
    rng = np.random.RandomState(2)
    m, n, alpha, rho = 8, 5, 0.7, 3.0
    H, g, v = rng.randn(m, n), rng.randn(m), rng.randn(n)
    from epsilon_tpu_torch.ir import AffineOperator as TA
    from epsilon_tpu_torch.ir import ProxFunctionSpec as TS
    from epsilon_tpu_torch.ir import ProxKind as TK
    from epsilon_tpu_torch.ops import linop as tlinop
    from epsilon_tpu_torch.ops.block import BlockMatrix as TBM
    op = top.create_rho_prox_operator(
        TS(kind=TK.SUM_SQUARE, alpha=alpha),
        TA(TBM({(arg_key(0), "x"): tlinop.dense(H)}), TBlockVector({arg_key(0): g})),
        {"x": n})
    x = op.apply_rho(TBlockVector({"x": torch.tensor(v)}),
                     torch.tensor(rho, dtype=torch.float64))["x"].numpy()
    want = np.linalg.solve(2 * alpha * H.T @ H + rho * np.eye(n),
                           rho * v - 2 * alpha * H.T @ g)
    np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-10)
    # apply() is the unit-rho case
    np.testing.assert_allclose(
        op.apply(TBlockVector({"x": torch.tensor(v)}))["x"].numpy(),
        np.linalg.solve(2 * alpha * H.T @ H + np.eye(n), v - 2 * alpha * H.T @ g),
        rtol=1e-8, atol=1e-10)


# -- whole solves ------------------------------------------------------------

@pytest.mark.parametrize("drive", ["device", "host"])
@pytest.mark.parametrize("rho", [1.0, 0.05, 30.0])
def test_adaptive_lasso_matches_jax(rho, drive):
    jprob, tprob = cases.pair("lasso")
    kw = dict(TIGHT, adaptive_rho=True, rho=rho, drive=drive, warm_start=True)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    xj, xt = js.solve(), ts.solve()
    assert ts.status.state.value == "optimal"
    cases.assert_same_solve(js, ts, xj, xt)
    # the same final rho, in the loop state as a 0-d tensor
    assert ts._warm_state[2].shape == ()
    np.testing.assert_allclose(float(ts._warm_state[2]), float(js._warm_state[2]),
                               rtol=1e-12)


def test_adaptive_rho_trajectory_matches_jax():
    """One epoch per solve, the state carried over: rho after every epoch
    is the same in both packages, and it moves."""
    jprob, tprob = cases.pair("lasso", scale=30.0, lam=5.0)
    kw = dict(rel_tol=1e-9, abs_tol=1e-12, max_iterations=10,
              adaptive_rho=True, warm_start=True)
    js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
    traj_j, traj_t = [], []
    for _ in range(12):
        js.solve(), ts.solve()
        traj_j.append(float(js._warm_state[2]))
        traj_t.append(float(ts._warm_state[2]))
        cases.assert_series_close(ts.status.series, js.status.series)
    assert traj_t == traj_j
    assert len(set(traj_t)) > 2


def test_adaptive_warm_state_from_jax():
    """The port resumes from the JAX solver's adaptive state (z, u, rho)."""
    jprob, tprob = cases.pair("lasso", seed=4)
    early = dict(TIGHT, adaptive_rho=True, rho=20.0, warm_start=True,
                 max_iterations=30)
    js = jcreate(jprob, JParams(**early))
    js.solve()
    ts = tcreate(tprob, TParams(**dict(early, max_iterations=5000)))
    ts._warm_state = interop.two_block_state_from_reference(js._warm_state)
    js.params = JParams(**dict(early, max_iterations=5000))
    xj, xt = js.solve(), ts.solve()
    cases.assert_same_solve(js, ts, xj, xt)


def test_adaptive_badly_scaled_matches_jax():
    """||A|| >> 1, where rho = 1 is far from balanced: both packages take
    the same iterations, adaptive fewer than fixed."""
    jprob, tprob = cases.pair("lasso", seed=7, m=40, n=20, lam=5.0, scale=30.0)
    common = dict(rel_tol=1e-4, abs_tol=1e-7, max_iterations=20000)
    counts = {}
    for adaptive in (False, True):
        kw = dict(common, adaptive_rho=adaptive)
        js, ts = jcreate(jprob, JParams(**kw)), tcreate(tprob, TParams(**kw))
        xj, xt = js.solve(), ts.solve()
        cases.assert_same_solve(js, ts, xj, xt)
        counts[adaptive] = ts.status.num_iterations
    assert counts[True] < counts[False]


@pytest.mark.parametrize("name", ["robust_svm", "chebyshev", "tv_1d",
                                  "least_abs_dev", "portfolio"])
def test_adaptive_library_row_matches_jax(name, monkeypatch):
    """Library rows through Problem.solve with adaptive rho: robust_svm has
    an epigraph term (wrapped, rho ignored), chebyshev SOC projections,
    tv_1d the stateful PDAS kernel (its warm dual threaded with lam/rho)."""
    pj, pt = rows.build(name, monkeypatch)
    cases.assert_same_problem_solve(
        pj, pt, japi, tapi, adaptive_rho=True, max_iterations=2000, **rows.SOLVE)
    assert pt.status == "optimal"


def test_adaptive_operator_kinds_of_rows(monkeypatch):
    """What the adaptive rows above exercise: an epigraph wrapper, a plain
    vector operator taking lam/rho, and the stateful kernel."""
    from epsilon_tpu_torch.compiler import compiler as tcompiler
    seen = set()
    for name in ("robust_svm", "chebyshev", "tv_1d"):
        _, pt = rows.build(name, monkeypatch)
        s = tcreate(tcompiler.compile_problem(pt.expression_problem()),
                    TParams(adaptive_rho=True))
        for op in s.term_ops:
            if isinstance(op, top.RhoProjectionOperator):
                seen.add("proj:" + type(op.inner).__name__)
            else:
                seen.add(type(op).__name__)
        if name == "tv_1d":
            assert s._kstate0 is not None
    assert {"proj:VectorProxOperator", "proj:SecondOrderConeProxOperator",
            "VectorProxOperator", "RhoSumSquareProxOperator",
            "RhoAffineProxOperator"} <= seen


def _frontend_lasso(ep, A, b, lam):
    x = ep.Variable(A.shape[1])
    return x, ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))


def test_adaptive_warm_resolve_through_frontend():
    rng = np.random.RandomState(5)
    A, b = rng.randn(25, 12), rng.randn(25)
    (xj, pj), (xt, pt) = (_frontend_lasso(ep, A, b, 0.3) for ep in (ej, et))
    kw = dict(rel_tol=1e-5, abs_tol=1e-7, adaptive_rho=True, warm_start=True)
    for _ in range(2):
        cases.assert_same_problem_solve(pj, pt, japi, tapi, **kw)
    assert pt.solver_status.num_iterations == 10   # warm: one epoch


FLIPS = [dict(adaptive_rho=True), dict(rho=4.0), dict(adaptive_rho=True, rho=4.0),
         dict(rho=0.25), dict(solver="prox_admm"), dict(over_relaxation=1.6),
         dict(adaptive_rho=True, over_relaxation=1.6)]


def test_flipping_modes_on_one_problem_matches_jax():
    """Solver parameters flipped between warm solves on one Problem: the
    cached solver rebuilds itself and carries the warm state where that is
    defined, as the JAX package does."""
    from epsilon_tpu_torch.frontend.solve import _PROBLEM_CACHE
    rng = np.random.RandomState(6)
    A, b = rng.randn(25, 12), rng.randn(25)
    (xj, pj), (xt, pt) = (_frontend_lasso(ep, A, b, 0.3) for ep in (ej, et))
    base = dict(rel_tol=1e-5, abs_tol=1e-7, warm_start=True)
    cases.assert_same_problem_solve(pj, pt, japi, tapi, **base)
    solver = _PROBLEM_CACHE[pt][1]
    for flip in FLIPS:
        cases.assert_same_problem_solve(pj, pt, japi, tapi, **dict(base, **flip))
        assert pt.status == "optimal"
        assert _PROBLEM_CACHE[pt][1] is solver


def test_rebuild_keeps_hooks_and_rescales_dual():
    jprob, tprob = cases.pair("lasso")
    ts = tcreate(tprob, TParams(**dict(TIGHT, warm_start=True)))
    cb = lambda: False
    ts.register_stop_callback(cb)
    ts.attach_checkpointer(None)
    ts.solve()
    u_old = {k: v.clone() for k, v in ts._warm_state[1].items()}
    ts.params = TParams(**dict(TIGHT, warm_start=True, rho=4.0))
    ts._rebuild_full()
    assert ts._stop_callbacks == [cb]
    assert ts.sqrt_rho == 2.0
    for k, v in ts._warm_state[1].items():
        np.testing.assert_allclose(v.numpy(), 0.25 * u_old[k].numpy(), rtol=1e-15)
    # a mode flip drops the warm state
    ts.params = TParams(**dict(TIGHT, warm_start=True, adaptive_rho=True))
    ts._rebuild_full()
    assert ts._warm_state is None and ts.adaptive
