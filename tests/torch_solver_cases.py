"""Hand-built prox-affine problems and comparison helpers shared by the
port's solver tests: each problem is built once with the JAX package's IR
(the problems of ``tests/test_solvers.py``) and carried across with
``interop``, so both solvers run on identical data."""

import numpy as np
import jax.numpy as jnp

from epsilon_tpu.ir import (AffineOperator, Cone, ConeConstraint,
                            ProxFunctionSpec, ProxKind, ProxProblem, ProxTerm,
                            arg_key)
from epsilon_tpu.ops import linop
from epsilon_tpu.ops.block import BlockMatrix, BlockVector
from epsilon_tpu_torch import interop

SERIES_RTOL = 1e-6
VALUE_ATOL = 1e-8
OBJ_RTOL = 1e-9


def _sum_square(A, b, var="x"):
    return ProxTerm(
        spec=ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, alpha=0.5),
        H=AffineOperator(BlockMatrix({(arg_key(0), var): linop.dense(A)}),
                         BlockVector({arg_key(0): jnp.asarray(-b)})))


def _copy_constraint(n):
    return ConeConstraint(cone=Cone.ZERO, op=AffineOperator(
        BlockMatrix({("c", "x"): linop.identity(n),
                     ("c", "y"): linop.scalar(-1.0, n)}), BlockVector()))


def _two_vars(terms, n):
    return ProxProblem(terms=terms, constraints=[_copy_constraint(n)],
                       var_dims={"x": n, "y": n},
                       var_shapes={"x": (n, 1), "y": (n, 1)})


def lasso(seed=0, m=30, n=15, lam=0.5, scale=1.0):
    rng = np.random.RandomState(seed)
    A = scale * rng.randn(m, n)
    b = A @ (rng.randn(n) * (rng.rand(n) < 0.3)) + 0.1 * rng.randn(m)
    return _two_vars([_sum_square(A, b), ProxTerm(
        spec=ProxFunctionSpec(kind=ProxKind.NORM_1, alpha=lam),
        H=AffineOperator(BlockMatrix({(arg_key(0), "y"): linop.identity(n)}),
                         BlockVector()))], n)


def nonneg_least_squares(seed=2, m=25, n=8):
    rng = np.random.RandomState(seed)
    A, b = rng.randn(m, n), rng.randn(m)
    return _two_vars([_sum_square(A, b), ProxTerm(
        spec=ProxFunctionSpec(kind=ProxKind.NON_NEGATIVE),
        H=AffineOperator(BlockMatrix({(arg_key(0), "y"): linop.identity(n)}),
                         BlockVector()))], n)


def equality_constrained_ls(seed=3, m=20, n=10, p=3, d=None):
    rng = np.random.RandomState(seed)
    A, b, C = rng.randn(m, n), rng.randn(m), rng.randn(p, n)
    d = rng.randn(p) if d is None else d
    cons = [ConeConstraint(cone=Cone.ZERO, op=AffineOperator(
        BlockMatrix({("c", "x"): linop.dense(C)}),
        BlockVector({"c": jnp.asarray(-d)})))]
    return ProxProblem(terms=[_sum_square(A, b)], constraints=cons,
                       var_dims={"x": n}, var_shapes={"x": (n, 1)})


PROBLEMS = dict(lasso=lasso, nnls=nonneg_least_squares,
                eqls=equality_constrained_ls)


def pair(name, **kw):
    """``(jax_problem, port_problem)`` of one of :data:`PROBLEMS`."""
    jprob = PROBLEMS[name](**kw)
    return jprob, interop.prox_problem_from_numpy(jprob)


def series_rows(series):
    return np.array([[r.r_norm, r.s_norm, r.epsilon_primal, r.epsilon_dual]
                     for r in series])


def assert_series_close(got, want, rtol=SERIES_RTOL, atol=0.0):
    """``atol`` is for residuals that are zero up to roundoff (the N-block
    solver's primal residual of a one-constraint problem)."""
    assert len(got) == len(want)
    np.testing.assert_allclose(series_rows(got), series_rows(want), rtol=rtol,
                               atol=atol)


def assert_same_solve(js, ts, xj, xt, series_rtol=SERIES_RTOL):
    """Two solvers after ``solve()``: the same state and iteration count,
    per-epoch residual series, iterates and objective."""
    assert ts.status.state.value == js.status.state.value
    assert ts.status.num_iterations == js.status.num_iterations
    assert_series_close(ts.status.series, js.status.series, series_rtol)
    assert set(xt.keys()) == set(xj.keys())
    for k in xj.keys():
        np.testing.assert_allclose(xt[k].numpy(), np.asarray(xj[k]), rtol=0,
                                   atol=VALUE_ATOL)
    np.testing.assert_allclose(float(ts.objective_value(xt)),
                               float(js.objective_value(xj)), rtol=OBJ_RTOL)


def assert_same_problem_solve(pj, pt, japi, tapi, series_atol=0.0, **params):
    """Two frontend problems through ``Problem.solve``: status, iteration
    count, series, variable values and objective."""
    obj_j, obj_t = pj.solve(**params), pt.solve(**params)
    assert pt.status == pj.status
    assert pt.solver_status.num_iterations == pj.solver_status.num_iterations
    assert_series_close(pt.solver_status.series, pj.solver_status.series,
                        atol=series_atol)
    vals = []
    for prob, api in ((pj, japi), (pt, tapi)):
        objs = {}
        api.expr_var_objects(prob.objective.expr, objs)
        for c in prob.constraints:
            api.expr_var_objects(c, objs)
        # in the order met (each package numbers its variables itself)
        vals.append([np.asarray(v.value, dtype=np.float64)
                     for v in objs.values()])
    assert len(vals[0]) == len(vals[1])
    for a, b in zip(*vals):
        np.testing.assert_allclose(b, a, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(obj_t, obj_j, rtol=OBJ_RTOL)
    return obj_j, obj_t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=1e-12, atol=1e-14)


def _assert_affine_equal(t, j):
    assert sorted(t.A.blocks) == sorted(j.A.blocks)
    for key, op in j.A.blocks.items():
        assert t.A.blocks[key].shape == op.shape
        _close(t.A.blocks[key].as_dense(), op.as_dense())
    assert sorted(t.b.keys()) == sorted(j.b.keys())
    for key in j.b.keys():
        _close(t.b[key], j.b[key])


def assert_problems_equal(ct, cj):
    """Two compiled prox-affine problems (either package's): every term's
    kind, mode and parameters, and every block of every operator and
    offset."""
    assert ct.var_dims == cj.var_dims
    assert len(ct.terms) == len(cj.terms)
    for tt, tj in zip(ct.terms, cj.terms):
        st, sj = tt.spec, tj.spec
        assert (st.kind.value, st.epigraph, st.alpha, st.k, st.axis) == \
            (sj.kind.value, sj.epigraph, sj.alpha, sj.k, sj.axis)
        assert [tuple(a) for a in st.arg_sizes] == [tuple(a) for a in sj.arg_sizes]
        assert sorted(st.scaled_zone_params or {}) == sorted(sj.scaled_zone_params or {})
        for key, val in (sj.scaled_zone_params or {}).items():
            _close(st.scaled_zone_params[key], val)
        _assert_affine_equal(tt.H, tj.H)
    assert [c.cone.value for c in ct.constraints] == [c.cone.value for c in cj.constraints]
    for c_t, c_j in zip(ct.constraints, cj.constraints):
        _assert_affine_equal(c_t.op, c_j.op)
