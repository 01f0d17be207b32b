"""Small sizes of the 27 library rows (``PROBLEMS_REFERENCE``), shared by
the port's library and compiler tests, and helpers that build a row in both
packages from the same seed and variable numbering."""

import itertools

import numpy as np

from epsilon_tpu.frontend import expression as jex
from epsilon_tpu.problems import benchmark as jbench
from epsilon_tpu_torch.frontend import expression as tex
from epsilon_tpu_torch.problems import benchmark as tbench

# The reference sizes cut to m ~ 10-40, n ~ 5-50 (PROBLEMS_SMALL covers 18
# of the rows only); the regression rows keep a denser x0 (rho) so that the
# small instances are not trivially zero.
SMALL = dict(
    basis_pursuit=dict(m=10, n=30), chebyshev=dict(m=10, n=20),
    covsel=dict(m=10, n=12, lam=0.1), fused_lasso=dict(m=20, ni=2, k=10),
    hinge_l1=dict(m=30, n=20, rho=0.2), hinge_l1_sparse=dict(m=30, n=50, rho=0.2, mu=0.3),
    hinge_l2=dict(m=30, n=10), hinge_l2_sparse=dict(m=40, n=10, mu=0.3),
    huber=dict(m=30, n=10), infinite_push=dict(m=10, n=12, d=5),
    lasso=dict(m=15, n=30, rho=0.2), lasso_sparse=dict(m=15, n=40, rho=0.2, mu=0.3),
    least_abs_dev=dict(m=30, n=10), logreg_l1=dict(m=30, n=20, rho=0.2),
    logreg_l1_sparse=dict(m=30, n=40, rho=0.2, mu=0.3), lp=dict(m=10, n=20),
    max_gaussian=dict(m=6, n=4, k=2), max_softmax=dict(m=6, k=3, n=4),
    mnist=dict(m=30, n=20, k=4), mv_lasso=dict(m=15, n=30, k=3, rho=0.2),
    oneclass_svm=dict(m=30, n=5), portfolio=dict(m=5, n=40), qp=dict(n=20),
    quantile=dict(m=30, n=5, k=4, p=1), robust_pca=dict(n=10),
    robust_svm=dict(m=30, n=8), tv_1d=dict(n=50))

ROWS = [p.name for p in jbench.PROBLEMS_REFERENCE()]


def build(name, monkeypatch, kwargs=None):
    """The row at its small size as ``(jax_problem, port_problem)``, both
    from seed 0 with variable numbering restarted at 0."""
    kw = SMALL[name] if kwargs is None else kwargs
    out = []
    for bench, ex in ((jbench, jex), (tbench, tex)):
        monkeypatch.setattr(ex, "_COUNTER", itertools.count())
        inst = next(p for p in bench.PROBLEMS_REFERENCE() if p.name == name)
        out.append(bench.ProblemInstance(name, inst.create, kw).create_problem())
    return tuple(out)


# Iteration caps where a row would run long at its small size in eager
# PyTorch (max_gaussian converges slowly; max_softmax's axis epigraph runs
# about 25 x 25 x 30 fixed-count inner iterations per ADMM iteration); the
# comparison then holds both packages at the cap.
MAX_ITERATIONS = dict(max_gaussian=200, max_softmax=10, mnist=100)
SOLVE = dict(rel_tol=1e-3, abs_tol=1e-6)

# Tolerances of check_row, f64 on the CPU, where the packages differ in the
# order of floating-point sums.  The per-epoch residual series of
# max_gaussian, whose NEG_LOG_DET epigraph is solved by implicit Newton on
# lambda, agree to 1.5e-6 over 200 iterations (the next smallest row 2.2e-11).
SERIES_RTOL = 1e-6
SERIES_RTOL_ROWS = dict(max_gaussian=1e-5)
VALUE_ATOL = 1e-7
OBJ_RTOL = 1e-9


def _values(prob, api):
    objs = {}
    api.expr_var_objects(prob.objective.expr, objs)
    for c in prob.constraints:
        api.expr_var_objects(c, objs)
    return {k: np.asarray(v.value, dtype=np.float64) for k, v in objs.items()}


def check_row(name, monkeypatch):
    """One library row at its small size through Problem.solve in both
    packages: the same state and iteration count, per-epoch residual series,
    variable values and objective within the tolerances above."""
    from epsilon_tpu.frontend import api as japi
    from epsilon_tpu_torch.frontend import api as tapi
    pj, pt = build(name, monkeypatch)
    params = dict(SOLVE, max_iterations=MAX_ITERATIONS.get(name, 5000))
    obj_j, obj_t = pj.solve(**params), pt.solve(**params)
    sj, st = pj.solver_status, pt.solver_status
    assert pt.status == pj.status
    assert st.num_iterations == sj.num_iterations
    assert len(st.series) == len(sj.series)
    for g, w in zip(st.series, sj.series):
        np.testing.assert_allclose([g.r_norm, g.s_norm, g.epsilon_primal, g.epsilon_dual],
                                   [w.r_norm, w.s_norm, w.epsilon_primal, w.epsilon_dual],
                                   rtol=SERIES_RTOL_ROWS.get(name, SERIES_RTOL))
    vj, vt = _values(pj, japi), _values(pt, tapi)
    assert sorted(vj) == sorted(vt)
    for k in vj:
        np.testing.assert_allclose(vt[k], vj[k], rtol=0, atol=VALUE_ATOL, err_msg=k)
    np.testing.assert_allclose(obj_t, obj_j, rtol=OBJ_RTOL)
    return obj_t
