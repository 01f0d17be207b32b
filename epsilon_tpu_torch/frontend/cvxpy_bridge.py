"""Optional CVXPY bridge (counterpart of
``epsilon_tpu/frontend/cvxpy_bridge.py``).

The reference's only frontend is CVXPY (``python/epopt/cvxpy_expr.py:141-236``
maps ~40 atom classes to Expression protos).  Here CVXPY is optional: when
installed, :func:`convert_problem` maps a ``cvxpy.Problem`` onto the native
expression layer so ``epsilon_tpu_torch.solve`` accepts CVXPY problems directly.

Targets the modern cvxpy (>= 1.1) atom class names; dispatch is by class
name so the bridge degrades gracefully across cvxpy versions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import api
from . import expression as ex
from ..ir import Cone


def cvxpy_available() -> bool:
    try:
        import cvxpy  # noqa: F401
        return True
    except ImportError:
        return False


def _var_id(var) -> str:
    return f"cvxpy:{var.id}"


def _shape2(shape):
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (shape[0], 1)
    return shape


def convert_expression(e, var_map: Dict[int, ex.Expression]) -> ex.Expression:
    import cvxpy
    import cvxpy.atoms as atoms  # noqa: F401

    name = type(e).__name__

    if isinstance(e, cvxpy.Variable):
        if e.id not in var_map:
            m, n = _shape2(e.shape)
            var_map[e.id] = api.Variable(m, n, _var_id(e))
        return var_map[e.id]
    if isinstance(e, cvxpy.Parameter):
        if e.value is None:
            raise ValueError(f"cvxpy Parameter {e} has no value")
        return ex.constant(np.asarray(e.value))
    if isinstance(e, cvxpy.Constant) or name == "Constant":
        return ex.constant(e.value)

    args = [convert_expression(a, var_map) for a in e.args]

    simple = {
        "AddExpression": lambda: ex.add(*args),
        "NegExpression": lambda: ex.negate(args[0]),
        "MulExpression": lambda: ex.multiply(args[0], args[1]),
        "multiply": lambda: ex.multiply_elemwise(args[0], args[1]),
        "DivExpression": lambda: ex.multiply(
            args[0], ex.scalar_constant(1.0 / float(e.args[1].value))),
        "index": lambda: _convert_index(e, args[0]),
        "special_index": lambda: _convert_index(e, args[0]),
        "transpose": lambda: ex.transpose(args[0]),
        "reshape": lambda: ex.reshape(args[0], *_shape2(e.shape)),
        "promote": lambda: ex.multiply(args[0], ex.constant(np.ones(_shape2(e.shape)))),
        "Sum": lambda: ex.sum_entries(args[0], axis=getattr(e, "axis", None)),
        "trace": lambda: ex.trace(args[0]),
        "hstack": lambda: ex.hstack(*args),
        "vstack": lambda: ex.vstack(*args),
        "diag_vec": lambda: ex.diag_vec(args[0]),
        "diag_mat": lambda: ex.diag_mat(args[0]),
        "upper_tri": lambda: ex.upper_tri(args[0]),
        "kron": lambda: ex.kron(args[0], args[1]),
        "abs": lambda: ex.abs_val(args[0]),
        "power": lambda: ex.power(args[0], float(e.p)),
        "sqrt": lambda: ex.power(args[0], 0.5),
        "square": lambda: ex.power(args[0], 2.0),
        "log": lambda: ex.log(args[0]),
        "log1p": lambda: ex.log(ex.add(args[0], ex.scalar_constant(1.0))),
        "exp": lambda: ex.exp(args[0]),
        "entr": lambda: ex.entr(args[0]),
        "logistic": lambda: ex.logistic(args[0]),
        "huber": lambda: ex.huber(args[0], float(e.M.value)
                                  if hasattr(e.M, "value") else float(e.M)),
        "kl_div": lambda: ex.kl_div(args[0], args[1]),
        "maximum": lambda: ex.max_elemwise(*args),
        "minimum": lambda: ex.min_elemwise(*args),
        "max": lambda: ex.max_entries(args[0], axis=getattr(e, "axis", None)),
        "min": lambda: ex.min_entries(args[0], axis=getattr(e, "axis", None)),
        "norm1": lambda: ex.norm_p(args[0], 1),
        "norm_inf": lambda: ex.norm_p(args[0], float("inf")),
        "norm2": lambda: ex.norm_p(args[0], 2),
        "Pnorm": lambda: ex.norm_p(args[0], float(e.p),
                                   axis=getattr(e, "axis", None)),
        "QuadOverLin": lambda: ex.quad_over_lin(args[0], args[1]),
        "log_sum_exp": lambda: ex.log_sum_exp(args[0],
                                              axis=getattr(e, "axis", None)),
        "sum_largest": lambda: ex.sum_largest(args[0], int(e.k)),
        "geo_mean": lambda: ex.geo_mean(args[0]),
        "log_det": lambda: ex.log_det(args[0]),
        "normNuc": lambda: ex.norm_nuc(args[0]),
        "lambda_max": lambda: ex.lambda_max(args[0]),
        "lambda_min": lambda: ex.lambda_min(args[0]),
        "matrix_frac": lambda: ex.matrix_frac(args[0], args[1]),
        "sigma_max": lambda: ex.sigma_max(args[0]),
        "QuadForm": lambda: _convert_quad_form(e, args),
    }
    if name in simple:
        return simple[name]()
    raise ValueError(f"no conversion for cvxpy atom {name}")


def _convert_index(e, arg):
    key = e.key if hasattr(e, "key") else e.get_data()[0]
    ki = key[0] if isinstance(key, tuple) else key
    kj = key[1] if isinstance(key, tuple) and len(key) > 1 else slice(None)
    if isinstance(ki, int):
        ki = slice(ki, ki + 1)
    if isinstance(kj, int):
        kj = slice(kj, kj + 1)
    i = ki.indices(arg.m)
    j = kj.indices(arg.n)
    return ex.index(arg, i[0], i[1], j[0], j[1], i[2], j[2])


def _convert_quad_form(e, args):
    P = np.asarray(e.args[1].value)
    L = np.linalg.cholesky(P + 1e-12 * np.eye(P.shape[0]))
    return ex.power(ex.norm_p(ex.multiply(ex.constant(L.T), args[0]), 2), 2)


def convert_constraint(c, var_map) -> ex.Expression:
    name = type(c).__name__
    if name in ("Equality", "Zero"):
        lhs = convert_expression(c.args[0], var_map)
        rhs = convert_expression(c.args[1], var_map) if len(c.args) > 1 \
            else ex.scalar_constant(0.0)
        return ex.eq_constraint(lhs, rhs)
    if name in ("Inequality", "NonPos", "NonNeg"):
        lhs = convert_expression(c.args[0], var_map)
        if len(c.args) > 1:
            rhs = convert_expression(c.args[1], var_map)
            return ex.leq_constraint(lhs, rhs)
        return ex.leq_constraint(lhs, ex.scalar_constant(0.0))
    if name == "SOC":
        t = convert_expression(c.args[0], var_map)
        x = convert_expression(c.args[1], var_map)
        return ex.soc_constraint(t, ex.reshape(x, 1, x.dim))
    if name == "PSD":
        return ex.semidefinite(convert_expression(c.args[0], var_map))
    raise ValueError(f"no conversion for cvxpy constraint {name}")


def convert_problem(problem):
    """cvxpy.Problem -> (native Problem, {cvxpy var -> native Expression})."""
    import cvxpy
    var_map: Dict[int, ex.Expression] = {}
    obj_expr = convert_expression(problem.objective.expr, var_map)
    if isinstance(problem.objective, cvxpy.Maximize):
        obj_expr = ex.negate(obj_expr)
    constraints = [convert_constraint(c, var_map) for c in problem.constraints]
    return ex.Problem(objective=obj_expr, constraints=constraints), var_map


def solve(cvxpy_problem, **kwargs) -> float:
    """Solve a cvxpy Problem with epsilon_tpu_torch; writes values back into the
    cvxpy variables (``cvxpy_solver.py:64-104`` behavior)."""
    import cvxpy
    native, var_map = convert_problem(cvxpy_problem)
    prob = api.Problem(api.Minimize(native.objective), native.constraints)
    obj = prob.solve(**kwargs)
    if isinstance(cvxpy_problem.objective, cvxpy.Maximize):
        # convert_problem minimizes the negation; report the max value
        obj = -obj
    # Real cvxpy's Problem.value is a read-only property; write the private
    # backing attribute so .value reads back the solved objective (the
    # reference returns the objective rather than writing it,
    # cvxpy_solver.py:96-104).
    try:
        cvxpy_problem.value = obj
    except AttributeError:
        cvxpy_problem._value = obj

    # write back values (the natives are api.Variable, so solve() filled
    # their .value)
    for v in cvxpy_problem.variables():
        nat = var_map.get(v.id)
        if nat is not None and hasattr(nat, "value") and nat.value is not None:
            val = nat.value
            v.value = val.reshape(v.shape) if v.shape else float(np.ravel(val)[0])
    return obj
