"""User-facing modeling API (CVXPY-like, self-contained).

The reference exposes Epsilon through CVXPY (``epopt.solve(cvxpy_prob)``).
CVXPY is optional here: this module provides the same modeling surface
natively — ``Variable``, atoms, ``Problem(Minimize(...), [...]).solve()`` —
building :mod:`epsilon_tpu_torch.frontend.expression` trees directly;
:mod:`epsilon_tpu_torch.frontend.cvxpy_bridge` converts CVXPY problems.
``Problem.solve`` takes the solver parameters as keywords, ``mesh`` (a
``torch.distributed`` process group: every rank solves the same problem
together) among them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from . import expression as ex
from .expression import Expression, ExprType

__all__ = [
    "Variable", "Parameter", "Minimize", "Maximize", "Problem",
    "scalar_constant",
    # atoms
    "abs", "square", "sqrt", "power", "exp", "log", "entr", "logistic",
    "huber", "kl_div", "pos", "neg",
    "sum_entries", "sum_squares", "norm", "norm1", "norm2", "norm_inf",
    "norm_nuc", "mul_elemwise", "max_elemwise", "min_elemwise",
    "max_entries", "min_entries", "log_sum_exp", "sum_largest", "geo_mean",
    "quad_over_lin", "matrix_frac", "lambda_max", "lambda_min", "log_det",
    "sigma_max", "trace", "diag", "reshape", "hstack", "vstack", "vec",
    "kron", "upper_tri", "transpose", "tv", "total_variation", "tv2",
]


scalar_constant = ex.scalar_constant


def _wrap(value) -> Expression:
    if isinstance(value, Expression):
        return value
    if np.isscalar(value):
        return ex.scalar_constant(float(value))
    return ex.constant(value)


# ---------------------------------------------------------------------------
# Operator sugar on Expression
# ---------------------------------------------------------------------------

def _add(self, other):
    return ex.add(self, _wrap(other))


def _radd(self, other):
    return ex.add(_wrap(other), self)


def _sub(self, other):
    return ex.add(self, ex.negate(_wrap(other)))


def _rsub(self, other):
    return ex.add(_wrap(other), ex.negate(self))


def _mul(self, other):
    return ex.multiply(self, _wrap(other)) if not isinstance(other, Expression) \
        else ex.multiply(self, other)


def _rmul(self, other):
    return ex.multiply(_wrap(other), self)


def _neg(self):
    return ex.negate(self)


def _le(self, other):
    return ex.leq_constraint(self, _wrap(other))


def _ge(self, other):
    return ex.leq_constraint(_wrap(other), self)


def _eq(self, other):
    if isinstance(other, (Expression, int, float, np.ndarray)) or sp.issparse(other):
        return ex.eq_constraint(self, _wrap(other))
    return NotImplemented


def _getitem(self, key):
    if not isinstance(key, tuple):
        key = (key, slice(None))
    ki, kj = key
    if isinstance(ki, int):
        ki = slice(ki, ki + 1)
    if isinstance(kj, int):
        kj = slice(kj, kj + 1)
    i = ki.indices(self.m)
    j = kj.indices(self.n)
    return ex.index(self, i[0], i[1], j[0], j[1], i[2], j[2])


# make numpy/scipy defer to Expression operators instead of broadcasting
Expression.__array_priority__ = 100.0
Expression.__array_ufunc__ = None

Expression.__add__ = _add
Expression.__radd__ = _radd
Expression.__sub__ = _sub
Expression.__rsub__ = _rsub
Expression.__mul__ = _mul
Expression.__rmul__ = _rmul
Expression.__matmul__ = _mul
Expression.__rmatmul__ = _rmul
Expression.__neg__ = _neg
Expression.__le__ = _le
Expression.__ge__ = _ge
Expression.__eq__ = _eq
Expression.__hash__ = lambda self: id(self)
Expression.__getitem__ = _getitem
Expression.T = property(lambda self: ex.transpose(self))


# ---------------------------------------------------------------------------
# Variables
# ---------------------------------------------------------------------------

class Variable(Expression):
    """A decision variable; ``.value`` is populated by ``Problem.solve``."""

    def __init__(self, m: int = 1, n: int = 1, name: Optional[str] = None):
        if isinstance(m, tuple):
            m, n = m
        vid = name or f"var:{next(ex._COUNTER)}"
        super().__init__(ExprType.VARIABLE, (int(m), int(n)), variable_id=vid)
        self.attr["var_object"] = self
        self.value: Optional[np.ndarray] = None


class Parameter(Variable):
    """A named constant whose value can change between solves; for now it is
    treated as a constant at compile time (re-compile on change), matching
    warm-start usage (``solvemodule.cc:89-106`` parameter updates)."""

    def __init__(self, m: int = 1, n: int = 1, name: Optional[str] = None,
                 value=None):
        super().__init__(m, n, name)
        self.attr["is_parameter"] = True
        self.value = value


# ---------------------------------------------------------------------------
# Objectives / Problem
# ---------------------------------------------------------------------------

class Minimize:
    def __init__(self, expr):
        self.expr = _wrap(expr)


class Maximize:
    def __init__(self, expr):
        self.expr = ex.negate(_wrap(expr))


class Problem:
    def __init__(self, objective, constraints: Optional[List] = None):
        if isinstance(objective, Maximize):
            self._sign = -1.0
        else:
            self._sign = 1.0
        if not isinstance(objective, (Minimize, Maximize)):
            objective = Minimize(objective)
        self.objective = objective
        self.constraints = list(constraints or [])
        self.status = None
        self.solver_status = None
        self._compiled = None
        self._solver = None

    def expression_problem(self) -> ex.Problem:
        return ex.Problem(objective=self.objective.expr,
                          constraints=list(self.constraints))

    def solve(self, **kwargs) -> float:
        from .. import solve as _solve
        return _solve(self, **kwargs)


def expr_var_objects(e: Expression, out: Dict[str, Variable]):
    if e.expr_type == ExprType.VARIABLE and "var_object" in e.attr:
        out[e.attr["variable_id"]] = e.attr["var_object"]
    for a in e.args:
        expr_var_objects(a, out)


# ---------------------------------------------------------------------------
# Atoms (CVXPY-compatible names)
# ---------------------------------------------------------------------------

def abs(x):  # noqa: A001 - mirrors cvxpy naming
    return ex.abs_val(_wrap(x))


def square(x):
    return ex.power(_wrap(x), 2)


def sqrt(x):
    return ex.power(_wrap(x), 0.5)


def power(x, p):
    return ex.power(_wrap(x), p)


def exp(x):
    return ex.exp(_wrap(x))


def log(x):
    return ex.log(_wrap(x))


def entr(x):
    return ex.entr(_wrap(x))


def logistic(x):
    return ex.logistic(_wrap(x))


def huber(x, M=1.0):
    return ex.huber(_wrap(x), M)


def kl_div(x, y):
    return ex.sum_entries(ex.kl_div(_wrap(x), _wrap(y)))


def pos(x):
    return ex.max_elemwise(_wrap(x), ex.scalar_constant(0.0))


def neg(x):
    return ex.max_elemwise(ex.negate(_wrap(x)), ex.scalar_constant(0.0))


def sum_entries(x, axis=None):
    return ex.sum_entries(_wrap(x), axis=axis)


def sum_squares(x):
    return ex.power(ex.norm_p(_wrap(x), 2), 2)


def norm(x, p=2, axis=None):
    return ex.norm_p(_wrap(x), float(p), axis=axis)


def norm1(x, axis=None):
    return ex.norm_p(_wrap(x), 1, axis=axis)


def norm2(x, axis=None):
    return ex.norm_p(_wrap(x), 2, axis=axis)


def norm_inf(x, axis=None):
    return ex.norm_p(_wrap(x), float("inf"), axis=axis)


def norm_nuc(x):
    return ex.norm_nuc(_wrap(x))


def mul_elemwise(a, b):
    return ex.multiply_elemwise(_wrap(a), _wrap(b))


def max_elemwise(*args):
    return ex.max_elemwise(*[_wrap(a) for a in args])


def min_elemwise(*args):
    return ex.min_elemwise(*[_wrap(a) for a in args])


def max_entries(x, axis=None):
    return ex.max_entries(_wrap(x), axis=axis)


def min_entries(x, axis=None):
    return ex.min_entries(_wrap(x), axis=axis)


def log_sum_exp(x, axis=None):
    return ex.log_sum_exp(_wrap(x), axis=axis)


def sum_largest(x, k):
    return ex.sum_largest(_wrap(x), k)


def geo_mean(x, w=None):
    return ex.geo_mean(_wrap(x), w)


def quad_over_lin(x, y):
    return ex.quad_over_lin(_wrap(x), _wrap(y))


def matrix_frac(x, P):
    return ex.matrix_frac(_wrap(x), _wrap(P))


def lambda_max(X):
    return ex.lambda_max(_wrap(X))


def lambda_min(X):
    return ex.lambda_min(_wrap(X))


def log_det(X):
    return ex.log_det(_wrap(X))


def sigma_max(X):
    return ex.sigma_max(_wrap(X))


def trace(X):
    return ex.trace(_wrap(X))


def diag(x):
    x = _wrap(x)
    if x.n == 1:
        return ex.diag_vec(x)
    return ex.diag_mat(x)


def reshape(x, m, n):
    return ex.reshape(_wrap(x), m, n)


def vec(x):
    x = _wrap(x)
    return ex.reshape(x, x.dim, 1)


def hstack(*args):
    return ex.hstack(*[_wrap(a) for a in args])


def vstack(*args):
    return ex.vstack(*[_wrap(a) for a in args])


def kron(a, b):
    return ex.kron(_wrap(a), _wrap(b))


def upper_tri(x):
    return ex.upper_tri(_wrap(x))


def transpose(x):
    return ex.transpose(_wrap(x))


def tv(x):
    """1-D total variation ||x[1:] - x[:-1]||_1 in the index form the prox
    compiler recognizes (``transform_util.py:get_total_variation_arg``)."""
    x = _wrap(x)
    n = x.m
    return ex.norm_p(
        ex.add(ex.index(x, 1, n), ex.negate(ex.index(x, 0, n - 1))), 1)


total_variation = tv


def tv2(*args):
    """Isotropic 2-D (multi-channel) total variation, the cvxpy ``tv``
    semantics for matrix arguments used by tv_denoise
    (``problems/tv_denoise.py:16``): sum over pixels of the l2 norm of the
    stacked forward differences of every channel."""
    args = [_wrap(a) for a in args]
    m, n = args[0].size
    diffs = []
    for Xc in args:
        dx = ex.add(ex.index(Xc, 1, m, 0, n - 1),
                    ex.negate(ex.index(Xc, 0, m - 1, 0, n - 1)))
        dy = ex.add(ex.index(Xc, 0, m - 1, 1, n),
                    ex.negate(ex.index(Xc, 0, m - 1, 0, n - 1)))
        diffs += [ex.reshape(dx, dx.dim, 1), ex.reshape(dy, dy.dim, 1)]
    return ex.sum_entries(ex.norm_2_elementwise(*diffs))
