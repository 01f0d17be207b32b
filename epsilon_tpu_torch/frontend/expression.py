"""Expression tree for the DCP frontend.

Self-contained replacement for the reference's protobuf ``Expression`` IR
(``proto/epsilon/expression.proto:205-334``) plus the factory functions in
``python/epopt/expression.py:149-433``.  CVXPY is not a dependency: the
frontend exposes a CVXPY-like modeling API (:mod:`epsilon_tpu_torch.frontend.api`)
on top of these trees, and an optional bridge converts real CVXPY problems
when that package is installed.

Conventions follow the reference: every expression is a matrix of size
(m, n); scalars are (1, 1), vectors (n, 1); vectorization is column-major.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch


class ExprType(enum.Enum):
    """Mirrors ``Expression::Type`` (``expression.proto:206-271``)."""

    INDICATOR = "indicator"
    CONSTANT = "constant"
    VARIABLE = "variable"
    ADD = "add"
    MULTIPLY = "multiply"
    MULTIPLY_ELEMENTWISE = "multiply_elementwise"
    DIAG_MAT = "diag_mat"
    DIAG_VEC = "diag_vec"
    HSTACK = "hstack"
    INDEX = "index"
    NEGATE = "negate"
    RESHAPE = "reshape"
    SUM = "sum"
    TRACE = "trace"
    TRANSPOSE = "transpose"
    VSTACK = "vstack"
    KRON = "kron"
    UPPER_TRI = "upper_tri"
    ABS = "abs"
    POWER = "power"
    SQUARE_ROOT = "square_root"
    LOG = "log"
    EXP = "exp"
    HUBER = "huber"
    ENTR = "entr"
    LOGISTIC = "logistic"
    SCALED_ZONE = "scaled_zone"
    KL_DIV = "kl_div"
    NORM_P = "norm_p"
    QUAD_OVER_LIN = "quad_over_lin"
    LOG_SUM_EXP = "log_sum_exp"
    MAX_ENTRIES = "max_entries"
    MIN_ENTRIES = "min_entries"
    SUM_LARGEST = "sum_largest"
    GEO_MEAN = "geo_mean"
    LOG_DET = "log_det"
    NORM_2_ELEMENTWISE = "norm_2_elementwise"
    MAX_ELEMENTWISE = "max_elementwise"
    MIN_ELEMENTWISE = "min_elementwise"
    NORM_NUC = "norm_nuc"
    LAMBDA_MAX = "lambda_max"
    LAMBDA_MIN = "lambda_min"
    MATRIX_FRAC = "matrix_frac"
    SIGMA_MAX = "sigma_max"
    PROX_FUNCTION = "prox_function"


from ..ir import Cone, ProxFunctionSpec  # noqa: E402  (shared enums)


_COUNTER = itertools.count()


class Expression:
    """Immutable expression node with lazily-cached DCP properties
    (``expression.py:46-97``)."""

    __slots__ = ("expr_type", "size", "args", "attr", "_dcp", "__weakref__")

    def __init__(self, expr_type: ExprType, size: Tuple[int, int],
                 args: Tuple["Expression", ...] = (), **attr):
        self.expr_type = expr_type
        self.size = (int(size[0]), int(size[1]))
        self.args = tuple(args)
        self.attr: Dict[str, Any] = attr
        self._dcp = None

    # -- conveniences ------------------------------------------------------
    @property
    def m(self):
        return self.size[0]

    @property
    def n(self):
        return self.size[1]

    @property
    def dim(self):
        return self.size[0] * self.size[1]

    @property
    def dcp_props(self):
        if self._dcp is None:
            from . import dcp
            self._dcp = dcp.compute_dcp_properties(self)
        return self._dcp

    def __getattr__(self, name):
        # attribute access for node-specific fields (p, k, M, cone, ...)
        try:
            return self.attr[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        return f"{self.expr_type.value}{self.size}"

    # NOTE: python operator sugar lives on the api.Atom wrapper; these trees
    # are plain value objects used by the compiler.


# ---------------------------------------------------------------------------
# Leaf factories
# ---------------------------------------------------------------------------

def variable(m: int, n: int = 1, variable_id: Optional[str] = None) -> Expression:
    if variable_id is None:
        variable_id = f"var:{next(_COUNTER)}"
    return Expression(ExprType.VARIABLE, (m, n), variable_id=variable_id)


def constant(value, size: Optional[Tuple[int, int]] = None) -> Expression:
    """A concrete constant: python scalar, ndarray, or scipy sparse."""
    if np.isscalar(value):
        if size is None or size == (1, 1):
            return Expression(ExprType.CONSTANT, (1, 1), scalar=float(value))
        return Expression(ExprType.CONSTANT, size,
                          value=np.full(size, float(value)))
    if sp.issparse(value):
        return Expression(ExprType.CONSTANT, value.shape, value=value)
    if isinstance(value, torch.Tensor):
        # operator algebra runs on the host: bring tensor constants there
        value = value.detach().cpu().numpy()
    # keep floating inputs in their own dtype: re-casting a GB-scale f32
    # feature matrix to f64 copies it for no accuracy gain (every consumer
    # casts to the solver dtype anyway)
    if isinstance(value, np.ndarray) and np.issubdtype(value.dtype,
                                                       np.floating):
        value = np.asarray(value)
    else:
        value = np.asarray(value, dtype=float)
    if value.ndim == 0:
        return constant(float(value), size)
    if value.ndim == 1:
        value = value.reshape(-1, 1)
    return Expression(ExprType.CONSTANT, value.shape, value=value)


def scalar_constant(value: float, size: Tuple[int, int] = (1, 1)) -> Expression:
    if size == (1, 1):
        return Expression(ExprType.CONSTANT, (1, 1), scalar=float(value))
    return constant(value, size)


def ones(m: int, n: int = 1) -> Expression:
    return constant(np.ones((m, n)))


def is_scalar_expr(e: Expression) -> bool:
    return e.dim == 1


# ---------------------------------------------------------------------------
# Structural factories (expression.py:149-433 equivalents)
# ---------------------------------------------------------------------------

def _promoted_size(args) -> Tuple[int, int]:
    size = (1, 1)
    for a in args:
        if a.dim != 1:
            if size != (1, 1) and size != a.size:
                raise ValueError(f"incompatible sizes {size} vs {a.size}")
            size = a.size
    return size


def add(*args: Expression) -> Expression:
    args = [a for a in args]
    if not args:
        raise ValueError("add() needs at least one argument")
    if len(args) == 1:
        return args[0]
    return Expression(ExprType.ADD, _promoted_size(args), args)


def negate(x: Expression) -> Expression:
    # reduce negate(negate(x)) -> x (``expression.py:206-209``)
    if x.expr_type == ExprType.NEGATE:
        return x.args[0]
    return Expression(ExprType.NEGATE, x.size, (x,))


def multiply(a: Expression, b: Expression) -> Expression:
    """Matrix product (or scalar scaling when either side is 1x1)."""
    if a.dim == 1 or b.dim == 1:
        size = b.size if a.dim == 1 else a.size
        return Expression(ExprType.MULTIPLY, size, (a, b))
    if a.n != b.m:
        raise ValueError(f"multiply: incompatible {a.size} @ {b.size}")
    return Expression(ExprType.MULTIPLY, (a.m, b.n), (a, b))


def multiply_elemwise(a: Expression, b: Expression) -> Expression:
    size = _promoted_size([a, b])
    return Expression(ExprType.MULTIPLY_ELEMENTWISE, size, (a, b))


def index(x: Expression, start_i, stop_i, start_j=None, stop_j=None,
          step_i=1, step_j=1) -> Expression:
    if start_j is None:
        start_j, stop_j = 0, x.n
    key = (slice(start_i, stop_i, step_i), slice(start_j, stop_j, step_j))
    m = len(range(*key[0].indices(x.m)))
    n = len(range(*key[1].indices(x.n)))
    return Expression(ExprType.INDEX, (m, n), (x,), key=key)


def transpose(x: Expression) -> Expression:
    return Expression(ExprType.TRANSPOSE, (x.n, x.m), (x,))


def reshape(x: Expression, m: int, n: int) -> Expression:
    if m * n != x.dim:
        raise ValueError(f"reshape {x.size} -> ({m},{n})")
    # reshape-with-cancellation (expression.py reshape logic)
    if x.expr_type == ExprType.RESHAPE:
        return reshape(x.args[0], m, n)
    if x.size == (m, n):
        return x
    return Expression(ExprType.RESHAPE, (m, n), (x,))


def sum_entries(x: Expression, axis: Optional[int] = None) -> Expression:
    if axis is None:
        return Expression(ExprType.SUM, (1, 1), (x,))
    if axis == 0:
        return Expression(ExprType.SUM, (1, x.n), (x,), axis=0)
    return Expression(ExprType.SUM, (x.m, 1), (x,), axis=1)


def hstack(*args: Expression) -> Expression:
    m = args[0].m
    n = sum(a.n for a in args)
    return Expression(ExprType.HSTACK, (m, n), args)


def vstack(*args: Expression) -> Expression:
    m = sum(a.m for a in args)
    n = args[0].n
    return Expression(ExprType.VSTACK, (m, n), args)


def diag_vec(x: Expression) -> Expression:
    return Expression(ExprType.DIAG_VEC, (x.m, x.m), (x,))


def diag_mat(x: Expression) -> Expression:
    return Expression(ExprType.DIAG_MAT, (x.m, 1), (x,))


def trace(x: Expression) -> Expression:
    return Expression(ExprType.TRACE, (1, 1), (x,))


def upper_tri(x: Expression) -> Expression:
    n = x.m
    return Expression(ExprType.UPPER_TRI, (n * (n - 1) // 2, 1), (x,))


def kron(a: Expression, b: Expression) -> Expression:
    return Expression(ExprType.KRON, (a.m * b.m, a.n * b.n), (a, b))


# ---------------------------------------------------------------------------
# Elementwise atoms
# ---------------------------------------------------------------------------

def abs_val(x):
    return Expression(ExprType.ABS, x.size, (x,))


def power(x, p: float):
    return Expression(ExprType.POWER, x.size, (x,), p=float(p))


def square_root(x):
    return Expression(ExprType.SQUARE_ROOT, x.size, (x,))


def log(x):
    return Expression(ExprType.LOG, x.size, (x,))


def exp(x):
    return Expression(ExprType.EXP, x.size, (x,))


def entr(x):
    return Expression(ExprType.ENTR, x.size, (x,))


def logistic(x):
    return Expression(ExprType.LOGISTIC, x.size, (x,))


def huber(x, M: float = 1.0):
    return Expression(ExprType.HUBER, x.size, (x,), M=float(M))


def kl_div(x, y):
    return Expression(ExprType.KL_DIV, (1, 1), (x, y))


def max_elemwise(*args):
    return Expression(ExprType.MAX_ELEMENTWISE, _promoted_size(args), args)


def min_elemwise(*args):
    return Expression(ExprType.MIN_ELEMENTWISE, _promoted_size(args), args)


# ---------------------------------------------------------------------------
# Vector atoms
# ---------------------------------------------------------------------------

def norm_p(x, p: float, axis: Optional[int] = None):
    if axis is None:
        return Expression(ExprType.NORM_P, (1, 1), (x,), p=float(p))
    size = (1, x.n) if axis == 0 else (x.m, 1)
    return Expression(ExprType.NORM_P, size, (x,), p=float(p), axis=axis)


def quad_over_lin(x, y):
    return Expression(ExprType.QUAD_OVER_LIN, (1, 1), (x, y))


def log_sum_exp(x, axis: Optional[int] = None):
    if axis is None:
        return Expression(ExprType.LOG_SUM_EXP, (1, 1), (x,))
    size = (1, x.n) if axis == 0 else (x.m, 1)
    return Expression(ExprType.LOG_SUM_EXP, size, (x,), axis=axis)


def max_entries(x, axis: Optional[int] = None):
    if axis is None:
        return Expression(ExprType.MAX_ENTRIES, (1, 1), (x,))
    size = (1, x.n) if axis == 0 else (x.m, 1)
    return Expression(ExprType.MAX_ENTRIES, size, (x,), axis=axis)


def min_entries(x, axis: Optional[int] = None):
    if axis is None:
        return Expression(ExprType.MIN_ENTRIES, (1, 1), (x,))
    size = (1, x.n) if axis == 0 else (x.m, 1)
    return Expression(ExprType.MIN_ENTRIES, size, (x,), axis=axis)


def sum_largest(x, k: int):
    return Expression(ExprType.SUM_LARGEST, (1, 1), (x,), k=int(k))


def geo_mean(x, w: Optional[List] = None):
    from fractions import Fraction
    n = x.dim
    if w is None:
        w = [Fraction(1, n)] * n
    return Expression(ExprType.GEO_MEAN, (1, 1), (x,), w=tuple(w))


# ---------------------------------------------------------------------------
# Matrix atoms
# ---------------------------------------------------------------------------

def log_det(X):
    return Expression(ExprType.LOG_DET, (1, 1), (X,))


def norm_nuc(X):
    return Expression(ExprType.NORM_NUC, (1, 1), (X,))


def lambda_max(X):
    return Expression(ExprType.LAMBDA_MAX, (1, 1), (X,))


def lambda_min(X):
    return Expression(ExprType.LAMBDA_MIN, (1, 1), (X,))


def matrix_frac(x, P):
    return Expression(ExprType.MATRIX_FRAC, (1, 1), (x, P))


def sigma_max(X):
    return Expression(ExprType.SIGMA_MAX, (1, 1), (X,))


def norm_2_elementwise(*args):
    return Expression(ExprType.NORM_2_ELEMENTWISE, args[0].size, args)


# ---------------------------------------------------------------------------
# Indicators / constraints (expression.py indicator factories)
# ---------------------------------------------------------------------------

def indicator(cone: Cone, *args: Expression) -> Expression:
    return Expression(ExprType.INDICATOR, (1, 1), args, cone=cone)


def eq_constraint(a: Expression, b: Expression) -> Expression:
    return indicator(Cone.ZERO, add(a, negate(b)))


def leq_constraint(a: Expression, b: Expression) -> Expression:
    """a <= b as I(b - a >= 0)."""
    return indicator(Cone.NON_NEGATIVE, add(b, negate(a)))


def soc_constraint(t: Expression, x: Expression) -> Expression:
    """||x||_2 <= t with x a row vector (or matrix whose rows are cones)."""
    return indicator(Cone.SECOND_ORDER, t, x)


def soc_elemwise_constraint(t: Expression, *args: Expression) -> Expression:
    """sqrt(sum_i x_i.^2) <= t elementwise: rows are (t_i, [x1_i ... xk_i])."""
    x = hstack(*[reshape(a, a.dim, 1) for a in args])
    return indicator(Cone.SECOND_ORDER, reshape(t, t.dim, 1), x)


def semidefinite(X: Expression) -> Expression:
    return indicator(Cone.SEMIDEFINITE, X)


def psd_constraint(A: Expression, B: Expression) -> Expression:
    """A >> B."""
    return indicator(Cone.SEMIDEFINITE, add(A, negate(B)))


def non_negative(x: Expression) -> Expression:
    return indicator(Cone.NON_NEGATIVE, x)


def prox_function(spec: ProxFunctionSpec, *args: Expression) -> Expression:
    return Expression(ExprType.PROX_FUNCTION, (1, 1), args, prox=spec)


# ---------------------------------------------------------------------------
# Problem container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Problem:
    objective: Expression
    constraints: List[Expression] = dataclasses.field(default_factory=list)


def expr_variables(expr: Expression):
    """Yield all VARIABLE leaves (depth-first, with duplicates)."""
    if expr.expr_type == ExprType.VARIABLE:
        yield expr
    for a in expr.args:
        yield from expr_variables(a)
