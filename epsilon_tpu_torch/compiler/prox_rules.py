"""Prox-affine transform: greedy pattern-matching of expression trees onto
the prox-function library.

Re-design of ``python/epopt/compiler/transforms/prox.py`` (~25 match rules,
``prox.py:74-663``): rules match expression shapes and emit *pending terms*
(a :class:`~epsilon_tpu_torch.ir.ProxFunctionSpec` plus per-argument
:class:`~epsilon_tpu_torch.compiler.affine.AffineFold`), splitting off epigraph
variables whenever an argument's affine structure is not diagonal/scalar
enough for the kernel (``prox.py:23-42``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np

from ..frontend import expression as ex
from ..frontend.dcp import Curvature, Sign
from ..frontend.expression import Expression, ExprType
from ..ir import Cone, ProxFunctionSpec, ProxKind
from . import affine as aff
from .affine import AffineFold, fold_affine, fold_is_diagonal, fold_is_scalar


class TransformError(Exception):
    pass


@dataclasses.dataclass
class PendingTerm:
    spec: ProxFunctionSpec
    args: List[AffineFold]


@dataclasses.dataclass
class MatchResult:
    match: bool
    term: Optional[PendingTerm] = None
    raw_exprs: List[Expression] = dataclasses.field(default_factory=list)
    alpha: float = 1.0


_EPI_COUNTER = itertools.count()


def epi_var(e: Expression, name: str) -> Expression:
    return ex.variable(e.m, e.n, f"{name}:{next(_EPI_COUNTER):x}")


def epi(f_expr: Expression, t_expr: Expression) -> Expression:
    """Curvature-dependent epigraph constraint (``transform_util.py:17-34``)."""
    c = f_expr.dcp_props.curvature
    if c == Curvature.CONVEX:
        return ex.leq_constraint(f_expr, t_expr)
    if c == Curvature.CONCAVE:
        return ex.leq_constraint(ex.negate(f_expr), ex.negate(t_expr))
    if c in (Curvature.AFFINE, Curvature.CONSTANT):
        return ex.eq_constraint(f_expr, t_expr)
    raise TransformError(f"unknown curvature {c}")


def epi_transform(f_expr: Expression, name: str):
    t = epi_var(f_expr, name)
    return t, [epi(f_expr, t)]


# -- argument conversion (prox.py:23-42) ------------------------------------

def convert_diagonal(arg: Expression) -> Tuple[AffineFold, Expression, list]:
    """Returns (fold, original-or-copy expr, extra constraint exprs)."""
    if not arg.dcp_props.affine:
        t, constrs = epi_transform(arg, "affine")
        return fold_affine(t), t, constrs
    f = fold_affine(arg)
    if fold_is_diagonal(f):
        return f, arg, []
    t, constrs = epi_transform(arg, "diagonal")
    return fold_affine(t), t, constrs


def convert_scalar(arg: Expression) -> Tuple[AffineFold, Expression, list]:
    if not arg.dcp_props.affine:
        t, constrs = epi_transform(arg, "affine")
        return fold_affine(t), t, constrs
    f = fold_affine(arg)
    if fold_is_scalar(f):
        return f, arg, []
    t, constrs = epi_transform(arg, "scalar")
    return fold_affine(t), t, constrs


def convert_affine(arg: Expression) -> Tuple[AffineFold, Expression, list]:
    if not arg.dcp_props.affine:
        t, constrs = epi_transform(arg, "affine")
        return fold_affine(t), t, constrs
    return fold_affine(arg), arg, []


# -- pattern helpers (transform_util.py:85-143) ------------------------------

def get_scalar_constant(e: Expression) -> Optional[float]:
    if e.dim != 1:
        return None
    if e.expr_type == ExprType.NEGATE:
        c = get_scalar_constant(e.args[0])
        return None if c is None else -c
    if e.expr_type == ExprType.CONSTANT and "scalar" in e.attr:
        return e.attr["scalar"]
    return None


def get_hinge_arg(e: Expression) -> Optional[Expression]:
    """Hinge argument of ``sum(max(0, x))`` — flat, axis, or nested
    ``sum(sum(max(0, x), axis=k))`` form (the outer expr's axis attr is
    authoritative for all three; the nested form is flat)."""
    if (e.expr_type == ExprType.SUM and e.attr.get("axis") is None and
            e.args[0].expr_type == ExprType.SUM and
            e.args[0].attr.get("axis") is not None):
        e = e.args[0]
    if (e.expr_type == ExprType.SUM and
            e.args[0].expr_type == ExprType.MAX_ELEMENTWISE and
            len(e.args[0].args) == 2):
        if get_scalar_constant(e.args[0].args[0]) == 0:
            return e.args[0].args[1]
        if get_scalar_constant(e.args[0].args[1]) == 0:
            return e.args[0].args[0]
    return None


def get_quantile_arg(e: Expression):
    if (e.expr_type in (ExprType.MULTIPLY, ExprType.MULTIPLY_ELEMENTWISE) and
            len(e.args) == 2 and e.args[0].dcp_props.constant and
            (e.expr_type == ExprType.MULTIPLY_ELEMENTWISE or
             e.args[0].dim == 1)):
        return e.args[0], e.args[1]
    return None, None


def get_total_variation_arg(e: Expression) -> Optional[Expression]:
    if not (e.expr_type == ExprType.NORM_P and e.attr["p"] == 1):
        return None
    a = e.args[0]
    if not (a.expr_type == ExprType.ADD and len(a.args) == 2):
        return None
    lhs, rhs = a.args
    if not (lhs.expr_type == ExprType.INDEX and
            lhs.args[0].expr_type == ExprType.VARIABLE and
            rhs.expr_type == ExprType.NEGATE and
            rhs.args[0].expr_type == ExprType.INDEX and
            rhs.args[0].args[0].expr_type == ExprType.VARIABLE):
        return None
    v0 = lhs.args[0].attr["variable_id"]
    v1 = rhs.args[0].args[0].attr["variable_id"]
    if v0 == v1:
        return lhs.args[0]
    return None


def get_epigraph(e: Expression):
    """Detect I(t - f(x) >= 0) (``transform_util.py:85-99``)."""
    if not (e.expr_type == ExprType.INDICATOR and
            e.attr["cone"] == Cone.NON_NEGATIVE and
            not e.args[0].dcp_props.affine and
            e.args[0].expr_type == ExprType.ADD and
            len(e.args[0].args) == 2):
        return None, None
    a, b = e.args[0].args
    for t_e, f_neg in ((a, b), (b, a)):
        if t_e.dcp_props.affine:
            return ex.negate(f_neg), t_e
    return None, None


def is_indicator_prox(spec: ProxFunctionSpec) -> bool:
    return spec.epigraph or spec.kind in (
        ProxKind.NON_NEGATIVE, ProxKind.SECOND_ORDER_CONE,
        ProxKind.SEMIDEFINITE, ProxKind.ZERO)


def _dims(e: Expression):
    return (e.m, e.n)


# ---------------------------------------------------------------------------
# Rules. Each returns a MatchResult.
# ---------------------------------------------------------------------------

def prox_constant(e):
    if e.dcp_props.constant:
        return MatchResult(True, PendingTerm(
            ProxFunctionSpec(kind=ProxKind.CONSTANT), [fold_affine(e)]))
    return MatchResult(False)


def prox_affine(e):
    if e.dcp_props.affine:
        return MatchResult(True, PendingTerm(
            ProxFunctionSpec(kind=ProxKind.AFFINE), [fold_affine(e)]))
    return MatchResult(False)


def prox_add(e):
    if e.expr_type == ExprType.ADD:
        return MatchResult(True, None, list(e.args))
    return MatchResult(False)


def prox_multiply(e):
    if e.expr_type == ExprType.MULTIPLY and len(e.args) == 2:
        for i, a in enumerate(e.args):
            if a.dim == 1 and a.dcp_props.constant:
                alpha = get_scalar_constant(a)
                if alpha is None:
                    alpha = float(aff.constant_value(a).ravel()[0])
                return MatchResult(True, None, [e.args[1 - i]], alpha)
    return MatchResult(False)


def prox_negate(e):
    if e.expr_type == ExprType.NEGATE:
        return MatchResult(True, None, [e.args[0]], -1.0)
    return MatchResult(False)


def _simple_rule(kind, extract, convert=convert_diagonal, record_size=True):
    def rule(e):
        arg = extract(e)
        if arg is None:
            return MatchResult(False)
        fold, arg_e, constrs = convert(arg)
        spec = ProxFunctionSpec(
            kind=kind,
            arg_sizes=[_dims(arg)] if record_size else [],
            axis=e.attr.get("axis"))
        return MatchResult(True, PendingTerm(spec, [fold]), constrs)
    return rule


def _sum_of_elementwise_extract(match_inner):
    """Match a separable SUM-of-elementwise atom in all three shapes
    (``vector_prox.cc:147-183`` axis machinery):

    - flat        ``sum(g(X))``              -> arg X, axis None
    - axis        ``sum(g(X), axis=k)``      -> arg X, axis k (vector-valued;
      appears under an epigraph bound, projected per-slice by vmap)
    - nested      ``sum(sum(g(X), axis=k))`` -> arg X, axis None (the same
      separable sum — extracted flat, which skips the pointless vmap)

    ``_simple_rule`` reads ``axis`` off the OUTER expression, which is
    exactly right for all three.
    """
    def extract(e):
        if e.expr_type != ExprType.SUM:
            return None
        arg = match_inner(e.args[0])
        if arg is not None:
            return arg
        if (e.attr.get("axis") is None and
                e.args[0].expr_type == ExprType.SUM and
                e.args[0].attr.get("axis") is not None):
            return match_inner(e.args[0].args[0])
        return None
    return extract


def _norm1_extract(e):
    """norm_1 in flat, axis (per-slice L1, epigraph use), and
    sum-of-axis (== flat L1) forms; the TV rule runs first and claims
    norm_1-of-differences."""
    if e.expr_type == ExprType.NORM_P and e.attr["p"] == 1:
        return e.args[0]
    if (e.expr_type == ExprType.SUM and e.attr.get("axis") is None and
            e.args[0].expr_type == ExprType.NORM_P and
            e.args[0].attr["p"] == 1 and
            e.args[0].attr.get("axis") is not None):
        return e.args[0].args[0]
    return None


prox_norm_1 = _simple_rule(ProxKind.NORM_1, _norm1_extract)

prox_exp = _simple_rule(
    ProxKind.EXP,
    lambda e: e.args[0] if e.expr_type == ExprType.EXP else None)

prox_sum_exp = _simple_rule(
    ProxKind.SUM_EXP,
    _sum_of_elementwise_extract(
        lambda a: a.args[0] if a.expr_type == ExprType.EXP else None))

prox_sum_inv_pos = _simple_rule(
    ProxKind.SUM_INV_POS,
    _sum_of_elementwise_extract(
        lambda a: a.args[0] if (a.expr_type == ExprType.POWER and
                                a.attr["p"] == -1) else None))

prox_sum_logistic = _simple_rule(
    ProxKind.SUM_LOGISTIC,
    _sum_of_elementwise_extract(
        lambda a: a.args[0] if a.expr_type == ExprType.LOGISTIC else None))

prox_sum_neg_entr = _simple_rule(
    ProxKind.SUM_NEG_ENTR,
    _sum_of_elementwise_extract(
        lambda a: a.args[0].args[0] if (
            a.expr_type == ExprType.NEGATE and
            a.args[0].expr_type == ExprType.ENTR) else None))

prox_sum_neg_log = _simple_rule(
    ProxKind.SUM_NEG_LOG,
    _sum_of_elementwise_extract(
        lambda a: a.args[0].args[0] if (
            a.expr_type == ExprType.NEGATE and
            a.args[0].expr_type == ExprType.LOG) else None))


def prox_sum_kl_div(e):
    if (e.expr_type == ExprType.SUM and
            e.args[0].expr_type == ExprType.KL_DIV):
        x, y = e.args[0].args
    elif e.expr_type == ExprType.KL_DIV:
        x, y = e.args
    else:
        return MatchResult(False)
    fx, _, cx = convert_diagonal(x)
    fy, _, cy = convert_diagonal(y)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_KL_DIV,
                            arg_sizes=[_dims(x), _dims(y)])
    return MatchResult(True, PendingTerm(spec, [fx, fy]), cx + cy)


def prox_non_negative_rule(e):
    if (e.expr_type == ExprType.INDICATOR and
            e.attr["cone"] == Cone.NON_NEGATIVE and
            e.args[0].dcp_props.affine):
        arg = e.args[0]
    else:
        return MatchResult(False)
    fold, _, constrs = convert_diagonal(arg)
    spec = ProxFunctionSpec(kind=ProxKind.NON_NEGATIVE, arg_sizes=[_dims(arg)])
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def prox_sum_deadzone(e):
    hinge_arg = get_hinge_arg(e)
    arg = None
    m_val = None
    if (hinge_arg is not None and hinge_arg.expr_type == ExprType.ADD and
            len(hinge_arg.args) == 2 and
            hinge_arg.args[0].expr_type == ExprType.ABS):
        m_val = get_scalar_constant(hinge_arg.args[1])
        if m_val is not None and m_val <= 0:
            arg = hinge_arg.args[0].args[0]
    if arg is None:
        return MatchResult(False)
    fold, _, constrs = convert_diagonal(arg)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_DEADZONE,
                            arg_sizes=[_dims(arg)],
                            axis=e.attr.get("axis"),
                            scaled_zone_params={"M": -m_val})
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def prox_sum_hinge(e):
    arg = get_hinge_arg(e)
    if arg is None:
        return MatchResult(False)
    fold, _, constrs = convert_diagonal(arg)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_HINGE, arg_sizes=[_dims(arg)],
                            axis=e.attr.get("axis"))
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def prox_sum_quantile(e):
    arg = None
    alpha = beta = None
    axis = e.attr.get("axis")
    if (e.expr_type == ExprType.SUM and axis is None and
            e.args[0].expr_type == ExprType.SUM and
            e.args[0].attr.get("axis") is not None):
        # nested sum(sum(..., axis=k)): the same separable sum, flat
        e = e.args[0]
    if (e.expr_type == ExprType.SUM and
            e.args[0].expr_type == ExprType.MAX_ELEMENTWISE and
            len(e.args[0].args) == 2):
        a_c, x = get_quantile_arg(e.args[0].args[0])
        b_c, y = get_quantile_arg(e.args[0].args[1])
        if x is not None and y is not None and x is y:
            sa, sb = a_c.dcp_props.sign, b_c.dcp_props.sign
            if sa == Sign.NEGATIVE and sb == Sign.POSITIVE:
                alpha, beta = b_c, ex.negate(a_c)
                arg = x
            elif sa == Sign.POSITIVE and sb == Sign.NEGATIVE:
                alpha, beta = a_c, ex.negate(b_c)
                arg = x
    if arg is None:
        return MatchResult(False)
    a_val = aff.constant_value(alpha).ravel(order="F")
    b_val = aff.constant_value(beta).ravel(order="F")
    if axis is not None and (a_val.size != 1 or b_val.size != 1):
        # per-slice vmap cannot thread full-size per-coordinate params;
        # vector-parameter quantile stays flat-only (matches the reference,
        # which has no axis form for scaled-zone params at all)
        return MatchResult(False)
    n = arg.dim
    if axis is None:
        if a_val.size == 1:
            a_val = np.full(n, a_val[0])
        if b_val.size == 1:
            b_val = np.full(n, b_val[0])
    else:
        a_val, b_val = float(a_val[0]), float(b_val[0])
    fold, _, constrs = convert_diagonal(arg)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_QUANTILE, arg_sizes=[_dims(arg)],
                            axis=axis,
                            scaled_zone_params={"alpha": a_val, "beta": b_val})
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def _vector_rule(kind, extract, **spec_kw):
    def rule(e):
        out = extract(e)
        if out is None:
            return MatchResult(False)
        arg, extra = out if isinstance(out, tuple) else (out, {})
        kw = {**spec_kw, **extra}
        axis = kw.pop("axis", e.attr.get("axis"))
        fold, _, constrs = convert_scalar(arg)
        spec = ProxFunctionSpec(kind=kind, arg_sizes=[_dims(arg)],
                                axis=axis, **kw)
        return MatchResult(True, PendingTerm(spec, [fold]), constrs)
    return rule


def _axis_reduction_extract(inner_type):
    """Match either the bare vector atom (scalar output) or
    SUM(atom(axis=k)) — the separable axis-mode form batched by vmap in the
    operator layer (replaces the reference's serial axis loop,
    ``vector_prox.cc:147-183``)."""
    def extract(e):
        if e.expr_type == inner_type:
            # bare atom: vector form (axis None) or axis form (epigraph use,
            # prox.py:333-350 has_axis)
            return e.args[0], {"axis": e.attr.get("axis")}
        if (e.expr_type == ExprType.SUM and e.attr.get("axis") is None and
                e.args[0].expr_type == inner_type and
                e.args[0].attr.get("axis") is not None):
            return e.args[0].args[0], {"axis": e.args[0].attr["axis"]}
        return None
    return extract


prox_log_sum_exp = _vector_rule(
    ProxKind.LOG_SUM_EXP, _axis_reduction_extract(ExprType.LOG_SUM_EXP))

prox_max = _vector_rule(
    ProxKind.MAX, _axis_reduction_extract(ExprType.MAX_ENTRIES))

def _norm_p_extract(p_val):
    """Match norm_p(x, p) (bare vector or axis form) or
    SUM(norm_p(x, p, axis=k)) — the mixed-norm form (e.g. group lasso as
    sum of row norms) batched by vmap in the operator layer instead of
    routing through the conic SOC detour (``prox.py:352-370`` axis mode)."""
    def extract(e):
        if e.expr_type == ExprType.NORM_P and e.attr["p"] == p_val:
            return e.args[0], {"axis": e.attr.get("axis")}
        if (e.expr_type == ExprType.SUM and e.attr.get("axis") is None and
                e.args[0].expr_type == ExprType.NORM_P and
                e.args[0].attr["p"] == p_val and
                e.args[0].attr.get("axis") is not None):
            return e.args[0].args[0], {"axis": e.args[0].attr["axis"]}
        return None
    return extract


prox_norm_2 = _vector_rule(ProxKind.NORM_2, _norm_p_extract(2))

# Direct kernels beyond reference parity: the reference routes norm_inf and
# sigma_max through the conic fallback (``conic.py:15-43`` p=inf branch and
# the SDP embedding at ``conic.py:176-186``); here both match a direct
# sort-based / SVD-based prox instead.
prox_norm_inf = _vector_rule(ProxKind.NORM_INF, _norm_p_extract(float("inf")))

prox_sigma_max = _vector_rule(
    ProxKind.SIGMA_MAX,
    lambda e: e.args[0] if e.expr_type == ExprType.SIGMA_MAX else None)

prox_sum_largest = _vector_rule(
    ProxKind.SUM_LARGEST,
    lambda e: (e.args[0], {"k": e.attr["k"]})
    if e.expr_type == ExprType.SUM_LARGEST else None)

prox_total_variation_1d = _vector_rule(
    ProxKind.TOTAL_VARIATION_1D,
    lambda e: get_total_variation_arg(e))

prox_lambda_max = _vector_rule(
    ProxKind.LAMBDA_MAX,
    lambda e: e.args[0] if e.expr_type == ExprType.LAMBDA_MAX else None)

prox_semidefinite_rule = _vector_rule(
    ProxKind.SEMIDEFINITE,
    lambda e: e.args[0] if (e.expr_type == ExprType.INDICATOR and
                            e.attr["cone"] == Cone.SEMIDEFINITE) else None)

prox_norm_nuclear = _vector_rule(
    ProxKind.NORM_NUCLEAR,
    lambda e: e.args[0] if e.expr_type == ExprType.NORM_NUC else None)


def prox_log_det(e):
    if e.expr_type != ExprType.LOG_DET:
        return MatchResult(False)
    arg = e.args[0]
    fold, _, constrs = convert_scalar(arg)
    spec = ProxFunctionSpec(kind=ProxKind.NEG_LOG_DET, alpha=-1.0,
                            arg_sizes=[_dims(arg)])
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def prox_second_order_cone(e):
    args = None
    if (e.expr_type == ExprType.INDICATOR and
            e.attr["cone"] == Cone.SECOND_ORDER):
        args = list(e.args)
    else:
        f_expr, t_expr = get_epigraph(e)
        if (f_expr is not None and f_expr.expr_type == ExprType.NORM_P and
                f_expr.attr["p"] == 2 and f_expr.attr.get("axis") is None):
            args = [t_expr, ex.reshape(f_expr.args[0], 1, f_expr.args[0].dim)]
    if args is None:
        return MatchResult(False)
    f0, _, c0 = convert_scalar(args[0])
    f1, _, c1 = convert_scalar(args[1])
    spec = ProxFunctionSpec(kind=ProxKind.SECOND_ORDER_CONE,
                            arg_sizes=[_dims(args[0]), _dims(args[1])])
    return MatchResult(True, PendingTerm(spec, [f0, f1]), c0 + c1)


def prox_sum_square(e):
    if (e.expr_type == ExprType.QUAD_OVER_LIN and
            get_scalar_constant(e.args[1]) == 1.0):
        arg = e.args[0]
    elif (e.expr_type == ExprType.POWER and e.attr["p"] == 2 and
          e.args[0].expr_type == ExprType.NORM_P and
          e.args[0].attr["p"] == 2 and e.args[0].attr.get("axis") is None):
        arg = e.args[0].args[0]
    elif (e.expr_type == ExprType.SUM and e.attr.get("axis") is None and
          e.args[0].expr_type == ExprType.POWER and
          e.args[0].attr["p"] == 2):
        # sum(square(x)) == sum_square(x)
        arg = e.args[0].args[0]
    else:
        return MatchResult(False)
    fold, _, constrs = convert_affine(arg)
    spec = ProxFunctionSpec(kind=ProxKind.SUM_SQUARE, arg_sizes=[_dims(arg)])
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


def prox_zero(e):
    if (e.expr_type == ExprType.INDICATOR and
            e.attr["cone"] == Cone.ZERO and e.args[0].dcp_props.affine):
        arg = e.args[0]
    else:
        return MatchResult(False)
    fold, _, constrs = convert_affine(arg)
    spec = ProxFunctionSpec(kind=ProxKind.ZERO, arg_sizes=[_dims(arg)])
    return MatchResult(True, PendingTerm(spec, [fold]), constrs)


# -- epigraph rule (prox.py:546-578) ----------------------------------------

def epigraph(e):
    f_expr, t_expr = get_epigraph(e)
    if f_expr is None:
        return MatchResult(False)
    for rule in BASE_RULES:
        result = rule(f_expr)
        if result.match:
            term = result.term
            term.spec.epigraph = True
            term.spec.arg_sizes = list(term.spec.arg_sizes) + [_dims(t_expr)]
            t_fold = fold_affine(t_expr) if t_expr.dcp_props.affine else None
            constrs = []
            # A constant bound (f(x) <= c) must still introduce a pinned
            # t-variable: the joint (x, t) epigraph projection needs a real
            # variable to carry t, else the projected t is dropped and the
            # constraint silently never binds.
            if t_fold is None or not fold_is_scalar(t_fold) or not t_fold.maps:
                t_new, constrs = epi_transform(t_expr, "scalar")
                t_fold = fold_affine(t_new)
            term.args.append(t_fold)
            return MatchResult(True, term, result.raw_exprs + constrs)
    # no epigraph kernel: conic fallback on f
    obj, constrs = _conic_transform(f_expr)
    return MatchResult(True, None,
                       [ex.leq_constraint(obj, t_expr)] + constrs)


def neg_log_det_epigraph(e):
    """Custom rule: I(-log det(X) - t <= 0) (``prox.py:580-606``)."""
    if not (e.expr_type == ExprType.INDICATOR and
            e.attr["cone"] == Cone.NON_NEGATIVE and
            e.args[0].expr_type == ExprType.ADD and
            len(e.args[0].args) == 2):
        return MatchResult(False)
    for i in range(2):
        inner = e.args[0].args[i]
        if inner.expr_type == ExprType.LOG_DET:
            t_e = e.args[0].args[1 - i]
            arg = inner.args[0]
            fold, _, constrs = convert_scalar(arg)
            if not t_e.dcp_props.affine:
                return MatchResult(False)
            t_fold = fold_affine(t_e)
            spec = ProxFunctionSpec(kind=ProxKind.NEG_LOG_DET, epigraph=True,
                                    arg_sizes=[_dims(arg), _dims(t_e)])
            return MatchResult(True, PendingTerm(spec, [fold, t_fold]), constrs)
    return MatchResult(False)


def epigraph_exp_terminal(e):
    """Terminal rule for exp-shaped epigraph constraints when the generic
    epigraph rule is OFF (use_epigraph=False): ``exp(x) <= t`` has NO cone
    decomposition in the reference either — its exponential-cone prox
    (``prox/expcone.cc``) is dead code and ``prox/exp.cc:12-77`` registers
    ONLY the epigraph operator, so the conic fallback for exp/log/logistic/
    log_sum_exp compositions emits ``leq_constraint(exp(..), t)`` expecting
    the epigraph kernel to terminate it.  Without this rule, no-epigraph
    mode self-recurses (conic transform_exp returns the same constraint
    shape it was given, ``conic.py:222-225`` in the reference)."""
    f_expr, _ = get_epigraph(e)
    if f_expr is None or f_expr.expr_type != ExprType.EXP:
        return MatchResult(False)
    return epigraph(e)


def _conic_transform(e):
    raise NotImplementedError(
        f"conic fallback for {e.expr_type.value} is not yet ported "
        "(epsilon_tpu/compiler/conic.py)")


def transform_cone(e):
    obj, constrs = _conic_transform(e)
    return MatchResult(True, None, [obj] + constrs)


BASE_RULES = [
    # Matrix (prox.py:615-640 ordering preserved)
    prox_lambda_max,
    prox_log_det,
    prox_norm_nuclear,
    prox_semidefinite_rule,
    prox_sigma_max,
    # Vector
    prox_log_sum_exp,
    prox_max,
    prox_norm_2,
    prox_norm_inf,
    prox_second_order_cone,
    prox_sum_largest,
    prox_total_variation_1d,
    # Elementwise
    prox_exp,
    prox_norm_1,
    prox_sum_exp,
    prox_sum_inv_pos,
    prox_sum_logistic,
    prox_sum_neg_entr,
    prox_sum_neg_log,
    prox_sum_kl_div,
    # deadzone specializes hinge -> keep order (prox.py:636)
    prox_sum_deadzone,
    prox_sum_quantile,
    prox_sum_hinge,
    prox_sum_square,
]

PROX_RULES = [
    prox_add,
    prox_multiply,
    prox_negate,
    prox_zero,
    prox_constant,
    prox_affine,
    neg_log_det_epigraph,
]


def transform_expr(rules, e: Expression):
    """Recursive generator of PendingTerms (``prox.py:671-686``)."""
    for rule in rules:
        result = rule(e)
        if result.match:
            if result.term is not None:
                yield result.term
            for raw in result.raw_exprs:
                for term in transform_expr(rules, raw):
                    if result.alpha != 1.0 and not is_indicator_prox(term.spec):
                        term.spec.alpha *= result.alpha
                    yield term
            return
    raise TransformError(f"no prox rule matched {e!r}")


def transform_problem(problem: ex.Problem, use_epigraph: bool = True
                      ) -> List[PendingTerm]:
    rules = PROX_RULES + BASE_RULES
    if use_epigraph:
        rules = rules + [epigraph]
    else:
        rules = rules + [epigraph_exp_terminal]
    rules = rules + [prox_non_negative_rule, transform_cone]

    terms = list(transform_expr(rules, problem.objective))
    for constr in problem.constraints:
        terms += list(transform_expr(rules, constr))
    return terms
