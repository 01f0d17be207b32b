"""Conic (graph-implementation) fallback for atoms without prox rules.

Counterpart of ``epsilon_tpu/compiler/conic.py`` (host code, carried over
unchanged), itself a re-design of ``python/epopt/compiler/transforms/conic.py``:
rewrites an atom
as an affine objective plus epigraph-variable constraints, introducing
second-order-cone / semidefinite structure.  The geometric-mean machinery is
self-contained (the reference borrows cvxpy's ``power_tools``): rational
powers are reduced to balanced binary trees of two-term geometric means,
each SOC-representable as ``||(x - y, 2t)|| <= x + y``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Tuple

from ..frontend import expression as ex
from ..frontend.expression import Expression, ExprType


class TransformError(Exception):
    pass


def _epi_var(e, name):
    from .prox_rules import epi_var
    return epi_var(e, name)


# ---------------------------------------------------------------------------
# Geometric mean tower (self-contained power_tools replacement)
# ---------------------------------------------------------------------------

def gm(t, x, y):
    """t <= sqrt(x*y) elementwise, SOC form (``transform_util.py:48-50``)."""
    return ex.soc_elemwise_constraint(
        ex.add(x, y),
        ex.add(x, ex.negate(y)),
        ex.multiply(ex.scalar_constant(2.0), t))


def gm_constrs(t_expr: Expression, x_exprs: List[Expression],
               p: Tuple[Fraction, ...]) -> List[Expression]:
    """Constraints enforcing ``t <= prod_i x_i^{p_i}`` with rational weights
    summing to 1 (all x_i implicitly >= 0).

    Construction: with common denominator d and D = 2^ceil(log2(d)), build a
    balanced binary tree over D leaves consisting of a_i copies of x_i and
    (D - d) copies of t itself; each internal node is a two-term geometric
    mean.  Then root >= t iff the weighted-geomean inequality holds.
    """
    p = [Fraction(pi).limit_denominator(64) for pi in p]
    total = sum(p)
    assert total == 1, f"weights must sum to 1, got {total}"
    d = 1
    for pi in p:
        d = d * pi.denominator // _gcd(d, pi.denominator)
    a = [int(pi * d) for pi in p]
    D = 1
    while D < d:
        D *= 2
    leaves = []
    for ai, xi in zip(a, x_exprs):
        leaves += [xi] * ai
    leaves += [t_expr] * (D - d)

    constrs: List[Expression] = []
    counter = [0]

    def build(nodes):
        if len(nodes) == 1:
            return nodes[0]
        mid = len(nodes) // 2
        left = build(nodes[:mid])
        right = build(nodes[mid:])
        if left is right:
            return left
        counter[0] += 1
        v = _epi_var(t_expr, f"gm_{counter[0]}")
        constrs.append(gm(v, left, right))
        return v

    root = build(leaves)
    # t <= root
    constrs.append(ex.leq_constraint(t_expr, root))
    return constrs


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


def _pow_high(p):
    """p > 1: x >= t^... reduction weights (cvxpy pow_high semantics)."""
    p = Fraction(p).limit_denominator(64)
    return p, (1 / p, 1 - 1 / p)


def _pow_mid(p):
    p = Fraction(p).limit_denominator(64)
    return p, (p, 1 - p)


def _pow_neg(p):
    p = Fraction(p).limit_denominator(64)
    return p, (-p / (1 - p), Fraction(1, 1) - (-p / (1 - p)))


# ---------------------------------------------------------------------------
# Per-atom graph implementations (conic.py:15-233)
# ---------------------------------------------------------------------------

def transform_abs(e):
    x = e.args[0]
    t = _epi_var(e, "abs")
    return t, [ex.leq_constraint(x, t), ex.leq_constraint(ex.negate(x), t)]


def transform_max_elementwise(e):
    t = _epi_var(e, "max_elementwise")
    return t, [ex.leq_constraint(x, t) for x in e.args]


def transform_min_elementwise(e):
    t = _epi_var(e, "min_elementwise")
    return t, [ex.leq_constraint(t, x) for x in e.args]


def transform_max_entries(e):
    x = e.args[0]
    m, n = x.size
    t = _epi_var(e, "max_entries")
    axis = e.attr.get("axis")
    if axis is None:
        return t, [ex.leq_constraint(x, t)]
    if axis == 0:
        return t, [ex.leq_constraint(x, ex.multiply(ex.ones(m, 1), t))]
    return t, [ex.leq_constraint(x, ex.multiply(t, ex.ones(1, n)))]


def transform_min_entries(e):
    x = e.args[0]
    t = _epi_var(e, "min_entries")
    axis = e.attr.get("axis")
    if axis is None:
        return t, [ex.leq_constraint(t, x)]
    m, n = x.size
    if axis == 0:
        return t, [ex.leq_constraint(ex.multiply(ex.ones(m, 1), t), x)]
    return t, [ex.leq_constraint(ex.multiply(t, ex.ones(1, n)), x)]


def transform_lambda_max(e):
    t = _epi_var(ex.scalar_constant(0.0), "lambda_max")
    X = e.args[0]
    n = X.m
    tI = ex.diag_vec(ex.multiply(ex.ones(n, 1), t))
    return t, [ex.psd_constraint(tI, X)]


def transform_lambda_min(e):
    # lambda_min(X) >= t  <=>  X >> tI; appears negated under minimize
    t = _epi_var(ex.scalar_constant(0.0), "lambda_min")
    X = e.args[0]
    n = X.m
    tI = ex.diag_vec(ex.multiply(ex.ones(n, 1), t))
    return t, [ex.psd_constraint(X, tI)]


def transform_sigma_max(e):
    X = e.args[0]
    m, n = X.size
    S = _epi_var(ex.constant(0.0, (m + n, m + n)), "sigma_max_S")
    t = _epi_var(ex.scalar_constant(0.0), "sigma_max")
    t_In = ex.diag_vec(ex.multiply(ex.ones(n, 1), t))
    t_Im = ex.diag_vec(ex.multiply(ex.ones(m, 1), t))
    return t, [
        ex.eq_constraint(ex.index(S, 0, n, 0, n), t_In),
        ex.eq_constraint(ex.index(S, n, n + m, 0, n), X),
        ex.eq_constraint(ex.index(S, n, n + m, n, n + m), t_Im),
        ex.semidefinite(S)]


def transform_quad_over_lin(e):
    x, y = e.args
    assert y.dim == 1
    t = _epi_var(ex.scalar_constant(0.0), "qol")
    return t, [
        ex.soc_constraint(
            ex.add(y, t),
            ex.hstack(ex.add(y, ex.negate(t)),
                      ex.reshape(ex.multiply(ex.scalar_constant(2.0), x),
                                 1, x.dim))),
        ex.leq_constraint(ex.scalar_constant(0.0), y)]


def transform_norm_p(e):
    p = e.attr["p"]
    x = e.args[0]
    t = _epi_var(e, "norm_p")

    if p == float("inf"):
        return t, [ex.leq_constraint(x, t), ex.leq_constraint(ex.negate(x), t)]
    if p == 1:
        return transform_expr(ex.sum_entries(ex.abs_val(x)))
    if p == 2:
        axis = e.attr.get("axis")
        if axis is None:
            return t, [ex.soc_constraint(t, ex.reshape(x, 1, x.dim))]
        if axis == 0:
            return t, [ex.soc_constraint(ex.reshape(t, x.n, 1), ex.transpose(x))]
        return t, [ex.soc_constraint(t, x)]

    r = _epi_var(x, "norm_p_r")
    t1 = ex.multiply(ex.ones(*x.size), t)
    if p < 0:
        pf, w = _pow_neg(p)
        constrs = gm_constrs(t1, [x, r], w)
    elif 0 < p < 1:
        pf, w = _pow_mid(p)
        constrs = gm_constrs(r, [x, t1], w)
    elif p > 1:
        abs_x, constrs = transform_expr(ex.abs_val(x))
        pf, w = _pow_high(p)
        constrs = constrs + gm_constrs(abs_x, [r, t1], w)
    else:
        raise TransformError(f"bad p {p}")
    constrs.append(ex.eq_constraint(ex.sum_entries(r), t))
    return t, constrs


def transform_norm_2_elementwise(e):
    t = _epi_var(e, "norm_2_elementwise")
    return t, [ex.soc_elemwise_constraint(t, *e.args)]


def transform_norm_nuc(e):
    X = e.args[0]
    m, n = X.size
    T = _epi_var(ex.constant(0.0, (m + n, m + n)), "norm_nuc")
    obj = ex.multiply(ex.scalar_constant(0.5), ex.trace(T))
    return obj, [
        ex.semidefinite(T),
        ex.eq_constraint(ex.index(T, 0, m, m, m + n), X)]


def transform_power(e):
    p = e.attr["p"]
    x = e.args[0]
    if p == 1:
        return x, []
    one = ex.constant(1.0, e.size) if e.dim > 1 else ex.scalar_constant(1.0)
    if p == 0:
        return one, []
    t = _epi_var(e, "power")
    if p < 0:
        pf, w = _pow_neg(p)
        constrs = gm_constrs(one, [x, t], w)
    elif 0 < p < 1:
        pf, w = _pow_mid(p)
        constrs = gm_constrs(t, [x, one], w)
    else:
        # p > 1: power(x, p) = |x|^p (cvxpy semantics) — the geo-mean
        # epigraph u <= gm(t, 1; w) is monotone in u, so it must bind on
        # |x|, not x (for negative x the one-sided constraint is vacuous
        # and the epigraph collapses to 0)
        pf, w = _pow_high(p)
        u = _epi_var(e, "power_abs")
        constrs = [ex.leq_constraint(x, u), ex.leq_constraint(ex.negate(x), u)]
        constrs += gm_constrs(u, [t, one], w)
    return t, constrs


def transform_square_root(e):
    # sqrt(x) = x^(1/2)
    return transform_power(Expression(ExprType.POWER, e.size, e.args, p=0.5))


def transform_huber(e):
    n = _epi_var(e, "huber_n")
    s = _epi_var(e, "huber_s")
    t, constr = transform_expr(
        ex.add(ex.power(n, 2),
               ex.multiply(ex.scalar_constant(2 * e.attr["M"]), ex.abs_val(s))))
    x = e.args[0]
    constr.append(ex.eq_constraint(x, ex.add(s, n)))
    return t, constr


def transform_geo_mean(e):
    w = [Fraction(x) for x in e.attr["w"]]
    t = _epi_var(e, "geo_mean")
    x = e.args[0]
    x_list = [ex.index(x, i, i + 1) for i in range(len(w))]
    return t, gm_constrs(t, x_list, tuple(w))


def transform_sum_largest(e):
    x = e.args[0]
    k = e.attr["k"]
    q = _epi_var(ex.scalar_constant(0.0), "sum_largest")
    t = _epi_var(x, "sum_largest_t")
    obj = ex.add(ex.sum_entries(t),
                 ex.multiply(ex.scalar_constant(float(k)), q))
    constr = [ex.leq_constraint(x, ex.add(t, q)),
              ex.leq_constraint(ex.scalar_constant(0.0), t)]
    return obj, constr


def transform_matrix_frac(e):
    x, P = e.args
    n = P.m
    M = _epi_var(ex.constant(0.0, (n + 1, n + 1)), "matrix_frac_M")
    t = _epi_var(ex.scalar_constant(0.0), "matrix_frac")
    return t, [
        ex.eq_constraint(ex.index(M, 0, n, 0, n), P),
        ex.eq_constraint(ex.index(M, 0, n, n, n + 1), x),
        ex.eq_constraint(ex.index(M, n, n + 1, n, n + 1), t),
        ex.semidefinite(M)]


def transform_exp(e):
    t = _epi_var(e, "exp")
    return t, [ex.leq_constraint(e, t)]


def transform_log(e):
    x = e.args[0]
    t = _epi_var(e, "log")
    return t, [ex.leq_constraint(ex.exp(t), x)]


def transform_entr(e):
    # entr(x) = -x log x >= t  <=>  kl_div-style: handled via exp cone in
    # general solvers; here: t <= entr(x) <=> x log(x) <= -t, use the
    # epigraph of neg-entropy elementwise via log: x log x - (-t) <= 0.
    # Reduce with: entr(x) >= t  <=>  log(x) >= t/x ... not conic-friendly;
    # use the standard exponential-cone-free bound via kl: not available.
    # Fall back: -entr is matched by the prox rules (SUM_NEG_ENTR); reaching
    # here means an unsupported composition.
    raise TransformError("entr composition not supported; use sum(entr(x))")


def transform_logistic(e):
    x = e.args[0]
    t = _epi_var(e, "logistic")
    # log(1+e^x) <= t  <=>  e^{-t} + e^{x-t} <= 1 — needs exp-cone pairs:
    # introduce u >= e^{-t}, v >= e^{x-t}, u + v <= 1.
    u = _epi_var(e, "logistic_u")
    v = _epi_var(e, "logistic_v")
    return t, [
        ex.leq_constraint(ex.exp(ex.negate(t)), u),
        ex.leq_constraint(ex.exp(ex.add(x, ex.negate(t))), v),
        ex.leq_constraint(ex.add(u, v), ex.constant(1.0, e.size)),
    ]


def transform_kl_div(e):
    raise TransformError("kl_div composition not supported; use sum form")


def transform_log_sum_exp(e):
    # log sum exp <= t <=> sum exp(x - t) <= 1, elementwise exp-cone pairs;
    # axis mode broadcasts t across the reduced axis and sums per slice
    # (lse(X, axis=1)_i <= t_i <=> sum_j exp(x_ij - t_i) <= 1)
    x = e.args[0]
    t = _epi_var(e, "log_sum_exp")
    m, n = x.size
    axis = e.attr.get("axis")
    s = _epi_var(x, "lse_s")
    if axis is None:
        shifted = ex.add(x, ex.negate(ex.multiply(ex.ones(m, n), t)))
        sum_s = ex.sum_entries(s)
        one = ex.scalar_constant(1.0)
    elif axis == 1:
        # t: (m, 1); broadcast along columns via t @ 1^T (1s row vector)
        shifted = ex.add(x, ex.negate(ex.multiply(t, ex.ones(1, n))))
        sum_s = ex.sum_entries(s, axis=1)
        one = ex.constant(1.0, (m, 1))
    else:
        # t: (1, n); broadcast along rows via 1 @ t
        shifted = ex.add(x, ex.negate(ex.multiply(ex.ones(m, 1), t)))
        sum_s = ex.sum_entries(s, axis=0)
        one = ex.constant(1.0, (1, n))
    return t, [
        ex.leq_constraint(ex.exp(shifted), s),
        ex.leq_constraint(sum_s, one),
    ]


def transform_indicator(e):
    return ex.scalar_constant(0.0), [e]


_TRANSFORMS = {
    ExprType.ABS: transform_abs,
    ExprType.MAX_ELEMENTWISE: transform_max_elementwise,
    ExprType.MIN_ELEMENTWISE: transform_min_elementwise,
    ExprType.MAX_ENTRIES: transform_max_entries,
    ExprType.MIN_ENTRIES: transform_min_entries,
    ExprType.LAMBDA_MAX: transform_lambda_max,
    ExprType.LAMBDA_MIN: transform_lambda_min,
    ExprType.SIGMA_MAX: transform_sigma_max,
    ExprType.QUAD_OVER_LIN: transform_quad_over_lin,
    ExprType.NORM_P: transform_norm_p,
    ExprType.NORM_2_ELEMENTWISE: transform_norm_2_elementwise,
    ExprType.NORM_NUC: transform_norm_nuc,
    ExprType.POWER: transform_power,
    ExprType.SQUARE_ROOT: transform_square_root,
    ExprType.HUBER: transform_huber,
    ExprType.GEO_MEAN: transform_geo_mean,
    ExprType.SUM_LARGEST: transform_sum_largest,
    ExprType.MATRIX_FRAC: transform_matrix_frac,
    ExprType.EXP: transform_exp,
    ExprType.LOG: transform_log,
    ExprType.ENTR: transform_entr,
    ExprType.LOGISTIC: transform_logistic,
    ExprType.KL_DIV: transform_kl_div,
    ExprType.LOG_SUM_EXP: transform_log_sum_exp,
    ExprType.INDICATOR: transform_indicator,
}


def transform_expr(e: Expression):
    """Bottom-up: replace every non-affine subtree with an epigraph variable
    (``conic.py:235-256``). Returns (affine objective expr, constraints)."""
    constrs = []
    new_args = []
    for a in e.args:
        obj_a, cs = transform_expr(a)
        new_args.append(obj_a)
        constrs += cs

    e_lin = Expression(e.expr_type, e.size, tuple(new_args), **e.attr)
    if not e_lin.dcp_props.affine:
        fn = _TRANSFORMS.get(e_lin.expr_type)
        if fn is None:
            raise TransformError(f"no conic transform for {e_lin.expr_type}")
        e_lin, cs = fn(e_lin)
        constrs += cs
    return e_lin, constrs
