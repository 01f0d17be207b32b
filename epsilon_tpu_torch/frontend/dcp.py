"""Self-contained DCP attribute engine.

The reference delegates curvature/sign/monotonicity to cvxpy 0.3 internals
(``python/epopt/dcp.py:30-73``); cvxpy is not a dependency here, so this is a
standalone implementation of the standard DCP composition rules over the
node types of :mod:`.expression`.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .expression import Expression, ExprType


class Curvature(enum.Enum):
    CONSTANT = "constant"
    AFFINE = "affine"
    CONVEX = "convex"
    CONCAVE = "concave"
    UNKNOWN = "unknown"


class Sign(enum.Enum):
    POSITIVE = "positive"   # >= 0
    NEGATIVE = "negative"   # <= 0
    ZERO = "zero"
    UNKNOWN = "unknown"


class Monotonicity(enum.Enum):
    INCREASING = "increasing"
    DECREASING = "decreasing"
    SIGNED = "signed"        # increasing for positive arg, decreasing for neg
    NONMONOTONIC = "nonmonotonic"


@dataclasses.dataclass
class DcpProps:
    curvature: Curvature
    sign: Sign

    @property
    def constant(self):
        return self.curvature == Curvature.CONSTANT

    @property
    def affine(self):
        return self.curvature in (Curvature.CONSTANT, Curvature.AFFINE)

    @property
    def convex(self):
        return self.affine or self.curvature == Curvature.CONVEX

    @property
    def concave(self):
        return self.affine or self.curvature == Curvature.CONCAVE


def _sign_of_constant(e: Expression) -> Sign:
    if "scalar" in e.attr:
        v = e.attr["scalar"]
        if v > 0:
            return Sign.POSITIVE
        if v < 0:
            return Sign.NEGATIVE
        return Sign.ZERO
    val = e.attr.get("value")
    if val is None:
        return Sign.UNKNOWN
    try:
        import scipy.sparse as sp
        arr = val.toarray() if sp.issparse(val) else np.asarray(val)
    except Exception:
        return Sign.UNKNOWN
    if np.all(arr >= 0):
        return Sign.POSITIVE if np.any(arr > 0) else Sign.ZERO
    if np.all(arr <= 0):
        return Sign.NEGATIVE
    return Sign.UNKNOWN


def _neg_sign(s: Sign) -> Sign:
    return {Sign.POSITIVE: Sign.NEGATIVE, Sign.NEGATIVE: Sign.POSITIVE,
            Sign.ZERO: Sign.ZERO, Sign.UNKNOWN: Sign.UNKNOWN}[s]


def _add_signs(signs):
    if all(s == Sign.ZERO for s in signs):
        return Sign.ZERO
    if all(s in (Sign.POSITIVE, Sign.ZERO) for s in signs):
        return Sign.POSITIVE
    if all(s in (Sign.NEGATIVE, Sign.ZERO) for s in signs):
        return Sign.NEGATIVE
    return Sign.UNKNOWN


def _mul_signs(a: Sign, b: Sign) -> Sign:
    if Sign.ZERO in (a, b):
        return Sign.ZERO
    if Sign.UNKNOWN in (a, b):
        return Sign.UNKNOWN
    return Sign.POSITIVE if a == b else Sign.NEGATIVE


def _neg_curv(c: Curvature) -> Curvature:
    return {Curvature.CONVEX: Curvature.CONCAVE,
            Curvature.CONCAVE: Curvature.CONVEX}.get(c, c)


# Atom table: node type -> (curvature, sign, per-arg monotonicity or single
# monotonicity applied to every arg).
_AFFINE_TYPES = {
    ExprType.ADD, ExprType.NEGATE, ExprType.INDEX, ExprType.RESHAPE,
    ExprType.SUM, ExprType.TRACE, ExprType.TRANSPOSE, ExprType.HSTACK,
    ExprType.VSTACK, ExprType.DIAG_MAT, ExprType.DIAG_VEC, ExprType.KRON,
    ExprType.UPPER_TRI, ExprType.MULTIPLY, ExprType.MULTIPLY_ELEMENTWISE,
}

_ATOMS = {
    ExprType.ABS: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.SIGNED),
    ExprType.SQUARE_ROOT: (Curvature.CONCAVE, Sign.POSITIVE, Monotonicity.INCREASING),
    ExprType.LOG: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.EXP: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.INCREASING),
    ExprType.HUBER: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.SIGNED),
    ExprType.ENTR: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.NONMONOTONIC),
    ExprType.LOGISTIC: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.INCREASING),
    ExprType.KL_DIV: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.NONMONOTONIC),
    ExprType.NORM_P: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.SIGNED),
    ExprType.LOG_SUM_EXP: (Curvature.CONVEX, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.MAX_ENTRIES: (Curvature.CONVEX, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.MIN_ENTRIES: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.MAX_ELEMENTWISE: (Curvature.CONVEX, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.MIN_ELEMENTWISE: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.SUM_LARGEST: (Curvature.CONVEX, Sign.UNKNOWN, Monotonicity.INCREASING),
    ExprType.GEO_MEAN: (Curvature.CONCAVE, Sign.POSITIVE, Monotonicity.INCREASING),
    ExprType.NORM_NUC: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.NONMONOTONIC),
    ExprType.LAMBDA_MAX: (Curvature.CONVEX, Sign.UNKNOWN, Monotonicity.NONMONOTONIC),
    ExprType.LAMBDA_MIN: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.NONMONOTONIC),
    ExprType.LOG_DET: (Curvature.CONCAVE, Sign.UNKNOWN, Monotonicity.NONMONOTONIC),
    ExprType.SIGMA_MAX: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.NONMONOTONIC),
    ExprType.MATRIX_FRAC: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.NONMONOTONIC),
    ExprType.NORM_2_ELEMENTWISE: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.SIGNED),
    ExprType.SCALED_ZONE: (Curvature.CONVEX, Sign.POSITIVE, Monotonicity.SIGNED),
}


def _compose(f_curv: Curvature, mono: Monotonicity, arg: DcpProps) -> Curvature:
    """Standard DCP composition for one argument."""
    if arg.constant:
        return Curvature.CONSTANT
    if arg.affine:
        return f_curv
    if mono == Monotonicity.INCREASING:
        ok = (f_curv == Curvature.CONVEX and arg.convex) or \
             (f_curv == Curvature.CONCAVE and arg.concave)
    elif mono == Monotonicity.DECREASING:
        ok = (f_curv == Curvature.CONVEX and arg.concave) or \
             (f_curv == Curvature.CONCAVE and arg.convex)
    elif mono == Monotonicity.SIGNED:
        # increasing for nonnegative args, decreasing for nonpositive
        if arg.sign == Sign.POSITIVE or arg.sign == Sign.ZERO:
            return _compose(f_curv, Monotonicity.INCREASING, arg)
        if arg.sign == Sign.NEGATIVE:
            return _compose(f_curv, Monotonicity.DECREASING, arg)
        ok = False
    else:
        ok = False
    return f_curv if ok else Curvature.UNKNOWN


def _combine(curvs) -> Curvature:
    out = Curvature.CONSTANT
    order = {Curvature.CONSTANT: 0, Curvature.AFFINE: 1}
    for c in curvs:
        if c == Curvature.UNKNOWN:
            return Curvature.UNKNOWN
        if c in order and out in order:
            out = c if order.get(c, 9) > order.get(out, 9) else out
        elif c in (Curvature.CONVEX, Curvature.CONCAVE):
            if out in (Curvature.CONSTANT, Curvature.AFFINE) or out == c:
                out = c
            else:
                return Curvature.UNKNOWN
    return out


def compute_dcp_properties(e: Expression) -> DcpProps:
    t = e.expr_type
    arg_props = [a.dcp_props for a in e.args]

    if t == ExprType.CONSTANT:
        return DcpProps(Curvature.CONSTANT, _sign_of_constant(e))
    if t == ExprType.VARIABLE:
        if e.attr.get("is_parameter"):
            # Parameters are compile-time constants (re-folded on update)
            return DcpProps(Curvature.CONSTANT, Sign.UNKNOWN)
        return DcpProps(Curvature.AFFINE, Sign.UNKNOWN)
    if t == ExprType.PROX_FUNCTION:
        return DcpProps(Curvature.CONVEX, Sign.UNKNOWN)
    if t == ExprType.INDICATOR:
        return DcpProps(Curvature.CONVEX, Sign.POSITIVE)

    if t == ExprType.NEGATE:
        p = arg_props[0]
        return DcpProps(_neg_curv(p.curvature), _neg_sign(p.sign))

    if t == ExprType.MULTIPLY or t == ExprType.MULTIPLY_ELEMENTWISE:
        a, b = arg_props
        sign = _mul_signs(a.sign, b.sign)
        if a.constant and b.constant:
            return DcpProps(Curvature.CONSTANT, sign)
        if a.constant:
            c_sign, x = a.sign, b
        elif b.constant:
            c_sign, x = b.sign, a
        else:
            return DcpProps(Curvature.UNKNOWN, sign)
        if x.affine:
            curv = Curvature.AFFINE
        elif c_sign == Sign.POSITIVE:
            curv = x.curvature
        elif c_sign == Sign.NEGATIVE:
            curv = _neg_curv(x.curvature)
        elif c_sign == Sign.ZERO:
            curv = Curvature.CONSTANT
        else:
            curv = Curvature.UNKNOWN
        return DcpProps(curv, sign)

    if t in _AFFINE_TYPES:
        # affine structural ops: curvature = combination, sign propagated
        curv = _combine([p.curvature for p in arg_props])
        sign = (_add_signs([p.sign for p in arg_props])
                if t == ExprType.ADD else
                arg_props[0].sign if len(arg_props) == 1 else Sign.UNKNOWN)
        return DcpProps(curv, sign)

    if t == ExprType.POWER:
        p = e.attr["p"]
        arg = arg_props[0]
        if arg.constant:
            return DcpProps(Curvature.CONSTANT, Sign.POSITIVE)
        if p == 1.0:
            return DcpProps(arg.curvature, arg.sign)
        if p == 0.0:
            return DcpProps(Curvature.CONSTANT, Sign.POSITIVE)
        if p >= 1.0:
            mono = Monotonicity.SIGNED if float(p) == int(p) and int(p) % 2 == 0 \
                else Monotonicity.INCREASING
            # even powers are signed; odd/fractional p >= 1 convex increasing
            # on the restricted domain
            if float(p) == int(p) and int(p) % 2 == 0:
                mono = Monotonicity.SIGNED
            return DcpProps(_compose(Curvature.CONVEX, mono, arg), Sign.POSITIVE)
        if 0 < p < 1:
            return DcpProps(_compose(Curvature.CONCAVE, Monotonicity.INCREASING, arg),
                            Sign.POSITIVE)
        # p < 0: convex decreasing on x > 0
        return DcpProps(_compose(Curvature.CONVEX, Monotonicity.DECREASING, arg),
                        Sign.POSITIVE)

    if t == ExprType.QUAD_OVER_LIN:
        x, y = arg_props
        cx = _compose(Curvature.CONVEX, Monotonicity.SIGNED, x)
        cy = _compose(Curvature.CONVEX, Monotonicity.DECREASING, y)
        curv = Curvature.UNKNOWN
        if cx == Curvature.CONVEX or x.affine or x.constant:
            if cy == Curvature.CONVEX or y.affine or y.constant:
                curv = Curvature.CONVEX
        if x.constant and y.constant:
            curv = Curvature.CONSTANT
        return DcpProps(curv, Sign.POSITIVE)

    if t in _ATOMS:
        f_curv, f_sign, mono = _ATOMS[t]
        if all(p.constant for p in arg_props):
            return DcpProps(Curvature.CONSTANT, f_sign)
        curvs = [_compose(f_curv, mono, p) for p in arg_props]
        if any(c == Curvature.UNKNOWN for c in curvs):
            return DcpProps(Curvature.UNKNOWN, f_sign)
        return DcpProps(f_curv, f_sign)

    raise ValueError(f"no DCP rule for {t}")
