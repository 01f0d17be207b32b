"""Human-readable formatting of compiled problems.

Equivalent of ``python/epopt/text_format.py``: renders the prox-affine form,
e.g. lasso compiles to
``sum_square(dense(A)*x + b) + norm_1(y)  s.t.  zero(x - y)``
(``docs/index.rst:70-80``).
"""

from __future__ import annotations

from ..ir import ProxProblem, ProxTerm
from ..ops import linop


def _op_str(M) -> str:
    if isinstance(M, linop.ScalarOp):
        if M.alpha == 1.0:
            return ""
        if M.alpha == -1.0:
            return "-"
        return f"{M.alpha:g}*"
    if isinstance(M, linop.DiagonalOp):
        return "diag(d)*"
    if isinstance(M, linop.DenseOp):
        return f"dense[{M.m}x{M.n}]*"
    if isinstance(M, linop.SparseOp):
        return f"sparse[{M.m}x{M.n}]*"
    if isinstance(M, linop.KronOp):
        return "kron*"
    return f"{type(M).__name__}*"


def format_term(t: ProxTerm) -> str:
    args = []
    by_row = {}
    for (r, v), M in sorted(t.H.A.blocks.items()):
        by_row.setdefault(r, []).append(f"{_op_str(M)}{v}")
    for r in sorted(by_row):
        expr = " + ".join(by_row[r])
        if r in t.H.b.data:
            expr += " + b"
        args.append(expr)
    name = t.spec.kind.value
    if t.spec.epigraph:
        name += "_epigraph"
    prefix = "" if t.spec.alpha == 1.0 else f"{t.spec.alpha:g}*"
    return f"{prefix}{name}({', '.join(args)})"


def format_problem(p: ProxProblem) -> str:
    lines = ["objective:"]
    lines += [f"  {format_term(t)}" for t in p.terms]
    if p.constraints:
        lines.append("constraints:")
        for c in p.constraints:
            by_var = []
            for (r, v), M in sorted(c.op.A.blocks.items()):
                by_var.append(f"{_op_str(M)}{v}")
            expr = " + ".join(by_var)
            if c.op.b.data:
                expr += " + b"
            lines.append(f"  zero({expr})")
    return "\n".join(lines)
