"""S-expression dump of expression trees (counterpart of
``epsilon_tpu/frontend/list_format.py``).

Returns nested ``[name, params, [children...]]`` lists — the machine-friendly
counterpart of :mod:`tree_format` for structural snapshot tests and tooling.
"""

from __future__ import annotations

from typing import List

from .expression import Expression, ExprType, Problem

__all__ = ["name", "params", "expression", "format_problem"]


def name(e: Expression) -> str:
    return e.expr_type.value


def params(e: Expression) -> List:
    """Type-dependent scalar parameters (``list_format.py:6-27``)."""
    out: List = []
    if e.expr_type == ExprType.CONSTANT:
        if "value" in e.attr:
            out += ["shape", tuple(e.size)]
        elif "scalar" in e.attr:
            out += ["scalar", e.attr["scalar"]]
    elif e.expr_type == ExprType.VARIABLE:
        out += ["variable_id", e.attr.get("variable_id")]
    elif e.expr_type == ExprType.INDEX:
        for k in ("start", "stop", "step"):
            if k in e.attr:
                out += [k, e.attr[k]]
        if "key" in e.attr:
            out += ["key", e.attr["key"]]
    elif e.expr_type in (ExprType.POWER, ExprType.NORM_P):
        if "p" in e.attr:
            out += ["p", e.attr["p"]]
    elif e.expr_type == ExprType.SUM_LARGEST:
        if "k" in e.attr:
            out += ["k", e.attr["k"]]
    elif e.expr_type == ExprType.INDICATOR:
        if "cone" in e.attr:
            out += ["cone", str(e.attr["cone"])]
    return out


def expression(e: Expression) -> List:
    return [name(e), params(e), [expression(a) for a in e.args]]


def format_problem(problem: Problem) -> List:
    return ["problem", expression(problem.objective),
            [expression(c) for c in problem.constraints]]
