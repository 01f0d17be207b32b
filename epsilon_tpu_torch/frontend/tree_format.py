"""Typed tree dump of expressions (counterpart of
``epsilon_tpu/frontend/tree_format.py``)."""

from __future__ import annotations

from .expression import Expression, ExprType


def _node_label(e: Expression) -> str:
    bits = [e.expr_type.value, f"{e.m}x{e.n}"]
    if e.expr_type == ExprType.VARIABLE:
        bits.append(e.attr["variable_id"])
    if e.expr_type == ExprType.CONSTANT:
        if "scalar" in e.attr:
            bits.append(f"scalar={e.attr['scalar']:g}")
        else:
            bits.append("data")
    if "p" in e.attr:
        bits.append(f"p={e.attr['p']:g}")
    if "k" in e.attr:
        bits.append(f"k={e.attr['k']}")
    if "cone" in e.attr:
        bits.append(e.attr["cone"].value)
    if e.attr.get("axis") is not None:
        bits.append(f"axis={e.attr['axis']}")
    return " ".join(bits)


def format_expr(e: Expression, indent: int = 0) -> str:
    lines = ["  " * indent + _node_label(e)]
    for a in e.args:
        lines.append(format_expr(a, indent + 1))
    return "\n".join(lines)


def format_problem(problem) -> str:
    out = ["objective:", format_expr(problem.objective, 1)]
    if problem.constraints:
        out.append("constraints:")
        out += [format_expr(c, 1) for c in problem.constraints]
    return "\n".join(out)


def list_format(e: Expression):
    """Flat list of (depth, label) pairs (``list_format.py`` equivalent)."""
    out = []

    def visit(node, depth):
        out.append((depth, _node_label(node)))
        for a in node.args:
            visit(a, depth + 1)

    visit(e, 0)
    return out
