"""Graphviz export of expression trees (counterpart of
``epsilon_tpu/frontend/expression_vis.py``)."""

from __future__ import annotations

from .expression import Expression
from .tree_format import _node_label


def to_dot(e: Expression, name: str = "expression") -> str:
    lines = [f"digraph {name} {{", "  node [shape=box, fontsize=10];"]
    counter = [0]

    def visit(node) -> int:
        nid = counter[0]
        counter[0] += 1
        label = _node_label(node).replace('"', "'")
        lines.append(f'  n{nid} [label="{label}"];')
        for a in node.args:
            cid = visit(a)
            lines.append(f"  n{nid} -> n{cid};")
        return nid

    visit(e)
    lines.append("}")
    return "\n".join(lines)


def write_dot(e: Expression, path: str):
    with open(path, "w") as f:
        f.write(to_dot(e))
