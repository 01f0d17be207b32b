"""Compiler entry point: expression Problem -> prox-affine ProxProblem.

Pass order mirrors ``python/epopt/compiler/compiler.py:12-29``:
prox (pattern match) -> separate (variable splitting).  The linear
canonicalization runs inline during prox matching (folding straight into
structured operators, see :mod:`.affine`).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..frontend import expression as ex
from ..ir import ProxProblem
from . import prox_rules, separate, validate


def _collect_var_dims(problem: ex.Problem):
    dims: Dict[str, int] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}

    def visit(e):
        if e.expr_type == ex.ExprType.VARIABLE:
            vid = e.attr["variable_id"]
            dims[vid] = e.dim
            shapes[vid] = e.size
        for a in e.args:
            visit(a)

    visit(problem.objective)
    for c in problem.constraints:
        visit(c)
    return dims, shapes


def compile_problem(problem: ex.Problem, use_epigraph: bool = True
                    ) -> ProxProblem:
    # deterministic epigraph-variable naming per compile: identical problem
    # structure always compiles to identical variable ids (required for
    # no-recompile Parameter updates)
    import itertools
    prox_rules._EPI_COUNTER = itertools.count()
    var_dims, var_shapes = _collect_var_dims(problem)
    terms = prox_rules.transform_problem(problem, use_epigraph=use_epigraph)
    # epigraph/copy variables introduced during matching
    for t in terms:
        for f in t.args:
            for v, M in f.maps.items():
                var_dims.setdefault(v, M.n)
                var_shapes.setdefault(v, (M.n, 1))
    prox_problem = separate.transform_problem(terms, var_dims, var_shapes)
    validate.check_problem(prox_problem)
    return prox_problem
