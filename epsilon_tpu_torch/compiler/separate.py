"""Separation pass: analyze the sum-of-prox form and split shared variables.

Re-design of ``python/epopt/compiler/transforms/separate.py`` +
``problem_graph.py`` operating directly on the folded IR: a bipartite graph
between pending prox terms and variables, with three transforms
(``separate.py:126-130``):

1. move_equality_indicators — ZERO prox terms become solver constraints.
2. separate_objective_terms — variables shared by several objective terms
   (or entangled with non-prox-friendly constraints) get per-term copies
   linked by equality constraints.
3. add_constant_prox — constraint-only variables get a CONSTANT objective
   term so every variable appears in some prox x-update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..ir import (AffineOperator, Cone, ConeConstraint, ProxFunctionSpec,
                  ProxKind, ProxProblem, ProxTerm, arg_key)
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from .affine import AffineFold, fold_to_operator
from .prox_rules import PendingTerm

_LEAST_SQUARES_KINDS = (ProxKind.AFFINE, ProxKind.CONSTANT,
                        ProxKind.SUM_SQUARE, ProxKind.ZERO)


def _term_vars(t: PendingTerm) -> List[str]:
    out = []
    for f in t.args:
        for v in f.maps:
            if v not in out:
                out.append(v)
    return out


def _is_least_squares(t: PendingTerm) -> bool:
    return t.spec.kind in _LEAST_SQUARES_KINDS and not t.spec.epigraph


def _is_prox_friendly_constraint(t: PendingTerm, var: str) -> bool:
    """Constraint's map for var is scalar (``separate.py:50-52``)."""
    for f in t.args:
        M = f.maps.get(var)
        if M is not None and not (M.m == M.n and M.is_scalar):
            return False
    return True


def transform_problem(terms: List[PendingTerm],
                      var_dims: Dict[str, int],
                      var_shapes: Dict[str, Tuple[int, ...]]) -> ProxProblem:
    # 1. move ZERO-prox terms to constraints (keep if single function)
    objective = [t for t in terms if not (t.spec.kind == ProxKind.ZERO
                                          and not t.spec.epigraph)]
    constraints = [t for t in terms if t.spec.kind == ProxKind.ZERO
                   and not t.spec.epigraph]
    if not objective and constraints:
        # single-prox corner: keep one zero term as objective
        objective = [constraints.pop(0)]

    # 2. separate shared variables
    use_count: Dict[str, int] = {}
    for t in objective:
        for v in _term_vars(t):
            use_count[v] = use_count.get(v, 0) + 1

    copy_idx = 0
    for ti, t in enumerate(objective):
        for v in list(_term_vars(t)):
            shared = use_count.get(v, 0) > 1
            incompatible = False
            if not _is_least_squares(t):
                for c in constraints:
                    if v in _term_vars(c) and not _is_prox_friendly_constraint(c, v):
                        incompatible = True
                        break
            if not (shared or incompatible):
                continue
            new_v = f"separate:{v}:{ti}"
            copy_idx += 1
            n = var_dims[v]
            var_dims[new_v] = n
            var_shapes[new_v] = var_shapes.get(v, (n, 1))
            # re-key the variable column inside this term's folds
            for f in t.args:
                if v in f.maps:
                    f.maps[new_v] = f.maps.pop(v)
            # equality constraint new_v - v = 0
            constraints.append(PendingTerm(
                ProxFunctionSpec(kind=ProxKind.ZERO),
                [AffineFold({new_v: linop.identity(n),
                             v: linop.scalar(-1.0, n)}, np.zeros(n))]))
            use_count[v] -= 1
            use_count[new_v] = 1

    # 3. add constant prox for constraint-only variables
    obj_vars = {v for t in objective for v in _term_vars(t)}
    con_vars = {v for t in constraints for v in _term_vars(t)}
    for v in sorted(con_vars - obj_vars):
        n = var_dims[v]
        objective.append(PendingTerm(
            ProxFunctionSpec(kind=ProxKind.CONSTANT, arg_sizes=[(n, 1)]),
            [AffineFold({v: linop.identity(n)}, np.zeros(n))]))

    # materialize IR
    prox_terms = [
        ProxTerm(spec=t.spec,
                 H=fold_to_operator(t.args,
                                    [arg_key(i) for i in range(len(t.args))]))
        for t in objective]
    cone_constraints = [
        ConeConstraint(cone=Cone.ZERO,
                       op=fold_to_operator(t.args, ["c"] * 1))
        for t in constraints]

    used_vars = obj_vars | con_vars
    return ProxProblem(
        terms=prox_terms,
        constraints=cone_constraints,
        var_dims={v: var_dims[v] for v in sorted(used_vars)},
        var_shapes={v: var_shapes.get(v, (var_dims[v], 1))
                    for v in sorted(used_vars)})
