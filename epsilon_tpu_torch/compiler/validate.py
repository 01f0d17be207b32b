"""Post-compilation invariants (``python/epopt/compiler/validate.py``)."""

from __future__ import annotations

from ..ir import Cone, ProxProblem


def check_problem(p: ProxProblem):
    assert p.terms, "compiled problem has no prox terms"
    for c in p.constraints:
        assert c.cone == Cone.ZERO, f"non-ZERO solver constraint: {c.cone}"
    for t in p.terms:
        for (r, v) in t.H.A.blocks:
            assert v in p.var_dims, f"unknown variable {v}"
