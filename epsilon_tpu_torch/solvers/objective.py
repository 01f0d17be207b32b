"""Objective evaluation for prox-affine problems (counterpart of
``epsilon_tpu/solvers/objective.py``)."""

from __future__ import annotations

import torch

from .. import config
from ..ir import ProxKind, ProxProblem, ProxTerm, arg_key
from ..ops.block import BlockVector
from ..ops.prox.registry import get_kernel


def _zero():
    return torch.zeros((), dtype=config.default_dtype(), device=config.device())


def term_objective(term: ProxTerm, x: BlockVector):
    """alpha * f(H(x)) for one prox term; indicators contribute 0."""
    spec = term.spec
    u = term.H.A.apply(x) + term.H.b.to_device()
    kind = spec.kind
    if kind == ProxKind.CONSTANT:
        # constant objective addend = alpha * offset
        total = _zero()
        for key, vec in term.H.b.to_device().items():
            total = total + torch.sum(vec)
        return spec.alpha * total
    if kind in (ProxKind.ZERO, ProxKind.NON_NEGATIVE,
                ProxKind.SEMIDEFINITE, ProxKind.SECOND_ORDER_CONE):
        return _zero()
    if spec.epigraph:
        # indicator I(f(x) <= t): 0 on the feasible set
        return _zero()
    if kind == ProxKind.AFFINE:
        total = _zero()
        for key in u.keys():
            total = total + torch.sum(u[key])
        return spec.alpha * total
    if kind == ProxKind.SUM_SQUARE:
        total = _zero()
        for key in u.keys():
            total = total + torch.sum(u[key] ** 2)
        return spec.alpha * total

    entry = get_kernel(kind)
    if entry.matrix or entry.nargs != 1 or spec.axis is not None:
        raise NotImplementedError(f"objective of {spec!r} is not yet ported")
    p = dict(spec.scaled_zone_params or {})
    if spec.k is not None:
        p["k"] = spec.k
    return spec.alpha * entry.feval(u.get(arg_key(0)), **p)


def problem_objective(problem: ProxProblem, x: BlockVector):
    total = _zero()
    for term in problem.terms:
        total = total + term_objective(term, x)
    return total
