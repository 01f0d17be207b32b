"""Objective evaluation for prox-affine problems (counterpart of
``epsilon_tpu/solvers/objective.py``)."""

from __future__ import annotations

import torch

from .. import config
from ..ir import ProxKind, ProxProblem, ProxTerm, arg_key
from ..ops import linop
from ..ops.block import BlockVector
from ..ops.prox.registry import get_kernel, kernel_params


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
    p = kernel_params(spec)
    val = u.get(arg_key(0))
    if entry.matrix:
        return spec.alpha * entry.feval(linop.jmat(val, tuple(spec.arg_sizes[0])), **p)
    if entry.nargs == 2:
        return spec.alpha * entry.feval((val, u.get(arg_key(1))), **p)
    if spec.axis is not None:
        # one value per slice (axis 0: per column), batched along the rows
        V = linop.jmat(val, tuple(spec.arg_sizes[0]))
        return spec.alpha * torch.sum(entry.feval(V.T if spec.axis == 0 else V, **p))
    return spec.alpha * entry.feval(val, **p)


def problem_objective(problem: ProxProblem, x: BlockVector):
    total = _zero()
    for term in problem.terms:
        total = total + term_objective(term, x)
    return total
