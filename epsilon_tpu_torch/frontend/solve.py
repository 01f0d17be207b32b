"""Top-level ``solve`` and ``eval_prox`` entry points.

Counterpart of ``epsilon_tpu/frontend/solve.py``: compile -> solve ->
write-back, with a compiled-problem cache for warm starts (a cached solver
takes new ``Parameter`` values through ``update_problem``) and a
single-prox fast path; ``eval_prox`` evaluates one proximal operator.
"""

from __future__ import annotations

import itertools
import logging
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from .. import config
from ..compiler import compiler, text_format
from ..ir import AffineOperator, ProxProblem
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from ..ops.prox.operator import create_prox_operator
from ..solvers import (ProxADMMSolver, SolverParams, SolverState, create_solver,
                       problem_objective)
from ..solvers.status import SolverStatus, Timing
from ..utils.timing import PROX_SPANS, span
from . import api
from . import expression as ex

logger = logging.getLogger("epsilon_tpu_torch")

# Compiled-problem cache for warm starts, keyed weakly by the live Problem
# (an id() key could alias a new Problem onto a dead one's solver).
_PROBLEM_CACHE: "weakref.WeakKeyDictionary[api.Problem, tuple]" = \
    weakref.WeakKeyDictionary()

# The process's solves, numbered in the root span's argument
_SOLVES = itertools.count()


def _has_parameters(problem: api.Problem) -> bool:
    found = [False]

    def visit(e):
        if e.attr.get("is_parameter"):
            found[0] = True
        for a in e.args:
            visit(a)

    visit(problem.objective.expr)
    for c in problem.constraints:
        visit(c)
    return found[0]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _set_solution(problem: api.Problem, values: BlockVector,
                  prox_problem: ProxProblem):
    var_objs: Dict[str, api.Variable] = {}
    api.expr_var_objects(problem.objective.expr, var_objs)
    for c in problem.constraints:
        api.expr_var_objects(c, var_objs)
    for vid, var in var_objs.items():
        if vid in values:
            var.value = linop.mat(_host(values[vid]), var.size)
        else:
            # variable eliminated (e.g. only in separated copies) — gather
            # from any copy
            for key in values.keys():
                if key.startswith(f"separate:{vid}:"):
                    var.value = linop.mat(_host(values[key]), var.size)
                    break


def solve(problem: api.Problem, verbose: bool = False, **kwargs) -> float:
    """Compile + solve; writes variable values; returns objective value."""
    with span("epsilon.solve", (next(_SOLVES),)):
        return _solve(problem, verbose, **kwargs)


def _compile(problem: api.Problem, params: SolverParams) -> ProxProblem:
    return compiler.compile_problem(problem.expression_problem(),
                                    use_epigraph=params.use_epigraph)


def _solve(problem: api.Problem, verbose: bool, **kwargs) -> float:
    params = SolverParams(**{**kwargs, "verbose": verbose})

    key = problem
    cached = _PROBLEM_CACHE.get(key) if params.warm_start else None
    if (cached is not None and params.mesh is not None
            and isinstance(cached[1], ProxADMMSolver)):
        # the N-block solver cannot take a process group: build anew
        # (create_solver rewrites it into the two-block solver)
        cached = None
    if cached is not None:
        prox_problem, solver = cached
        solver.params = params
        with span("epsilon.compile") as compiled:
            # Parameter values may have changed: fold the (identically
            # structured) problem again
            fresh = _compile(problem, params) if _has_parameters(problem) else None
        if fresh is not None:
            # hand its data to the cached solver, which keeps its warm
            # state (solver.update_problem)
            prox_problem = fresh
            solver.update_problem(prox_problem)
            _PROBLEM_CACHE[key] = (prox_problem, solver)
    else:
        with span("epsilon.compile") as compiled:
            prox_problem = _compile(problem, params)
        if len(prox_problem.terms) == 1 and not prox_problem.constraints:
            # single-prox fast path: one prox term and nothing to split on —
            # one prox evaluation at huge lambda IS the minimizer
            if verbose:
                logger.info("Epsilon compile time: %.4fs", compiled.ns / 1e9)
                logger.info("%s", text_format.format_problem(prox_problem))
            return _solve_single_prox(problem, prox_problem, compiled.usec)
        solver = create_solver(prox_problem, params)
        if params.warm_start:
            _PROBLEM_CACHE[key] = (prox_problem, solver)
    if verbose:
        logger.info("Epsilon compile time: %.4fs", compiled.ns / 1e9)
        logger.info("%s", text_format.format_problem(prox_problem))

    values = solver.solve()
    timing = solver.status.timing
    if verbose:
        logger.info("Epsilon solve time: %.4fs", timing.solve_usec / 1e6)

    with span("epsilon.write_back") as wrote:
        _set_solution(problem, values, prox_problem)
        # the solver's own evaluation: with a process group (mesh) each
        # rank evaluates the terms it owns and the sum is all-reduced
        objective = float(solver.objective_value(values))
    timing.compile_usec = compiled.usec
    timing.writeback_usec += wrote.usec
    timing.add_up()
    problem.solver_status = solver.status
    problem.status = ("optimal" if solver.status.state == SolverState.OPTIMAL
                      else "max_iterations")
    return objective


def _solve_single_prox(problem: api.Problem, prox_problem: ProxProblem,
                       compile_usec: int) -> float:
    """Minimize a lone prox term by one prox evaluation at huge lambda:
    prox_{lam*f}(0) -> argmin f with bias O(||x*||^2 / lam).  Lambda is
    dtype-aware — 1e12 in f64; in f32 1/sqrt(lam) underflows precision, so
    1e6."""
    term = prox_problem.terms[0]
    config.set_prox_inner_tol(None)
    dtype = config.default_dtype()
    lam = 1e12 if dtype == torch.float64 else 1e6
    inv_sqrt_lam = 1.0 / np.sqrt(lam)
    with span("epsilon.solver_setup") as setup:
        A = BlockMatrix()
        v = BlockVector()
        tvars = sorted({c for (_, c) in term.H.A.blocks})
        for i, vid in enumerate(tvars):
            n = prox_problem.var_dims[vid]
            A.insert(f"c{i}", vid, linop.scalar(inv_sqrt_lam, n))
            v[f"c{i}"] = torch.zeros(n, dtype=dtype, device=config.device())
        op = create_prox_operator(term.spec, term.H,
                                  AffineOperator(A, BlockVector()))
    with span(PROX_SPANS[term.spec.kind]) as applied:
        x = op.apply(v)

    with span("epsilon.write_back") as wrote:
        _set_solution(problem, x, prox_problem)
        objective = float(problem_objective(prox_problem, x))
    status = SolverStatus()
    status.state = SolverState.OPTIMAL
    status.num_iterations = 0
    status.timing = Timing(compile_usec=compile_usec, init_usec=setup.usec,
                           solve_usec=applied.usec, writeback_usec=wrote.usec)
    status.timing.add_up()
    problem.solver_status = status
    problem.status = "optimal"
    return objective


def eval_prox(f, v_map: Dict[api.Variable, np.ndarray], lam: float = 1.0,
              expected_kind=None, epigraph: Optional[bool] = None):
    """Evaluate a single proximal operator: for each variable x with value
    v, compute argmin lam*f(x) + 1/2 sum ||x - v||^2 on the configured
    device and write it back; returns ``{variable id: numpy array}``."""
    # standalone prox evaluations certify at full (dtype sqrt-precision)
    # accuracy, not whatever inner tol a previous solve left behind
    config.set_prox_inner_tol(None)

    problem = ex.Problem(objective=api._wrap(f), constraints=[])
    prox_problem = compiler.compile_problem(problem)
    if len(prox_problem.terms) != 1:
        raise ValueError(
            f"prox does not have a single term:\n"
            f"{text_format.format_problem(prox_problem)}")
    if prox_problem.constraints:
        raise ValueError("prox has constraints")
    term = prox_problem.terms[0]
    if expected_kind is not None and (
            term.spec.kind != expected_kind or
            (epigraph is not None and term.spec.epigraph != bool(epigraph))):
        raise ValueError(
            f"prox compiled to {term.spec.kind} (epigraph="
            f"{term.spec.epigraph}), expected {expected_kind}")

    inv_sqrt_lam = 1.0 / np.sqrt(lam)
    A = BlockMatrix()
    v = BlockVector()
    tvars = sorted({c for (_, c) in term.H.A.blocks})
    var_objs: Dict[str, api.Variable] = {}
    api.expr_var_objects(problem.objective, var_objs)
    for i, vid in enumerate(tvars):
        A.insert(f"c{i}", vid, linop.scalar(inv_sqrt_lam, prox_problem.var_dims[vid]))
    op = create_prox_operator(term.spec, term.H,
                              AffineOperator(A, BlockVector()))
    for i, vid in enumerate(tvars):
        var = var_objs.get(vid)
        if var is not None and var in v_map:
            val = linop.vec(np.asarray(v_map[var], dtype=float))
        else:
            val = np.zeros(prox_problem.var_dims[vid])
        v[f"c{i}"] = linop.to_tensor(inv_sqrt_lam * val)

    x = op.apply(v)
    out = {vid: _host(val) for vid, val in x.items()}
    for vid, var in var_objs.items():
        if vid in out:
            var.value = linop.mat(out[vid], var.size)
    return out
