"""Top-level ``solve`` entry point.

Counterpart of ``solve`` in ``epsilon_tpu/frontend/solve.py``: compile ->
solve -> write-back, with a compiled-problem cache for warm starts and a
single-prox fast path.
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Dict

import numpy as np
import torch

from .. import config
from ..compiler import compiler, text_format
from ..ir import AffineOperator, ProxProblem
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from ..ops.prox.operator import create_prox_operator
from ..solvers import SolverParams, SolverState, create_solver, problem_objective
from ..solvers.status import SolverStatus
from . import api

logger = logging.getLogger("epsilon_tpu_torch")

# Compiled-problem cache for warm starts, keyed weakly by the live Problem
# (an id() key could alias a new Problem onto a dead one's solver).
_PROBLEM_CACHE: "weakref.WeakKeyDictionary[api.Problem, tuple]" = \
    weakref.WeakKeyDictionary()


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
    params = SolverParams(**{**kwargs, "verbose": verbose})

    t0 = time.time()
    key = problem
    cached = _PROBLEM_CACHE.get(key) if params.warm_start else None
    if cached is not None:
        prox_problem, solver = cached
        if _has_parameters(problem):
            raise NotImplementedError(
                "re-solving a warm-started problem with Parameters "
                "(solver.update_problem) is not yet ported")
        solver.params = params
    else:
        prox_problem = compiler.compile_problem(
            problem.expression_problem(), use_epigraph=params.use_epigraph)
        if len(prox_problem.terms) == 1 and not prox_problem.constraints:
            # single-prox fast path: one prox term and nothing to split on —
            # one prox evaluation at huge lambda IS the minimizer
            if verbose:
                logger.info("Epsilon compile time: %.4fs", time.time() - t0)
                logger.info("%s", text_format.format_problem(prox_problem))
            return _solve_single_prox(problem, prox_problem)
        solver = create_solver(prox_problem, params)
        if params.warm_start:
            _PROBLEM_CACHE[key] = (prox_problem, solver)
    compile_time = time.time() - t0
    if verbose:
        logger.info("Epsilon compile time: %.4fs", compile_time)
        logger.info("%s", text_format.format_problem(prox_problem))

    t0 = time.time()
    values = solver.solve()
    solve_time = time.time() - t0
    if verbose:
        logger.info("Epsilon solve time: %.4fs", solve_time)

    _set_solution(problem, values, prox_problem)
    problem.solver_status = solver.status
    problem.status = ("optimal" if solver.status.state == SolverState.OPTIMAL
                      else "max_iterations")
    return float(problem_objective(prox_problem, values))


def _solve_single_prox(problem: api.Problem,
                       prox_problem: ProxProblem) -> float:
    """Minimize a lone prox term by one prox evaluation at huge lambda:
    prox_{lam*f}(0) -> argmin f with bias O(||x*||^2 / lam).  Lambda is
    dtype-aware — 1e12 in f64; in f32 1/sqrt(lam) underflows precision, so
    1e6."""
    term = prox_problem.terms[0]
    dtype = config.default_dtype()
    lam = 1e12 if dtype == torch.float64 else 1e6
    inv_sqrt_lam = 1.0 / np.sqrt(lam)
    t0 = time.time()
    A = BlockMatrix()
    v = BlockVector()
    tvars = sorted({c for (_, c) in term.H.A.blocks})
    for i, vid in enumerate(tvars):
        n = prox_problem.var_dims[vid]
        A.insert(f"c{i}", vid, linop.scalar(inv_sqrt_lam, n))
        v[f"c{i}"] = torch.zeros(n, dtype=dtype, device=config.device())
    op = create_prox_operator(term.spec, term.H,
                              AffineOperator(A, BlockVector()))
    x = op.apply(v)

    _set_solution(problem, x, prox_problem)
    status = SolverStatus()
    status.state = SolverState.OPTIMAL
    status.num_iterations = 0
    status.timing.solve_usec = int((time.time() - t0) * 1e6)
    status.timing.total_usec = status.timing.solve_usec
    problem.solver_status = status
    problem.status = "optimal"
    return float(problem_objective(prox_problem, x))
