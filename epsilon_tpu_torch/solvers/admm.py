"""Two-block consensus ADMM on tensors.

Counterpart of ``ProxADMMTwoBlockSolver`` in ``epsilon_tpu/solvers/admm.py``
on one device with a fixed rho: the x-update applies every prox operator at
``z - u`` independently, the z-update projects onto the constraint set with
a cached block-Cholesky ZERO prox, and ``u += x - z``.  The JAX package's
device ``while_loop`` becomes a Python loop over epochs with one host sync
per epoch (the residual check), recording the same per-epoch residual
series.

Not yet ported: the N-block solver, term sharding and scenario stacking,
adaptive rho, over-relaxation, warm kernel state, stop callbacks and
checkpoints.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

import numpy as np
import torch

from .. import config
from ..ir import (AffineOperator, Cone, ProxFunctionSpec, ProxKind,
                  ProxProblem, constraint_key)
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from ..ops.prox.operator import create_prox_operator
from .objective import problem_objective
from .params import SolverParams
from .status import Residuals, SolverState, SolverStatus

logger = logging.getLogger("epsilon_tpu_torch")


def _zeros(dims: Dict[str, int]) -> BlockVector:
    dtype, dev = config.default_dtype(), config.device()
    return BlockVector({k: torch.zeros(n, dtype=dtype, device=dev)
                        for k, n in dims.items()})


def _rekey_constraint(i: int, affop: AffineOperator):
    """Re-key a constraint's affine operator rows onto constraint_key(i)
    (suffixing when the constraint has several row blocks)."""
    rows = sorted({r for (r, _) in affop.A.blocks} | set(affop.b.keys()))
    mapping = {}
    for j, r in enumerate(rows):
        mapping[r] = constraint_key(i) if len(rows) == 1 else f"{constraint_key(i)}:{j}"
    A = BlockMatrix({(mapping[r], c): op for (r, c), op in affop.A.blocks.items()})
    b = BlockVector({mapping[r]: v for r, v in affop.b.items()})
    return A, b


class ProxADMMTwoBlockSolver:
    """Two-block consensus ADMM."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        self.problem = problem
        self.params = params
        self.status = SolverStatus()
        self._warm_state = None
        t0 = time.time()
        self._init_rho = params.rho
        self.sqrt_rho = float(np.sqrt(params.rho))

        # Per-term prox operators with A = sqrt(rho)*I over term variables.
        self._build_term_ops(problem)

        # Constraint projection operator over the constraint variables.
        Hc = BlockMatrix()
        gc = BlockVector()
        self.z_dims: Dict[str, int] = {}
        for i, con in enumerate(problem.constraints):
            if con.cone != Cone.ZERO:
                raise ValueError(f"two-block ADMM supports ZERO cones only, "
                                 f"got {con.cone}")
            Ai, bi = _rekey_constraint(i, con.op)
            for (r, c), op in Ai.blocks.items():
                self.z_dims[c] = op.n
                Hc.insert(r, c, op)
            for r, vec in bi.items():
                gc[r] = vec
        Ac = BlockMatrix({(k, k): linop.scalar(self.sqrt_rho, n)
                          for k, n in self.z_dims.items()})
        self.constr_prox = None
        if self.z_dims:
            self.constr_prox = create_prox_operator(
                ProxFunctionSpec(kind=ProxKind.ZERO),
                AffineOperator(Hc, gc), AffineOperator(Ac, BlockVector()))
        self.m = sum(Hc.row_dim(r) for r in Hc.row_keys())
        self.n = sum(self.z_dims.values())

        self.all_dims: Dict[str, int] = dict(self.z_dims)
        for tvars in self.term_vars:
            for v in tvars:
                self.all_dims[v] = problem.var_dims[v]

        self._t_init = time.time() - t0

    def _build_term_ops(self, problem: ProxProblem):
        self.term_ops = []
        self.term_vars: List[List[str]] = []
        for term in problem.terms:
            tvars = sorted({c for (_, c) in term.H.A.blocks})
            A = BlockMatrix({(k, k): linop.scalar(self.sqrt_rho,
                                                  problem.var_dims[k])
                             for k in tvars})
            self.term_ops.append(create_prox_operator(
                term.spec, term.H, AffineOperator(A, BlockVector())))
            self.term_vars.append(tvars)

    def objective_value(self, x: BlockVector):
        return problem_objective(self.problem, x)

    # -- iteration ------------------------------------------------------------
    def _scaled(self, v: BlockVector) -> BlockVector:
        # sqrt(rho) = 1 scales exactly, so the multiply is skipped
        return v if self.sqrt_rho == 1.0 else self.sqrt_rho * v

    def _iter_body(self, state):
        z, u = state
        zu = z - u
        x = _zeros(self.all_dims)
        for op in self.term_ops:
            x = x + op.apply(self._scaled(zu))
        xu = x + u
        z_new = self._z_update(xu)
        u_new = u + x - z_new
        return (z_new, u_new), x

    def _z_update(self, xu):
        """Projection onto the constraint set."""
        if self.constr_prox is None:
            return xu
        zp = self.constr_prox.apply(self._scaled(xu))
        # variables untouched by constraints pass through unprojected
        return BlockVector({k: (zp[k] if k in zp else xu[k])
                            for k in self.all_dims})

    @staticmethod
    def _norm(bv: BlockVector):
        total = None
        for v in bv.data.values():
            total = torch.sum(v * v) if total is None else total + torch.sum(v * v)
        if total is None:
            total = torch.zeros((), dtype=config.default_dtype(), device=config.device())
        return torch.sqrt(total)

    def _residuals(self, state, x, z_prev):
        z, u = state
        rho = self.params.rho
        abs_tol, rel_tol = self.params.abs_tol, self.params.rel_tol
        sqrt_n = float(np.sqrt(max(self.n, 1)))
        r_norm = self._norm(x - z)
        s_norm = rho * self._norm(z - z_prev)
        eps_p = abs_tol * sqrt_n + rel_tol * torch.maximum(self._norm(x),
                                                           self._norm(z))
        eps_d = abs_tol * sqrt_n + rel_tol * rho * self._norm(u)
        return torch.stack([r_norm, s_norm, eps_p, eps_d])

    def _epoch(self, state):
        """``epoch_iterations`` sweeps, then the residuals.  The dual
        residual uses the final sweep's ``z - z_prev``, as the JAX package
        does."""
        for _ in range(self.params.epoch_iterations):
            z_prev = state[0]
            state, x = self._iter_body(state)
        return state, x, self._residuals(state, x, z_prev)

    def _init_state(self):
        if self.params.warm_start and self._warm_state is not None:
            return self._warm_state
        return (_zeros(self.all_dims), _zeros(self.all_dims))

    def _rebuild_for_rho(self):
        """A cached solver asked for another fixed rho: rebuild the
        operators (their metric is sqrt(rho)) and keep the warm dual
        lambda = rho * u."""
        old_warm, old_rho = self._warm_state, self._init_rho
        self.__init__(self.problem, self.params)
        if old_warm is not None:
            z, u = old_warm
            self._warm_state = (z, (old_rho / self._init_rho) * u)

    def solve(self) -> BlockVector:
        t0 = time.time()
        if self.params.rho != self._init_rho:
            self._rebuild_for_rho()
        state = self._init_state()
        epoch_iters = self.params.epoch_iterations
        max_iters = max(1, self.params.max_iterations // epoch_iters) * epoch_iters
        iters = 0
        series: List[Residuals] = []
        while True:
            state, x, res = self._epoch(state)
            iters += epoch_iters
            r = Residuals(*res.tolist())   # the epoch's one host sync
            series.append(r)
            conv = r.r_norm <= r.epsilon_primal and r.s_norm <= r.epsilon_dual
            if self.params.verbose and (iters % self.params.log_iterations
                                        < epoch_iters):
                self.status.num_iterations = iters
                self.status.residuals = r
                logger.info(self.status.log_line())
            if conv or iters >= max_iters:
                break
        self.status.series = series
        self._finish(state, iters, r, conv, self._t_init, time.time() - t0)
        return x

    def _finish(self, state, iters, res, converged, t_init, t_solve):
        self.status.num_iterations = int(iters)
        self.status.residuals = res
        self.status.state = (SolverState.OPTIMAL if bool(converged)
                             else SolverState.MAX_ITERATIONS_REACHED)
        self.status.timing.init_usec = int(t_init * 1e6)
        self.status.timing.solve_usec = int(t_solve * 1e6)
        self.status.timing.total_usec = int((t_init + t_solve) * 1e6)
        if self.params.warm_start:
            self._warm_state = state
        if self.params.verbose:
            logger.info(self.status.log_line())


def create_solver(problem: ProxProblem, params: SolverParams):
    """The two-block solver; :class:`SolverParams` rejects the solver kinds
    not yet ported."""
    return ProxADMMTwoBlockSolver(problem, params)
