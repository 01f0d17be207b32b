"""ADMM operator-splitting solvers on tensors.

Counterpart of ``epsilon_tpu/solvers/admm.py`` on one device:

- :class:`ProxADMMTwoBlockSolver` — two-block consensus ADMM: the x-update
  applies every prox operator at ``z - u`` independently, the z-update
  projects onto the constraint set with a cached block-Cholesky ZERO prox,
  and ``u += x - z``; with over-relaxation, and with residual-balancing
  adaptive rho (rho a 0-d tensor in the loop state, rho-parameterized prox
  operators, the balancing step computed on the device).  Warm-startable
  kernels (TV-1D PDAS duals) carry their state through the loop.
- :class:`ProxADMMSolver` — N-block Gauss-Seidel ADMM: a sequential sweep
  over the terms in the constraint-row space.

The JAX package's device ``while_loop`` and its host epoch loop are one
Python loop over epochs here, with one host sync per epoch (the residual
check) and the same per-epoch residual series; ``SolverParams.drive`` says
where the two values still differ.  Both solvers take stop callbacks and a
checkpointer, rebuild themselves in place when a cached solver is asked for
another rho or mode (keeping the warm state where that is well defined),
and take new problem data of the same structure (:meth:`update_problem`).

Not yet ported: term sharding over a mesh and scenario stacking.
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
from ..ops.prox.operator import create_prox_operator, create_rho_prox_operator
from .objective import problem_objective
from .params import SolverKind, SolverParams
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


def _term_vars(term) -> List[str]:
    return sorted({c for (_, c) in term.H.A.blocks})


# -- has the data of an operator changed? (update_problem) -------------------

def _same_linop(a, b) -> bool:
    if type(a) is not type(b) or tuple(a.shape) != tuple(b.shape):
        return False
    if isinstance(a, linop.ScalarOp):
        return a.alpha == b.alpha
    if isinstance(a, linop.DiagonalOp):
        return np.array_equal(a.d, b.d)
    if isinstance(a, linop.DenseOp):
        return np.array_equal(a.A, b.A)
    if isinstance(a, linop.SparseOp):
        return (a.A != b.A).nnz == 0
    if isinstance(a, linop.KronOp):
        return _same_linop(a.A, b.A) and _same_linop(a.B, b.B)
    return False


def _same_affine(a: AffineOperator, b: AffineOperator) -> bool:
    if a.A.blocks.keys() != b.A.blocks.keys() or a.b.keys() != b.b.keys():
        return False
    return (all(_same_linop(op, b.A.blocks[k]) for k, op in a.A.blocks.items())
            and all(np.array_equal(np.asarray(v), np.asarray(b.b[k]))
                    for k, v in a.b.items()))


def _same_spec(a: ProxFunctionSpec, b: ProxFunctionSpec) -> bool:
    pa, pb = a.scaled_zone_params or {}, b.scaled_zone_params or {}
    return ((a.kind, a.epigraph, a.alpha, a.k, a.axis, list(a.arg_sizes))
            == (b.kind, b.epigraph, b.alpha, b.k, b.axis, list(b.arg_sizes))
            and pa.keys() == pb.keys()
            and all(np.array_equal(v, pb[k]) for k, v in pa.items()))


def _same_constraints(p: ProxProblem, q: ProxProblem) -> bool:
    return (len(p.constraints) == len(q.constraints)
            and all(c.cone == d.cone and _same_affine(c.op, d.op)
                    for c, d in zip(p.constraints, q.constraints)))


class SolverBase:
    """Status plumbing, hooks and the epoch loop shared by both solvers."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        self.problem = problem
        self.params = params
        self.status = SolverStatus()
        self._warm_state = None
        self._stop_callbacks = []
        self._checkpointer = None

    def register_stop_callback(self, cb):
        """External cancellation hook: checked between epochs under
        ``drive="host"``."""
        self._stop_callbacks.append(cb)

    def attach_checkpointer(self, ckpt):
        """Durable checkpoints of the loop state (see
        :class:`epsilon_tpu_torch.utils.checkpoint.SolverCheckpointer`).
        ``drive="host"`` saves every ``ckpt.every_epochs`` epochs and resumes
        from the latest checkpoint; ``drive="device"`` resumes at the start
        and saves once at the end."""
        self._checkpointer = ckpt

    def _resume_state(self, state):
        """(state, start_iters) from the latest checkpoint, if any."""
        if self._checkpointer is None:
            return state, 0
        restored, step = self._checkpointer.restore(state)
        if restored is None:
            return state, 0
        logger.info("resuming from checkpoint at iteration %d", step)
        return restored, step

    def _has_external_stop(self) -> bool:
        return any(cb() for cb in self._stop_callbacks)

    def _rebuild_full(self):
        """Reconstruct the solver in place for a changed mode (adaptive_rho
        flip) or fixed rho, keeping the hooks the caller attached, which
        ``__init__`` would reset, and carrying the warm-start state over to
        the new parameterization where that is well defined."""
        saved_cbs = self._stop_callbacks
        saved_ckpt = self._checkpointer
        old_warm = self._warm_state
        old_rho = getattr(self, "_init_rho", None)
        old_adaptive = getattr(self, "adaptive", None)
        self.__init__(self.problem, self.params)
        self._stop_callbacks = saved_cbs
        self._checkpointer = saved_ckpt
        self._warm_state = self._migrate_warm_state(old_warm, old_rho,
                                                    old_adaptive)

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        """Map a previous solve's warm state onto the rebuilt solver's
        parameterization; ``None`` when no valid mapping exists."""
        return None

    def objective_value(self, x: BlockVector):
        return problem_objective(self.problem, x)

    def _rebuild_operators(self, problem: ProxProblem, old: ProxProblem):
        raise NotImplementedError

    def update_problem(self, problem: ProxProblem):
        """Swap in a problem with identical *structure* but new data
        (Parameter updates).  The port has no compiled program whose
        constants would be refreshed: the operators that hold changed data
        are rebuilt, on the objective side and on the constraint side, and
        the warm state is kept."""
        old = self.problem
        self.problem = problem
        self._rebuild_operators(problem, old)

    # -- the epoch loop ------------------------------------------------------
    def _run(self, state):
        """Epochs until convergence, the iteration budget or (host drive)
        an external stop; returns ``(state, out, iterations, residuals,
        converged)`` with ``out`` the last epoch's primal output.  ``drive="host"`` tests the budget against
        ``max_iterations`` itself and ``"device"`` against its multiple of
        ``epoch_iterations``, as the JAX package's two loops do; iterations
        restored from a checkpoint are debited from either."""
        p = self.params
        host = p.drive == "host"
        epoch_iters = p.epoch_iterations
        limit = (p.max_iterations if host
                 else max(1, p.max_iterations // epoch_iters) * epoch_iters)
        state, iters = self._resume_state(state)
        series: List[Residuals] = []
        while True:
            state, out, res = self._epoch(state)
            iters += epoch_iters
            r = Residuals(*res.tolist())   # the epoch's one host sync
            series.append(r)
            conv = r.r_norm <= r.epsilon_primal and r.s_norm <= r.epsilon_dual
            if host and self._checkpointer is not None:
                self._checkpointer.maybe_save(iters, state)
            if p.verbose and (iters % p.log_iterations < epoch_iters):
                self.status.num_iterations = iters
                self.status.residuals = r
                logger.info(self.status.log_line())
            if conv or iters >= limit or (host and self._has_external_stop()):
                break
        if not host and self._checkpointer is not None:
            self._checkpointer.save(iters, state)
        self.status.series = series
        return state, out, iters, r, conv

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


class ProxADMMTwoBlockSolver(SolverBase):
    """Two-block consensus ADMM."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        t0 = time.time()
        self.adaptive = params.adaptive_rho
        self._init_rho = params.rho
        # in adaptive mode the metric is the identity (the projection does
        # not depend on rho) and rho enters the term proxes as a tensor
        self.sqrt_rho = 1.0 if self.adaptive else float(np.sqrt(params.rho))

        self._build_term_ops(problem)
        self._build_constr_prox(problem)

        self.all_dims: Dict[str, int] = dict(self.z_dims)
        for tvars in self.term_vars:
            for v in tvars:
                self.all_dims[v] = problem.var_dims[v]

        # warm-startable kernel state (TV-1D PDAS duals), one per term
        ks = [op.kernel_state_init() if hasattr(op, "kernel_state_init")
              else None for op in self.term_ops]
        self._kstate0 = tuple(ks) if any(k is not None for k in ks) else None

        self._t_init = time.time() - t0

    def _build_term_op(self, problem: ProxProblem, term, tvars):
        if self.adaptive:
            return create_rho_prox_operator(
                term.spec, term.H, {k: problem.var_dims[k] for k in tvars})
        A = BlockMatrix({(k, k): linop.scalar(self.sqrt_rho,
                                              problem.var_dims[k])
                         for k in tvars})
        return create_prox_operator(term.spec, term.H,
                                    AffineOperator(A, BlockVector()))

    def _build_term_ops(self, problem: ProxProblem):
        """Per-term prox operators with A = sqrt(rho)*I over the term's
        variables (rho-parameterized in the unit metric when adaptive)."""
        self.term_vars: List[List[str]] = [_term_vars(t) for t in problem.terms]
        self.term_ops = [self._build_term_op(problem, t, tv)
                         for t, tv in zip(problem.terms, self.term_vars)]

    def _build_constr_prox(self, problem: ProxProblem):
        """Constraint projection operator over the constraint variables."""
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

    def _rebuild_operators(self, problem: ProxProblem, old: ProxProblem):
        """New data, same structure: rebuild each term operator whose data
        changed, and the constraint projection when the constraint data
        changed (the JAX package keeps its projection there)."""
        for i, (t, t_old) in enumerate(zip(problem.terms, old.terms)):
            if not (_same_spec(t.spec, t_old.spec) and _same_affine(t.H, t_old.H)):
                self.term_ops[i] = self._build_term_op(problem, t, self.term_vars[i])
        if not _same_constraints(problem, old):
            self._build_constr_prox(problem)

    # -- loop state -----------------------------------------------------------
    def _unpack_state(self, state):
        """(z, u, rho_or_None, kstates_or_None) from the packed loop state."""
        i = 2
        rho = None
        if self.adaptive:
            rho = state[i]
            i += 1
        ks = state[i] if self._kstate0 is not None else None
        return state[0], state[1], rho, ks

    def _pack_state(self, z, u, rho, ks):
        out = (z, u)
        if self.adaptive:
            out = out + (rho,)
        if self._kstate0 is not None:
            out = out + (ks,)
        return out

    # -- iteration ------------------------------------------------------------
    def _scaled(self, v: BlockVector) -> BlockVector:
        # sqrt(rho) = 1 scales exactly, so the multiply is skipped
        return v if self.sqrt_rho == 1.0 else self.sqrt_rho * v

    def _iter_body(self, state):
        z, u, rho, ks = self._unpack_state(state)
        zu = z - u
        v = zu if self.adaptive else self._scaled(zu)
        x = _zeros(self.all_dims)
        ks_out = []
        for i, op in enumerate(self.term_ops):
            k_i = ks[i] if ks is not None else None
            if k_i is not None:
                # warm-startable kernel: thread its state (TV PDAS dual)
                xi, k_i = op.apply_stateful(v, k_i, rho=rho)
            elif self.adaptive:
                xi = op.apply_rho(v, rho)
            else:
                xi = op.apply(v)
            x = x + xi
            ks_out.append(k_i)
        alpha = self.params.over_relaxation
        x_hat = x if alpha == 1.0 else alpha * x + (1.0 - alpha) * z
        xu = x_hat + u
        z_new = self._z_update(xu)
        u_new = u + x_hat - z_new
        new_ks = tuple(ks_out) if ks is not None else None
        return self._pack_state(z_new, u_new, rho, new_ks), x

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
        z, u, rho, _ks = self._unpack_state(state)
        if rho is None:
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
        does.  In adaptive mode the epoch ends with residual balancing on
        the device (no host sync of its own): rho moves by ``rho_tau`` to
        keep ||r|| and ||s|| within a factor ``rho_mu``, and the scaled dual
        u is rescaled with it (Boyd et al. 3.4.1)."""
        for _ in range(self.params.epoch_iterations):
            z_prev = state[0]
            state, x = self._iter_body(state)
        res = self._residuals(state, x, z_prev)
        if self.adaptive:
            z, u, rho, ks = self._unpack_state(state)
            mu, tau = self.params.rho_mu, self.params.rho_tau
            grow = res[0] > mu * res[1]
            shrink = res[1] > mu * res[0]
            factor = torch.where(
                grow, torch.full_like(rho, tau),
                torch.where(shrink, torch.full_like(rho, 1.0 / tau),
                            torch.ones_like(rho)))
            state = self._pack_state(z, (1.0 / factor) * u, rho * factor, ks)
        return state, x, res

    def _init_state(self):
        if self.params.warm_start and self._warm_state is not None:
            return self._warm_state
        rho = (torch.tensor(self.params.rho, dtype=config.default_dtype(),
                            device=config.device()) if self.adaptive else None)
        return self._pack_state(_zeros(self.all_dims), _zeros(self.all_dims),
                                rho, self._kstate0)

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        if old_state is None or old_adaptive != self.adaptive:
            return None
        z = old_state[0]
        if set(z.keys()) != set(self.all_dims) or any(
                tuple(z[k].shape) != (n,) for k, n in self.all_dims.items()):
            return None  # state layout changed
        u = old_state[1]
        rho = old_state[2] if self.adaptive else None
        if not self.adaptive:
            # u is the scaled dual lambda/rho: keep lambda across the rho
            # change (Boyd et al. 3.4.1)
            u = (old_rho / self._init_rho) * u
        # kernel warm state restarts cold across a rebuild (the metric its
        # duals live in changed)
        return self._pack_state(z, u, rho, self._kstate0)

    def solve(self) -> BlockVector:
        t0 = time.time()
        # iteratively certified inner kernels (TV-1D) certify one decade
        # tighter than the outer rel_tol, as in the JAX package
        config.set_prox_inner_tol(config.prox_inner_tol_for(self.params.rel_tol))
        if (self.adaptive != self.params.adaptive_rho
                or (not self.adaptive and self.params.rho != self._init_rho)):
            # mode or fixed rho changed on a cached solver: the state layout,
            # the prox parameterization and the sqrt(rho) metric differ
            self._rebuild_full()
        state, x, iters, r, conv = self._run(self._init_state())
        self._finish(state, iters, r, conv, self._t_init, time.time() - t0)
        return x


class ProxADMMSolver(SolverBase):
    """N-block Gauss-Seidel ADMM.

    Any fixed rho is supported by running the rho = 1 sweep on the
    sqrt(rho)-scaled constraint system (A, b) <- (sqrt(rho) A, sqrt(rho) b),
    with residuals converted back to unscaled units."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        if params.adaptive_rho:
            raise ValueError("adaptive_rho is only supported by the "
                             "two-block solver (PROX_ADMM_TWO_BLOCK)")
        t0 = time.time()
        self.sqrt_rho = float(np.sqrt(params.rho))
        self._init_rho = params.rho
        self._build_constraints(problem)
        self._build_term_ops(problem)
        self._t_init = time.time() - t0

    def _build_constraints(self, problem: ProxProblem):
        """Global constraint operator, sqrt(rho)-scaled."""
        self.A = BlockMatrix()
        self.b = BlockVector()
        self.row_dims: Dict[str, int] = {}
        for i, con in enumerate(problem.constraints):
            if con.cone != Cone.ZERO:
                raise ValueError("ProxADMM supports ZERO cones only")
            Ai, bi = _rekey_constraint(i, con.op)
            for (r, c), op in Ai.blocks.items():
                if self.sqrt_rho != 1.0:
                    op = op.scale(self.sqrt_rho)
                self.A.insert(r, c, op)
                self.row_dims[r] = op.m
            for r, vec in bi.items():
                self.b[r] = vec if self.sqrt_rho == 1.0 else self.sqrt_rho * vec
        self.AT = self.A.T
        self.m = sum(self.row_dims.values())
        self.n = sum(problem.var_dims[c] for c in self.A.col_keys())

    def _build_term_ops(self, problem: ProxProblem):
        """Per-term prox operators bound to the sqrt(rho)-scaled constraint
        columns of the term's variables."""
        constr_vars = set(self.A.col_keys())
        self.Ai = [self.A.select_cols([v for v in _term_vars(term)
                                       if v in constr_vars])
                   for term in problem.terms]
        self.AiT = [Ai.T for Ai in self.Ai]
        self.term_ops = [create_prox_operator(
            term.spec, term.H, AffineOperator(Ai, BlockVector()))
            for term, Ai in zip(problem.terms, self.Ai)]

    def _rebuild_operators(self, problem: ProxProblem, old: ProxProblem):
        """New data, same structure.  The constraint system is rebuilt from
        the new problem too when its data changed (the JAX package rebuilds
        the term operators alone and keeps A and b of the first problem);
        every term operator holds the constraint columns, so then all are
        rebuilt."""
        if not _same_constraints(problem, old):
            self._build_constraints(problem)
            self._build_term_ops(problem)
            return
        for i, (t, t_old) in enumerate(zip(problem.terms, old.terms)):
            if not (_same_spec(t.spec, t_old.spec) and _same_affine(t.H, t_old.H)):
                self.term_ops[i] = create_prox_operator(
                    t.spec, t.H, AffineOperator(self.Ai[i], BlockVector()))

    # -- iteration ------------------------------------------------------------
    def _pad(self, y: BlockVector) -> BlockVector:
        """``y`` over the full constraint row space (terms touch different
        constraint rows; the state keeps one layout)."""
        return BlockVector({k: y.get(k, n) for k, n in self.row_dims.items()})

    def _sweep(self, state):
        """One Gauss-Seidel sweep."""
        u, ys = state
        u = u - self.b.to_device()
        for y in ys:
            u = u - y
        xs = []
        new_ys = []
        for i, op in enumerate(self.term_ops):
            u = u + ys[i]
            x = op.apply(u)
            y = self._pad(self.A.apply(x))
            u = u - y
            xs.append(x)
            new_ys.append(y)
        return (u, tuple(new_ys)), tuple(xs)

    def _residuals(self, state, xs, ys_prev):
        """Residuals in UNSCALED units.  The loop runs on the
        sqrt(rho)-scaled system (A_bar = sqrt(rho) A), so primal quantities
        divide by sqrt(rho); the dual residual rho*||A_i' sum dy|| equals
        ||A_bar_i' dy_bar|| directly (two factors of sqrt(rho)); and
        rho*||A' u_true|| = ||A_bar' u_bar||, since the scaled system's dual
        u_bar carries lambda/sqrt(rho)."""
        u, ys = state
        abs_tol, rel_tol = self.params.abs_tol, self.params.rel_tol
        inv_sqrt_rho = 1.0 / self.sqrt_rho
        N = len(self.term_ops)

        b_dev = self.b.to_device()
        Ax_b = b_dev
        max_norm = b_dev.norm()
        for x in xs:
            Ai_xi = self.A.apply(x)
            max_norm = torch.maximum(max_norm, Ai_xi.norm())
            Ax_b = Ax_b + Ai_xi
        r_norm = Ax_b.norm() * inv_sqrt_rho
        max_norm = max_norm * inv_sqrt_rho

        s_sq = torch.zeros((), dtype=config.default_dtype(), device=config.device())
        Ax_diff = BlockVector()
        for i in range(N - 2, -1, -1):
            Ax_diff = Ax_diff + (ys[i + 1] - ys_prev[i + 1])
            s_i = self.AiT[i].apply(Ax_diff).norm()
            s_sq = s_sq + s_i * s_i
        s_norm = torch.sqrt(s_sq)

        eps_p = abs_tol * float(np.sqrt(max(self.m, 1))) + rel_tol * max_norm
        eps_d = (abs_tol * float(np.sqrt(max(self.n, 1)))
                 + rel_tol * self.AT.apply(u).norm())
        return torch.stack([r_norm, s_norm, eps_p, eps_d])

    def _epoch(self, state):
        # dual residual from the FINAL sweep's y deltas
        for _ in range(self.params.epoch_iterations):
            ys_prev = state[1]
            state, xs = self._sweep(state)
        return state, xs, self._residuals(state, xs, ys_prev)

    def _init_state(self):
        if self.params.warm_start and self._warm_state is not None:
            return self._warm_state
        return (_zeros(self.row_dims),
                tuple(_zeros(self.row_dims) for _ in self.term_ops))

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        if old_state is None:
            return None
        # Scaled system: u_bar = lambda/sqrt(rho), ys = sqrt(rho)*A*x.
        # Keep lambda and x across the rho change.
        s = float(np.sqrt(old_rho / self._init_rho))
        u, ys = old_state
        return (s * u, tuple((1.0 / s) * y for y in ys))

    def solve(self) -> BlockVector:
        t0 = time.time()
        config.set_prox_inner_tol(config.prox_inner_tol_for(self.params.rel_tol))
        if self.params.rho != self._init_rho:
            # rho is baked into the scaled constraint system and the cached
            # KKT factorizations
            self._rebuild_full()
        state, xs, iters, r, conv = self._run(self._init_state())
        self._finish(state, iters, r, conv, self._t_init, time.time() - t0)
        # solution = sum_i x_i
        out = BlockVector()
        for x in xs:
            out = out + x
        return out


def create_solver(problem: ProxProblem, params: SolverParams):
    if params.solver == SolverKind.PROX_ADMM:
        if params.adaptive_rho:
            # The Gauss-Seidel sweep's cached factorizations bake in rho:
            # solve the same prox-affine problem by the mathematically
            # equivalent two-block consensus splitting, whose proxes are
            # rho-parameterized.
            return ProxADMMTwoBlockSolver(problem, params)
        return ProxADMMSolver(problem, params)
    return ProxADMMTwoBlockSolver(problem, params)
