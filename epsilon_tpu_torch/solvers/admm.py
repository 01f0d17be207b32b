"""ADMM operator-splitting solvers on tensors.

Counterpart of ``epsilon_tpu/solvers/admm.py``, on one device or (the
two-block solver, ``SolverParams.mesh``) over the ranks of a
``torch.distributed`` process group:

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

With a process group in place of the JAX mesh (one process per mesh
device, ``psum`` -> ``all_reduce``, ``lax.switch(axis_index)`` -> "this
rank's bucket", ``P(axis)`` on a stacked key -> each rank holds its
``S / world`` rows), the two-block solver shards its terms: scenario
stacking (:mod:`.scenario`) for terms that fit the consensus template and
one bucket of the remaining terms per rank.  The JAX package's bucket heaps
have no counterpart: they exist there because one traced program holds
every branch, while a rank here builds the operators of its own bucket
alone.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..ir import (AffineOperator, Cone, ProxFunctionSpec, ProxKind,
                  ProxProblem, constraint_key)
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from ..ops.prox.operator import create_prox_operator, create_rho_prox_operator
from ..utils.timing import PROX_SPANS, count, span
from . import scenario
from .objective import problem_objective, term_objective
from .params import SolverKind, SolverParams
from .status import Residuals, SolverState, SolverStatus, Timing

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


def _setup_span(init):
    """A solver's ``__init__`` under the ``epsilon.solver_setup`` span; its
    host time adds to ``_setup_ns`` for the next solve to report it."""
    @functools.wraps(init)
    def timed(self, problem, params):
        with span("epsilon.solver_setup") as setup:
            init(self, problem, params)
        self._setup_ns += setup.ns
    return timed


# -- has the data of an operator changed? (update_problem) -------------------
# Each array comparison counts one side's bytes (``update.compared_bytes``).

def _same_array(a, b) -> bool:
    a = np.asarray(a)
    count("update.compared_bytes", a.nbytes)
    return np.array_equal(a, b)


def _same_linop(a, b) -> bool:
    if type(a) is not type(b) or tuple(a.shape) != tuple(b.shape):
        return False
    if isinstance(a, linop.ScalarOp):
        return a.alpha == b.alpha
    if isinstance(a, linop.DiagonalOp):
        return _same_array(a.d, b.d)
    if isinstance(a, linop.DenseOp):
        return _same_array(a.A, b.A)
    if isinstance(a, linop.SparseOp):
        count("update.compared_bytes",
              a.A.data.nbytes + a.A.indices.nbytes + a.A.indptr.nbytes)
        return (a.A != b.A).nnz == 0
    if isinstance(a, linop.KronOp):
        return _same_linop(a.A, b.A) and _same_linop(a.B, b.B)
    return False


def _same_affine(a: AffineOperator, b: AffineOperator) -> bool:
    if a.A.blocks.keys() != b.A.blocks.keys() or a.b.keys() != b.b.keys():
        return False
    return (all(_same_linop(op, b.A.blocks[k]) for k, op in a.A.blocks.items())
            and all(_same_array(v, np.asarray(b.b[k])) for k, v in a.b.items()))


def _same_spec(a: ProxFunctionSpec, b: ProxFunctionSpec) -> bool:
    pa, pb = a.scaled_zone_params or {}, b.scaled_zone_params or {}
    return ((a.kind, a.epigraph, a.alpha, a.k, a.axis, list(a.arg_sizes))
            == (b.kind, b.epigraph, b.alpha, b.k, b.axis, list(b.arg_sizes))
            and pa.keys() == pb.keys()
            and all(_same_array(v, pb[k]) for k, v in pa.items()))


def _same_constraints(p: ProxProblem, q: ProxProblem) -> bool:
    return (len(p.constraints) == len(q.constraints)
            and all(c.cone == d.cone and _same_affine(c.op, d.op)
                    for c, d in zip(p.constraints, q.constraints)))


class SolverBase:
    """Status plumbing, hooks and the epoch loop shared by both solvers."""

    # set-up and update_problem time that no solve has reported yet
    _setup_ns = _update_ns = 0

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

    def _save_checkpoint(self, step: int, state, periodic: bool):
        """A periodic save (every ``every_epochs`` calls) or a final one."""
        if periodic:
            self._checkpointer.maybe_save(step, state)
        else:
            self._checkpointer.save(step, state)

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

    def _agree_stop(self, stop: bool) -> bool:
        return stop

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
        with span("epsilon.update_problem") as update:
            old = self.problem
            self.problem = problem
            self._rebuild_operators(problem, old)
        self._update_ns += update.ns

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
            with span("epsilon.residuals"):
                r = Residuals(*res.tolist())   # the epoch's one host sync
            series.append(r)
            conv = r.r_norm <= r.epsilon_primal and r.s_norm <= r.epsilon_dual
            if host and self._checkpointer is not None:
                self._save_checkpoint(iters, state, periodic=True)
            if p.verbose and (iters % p.log_iterations < epoch_iters):
                self.status.num_iterations = iters
                self.status.residuals = r
                logger.info(self.status.log_line())
            if conv or iters >= limit or (
                    host and self._agree_stop(self._has_external_stop())):
                break
        if not host and self._checkpointer is not None:
            self._save_checkpoint(iters, state, periodic=False)
        self.status.series = series
        return state, out, iters, r, conv

    def _finish(self, state, iters, res, converged, loop_ns, writeback_ns):
        self.status.num_iterations = int(iters)
        self.status.residuals = res
        self.status.state = (SolverState.OPTIMAL if bool(converged)
                             else SolverState.MAX_ITERATIONS_REACHED)
        self.status.timing = Timing(init_usec=self._setup_ns // 1000,
                                    update_usec=self._update_ns // 1000,
                                    solve_usec=loop_ns // 1000,
                                    writeback_usec=writeback_ns // 1000)
        self.status.timing.add_up()
        self._setup_ns = self._update_ns = 0
        if self.params.warm_start:
            self._warm_state = state
        if self.params.verbose:
            logger.info(self.status.log_line())


class _TermOps:
    """Term operators built at first touch: a meshed solver touches only
    the terms of its own bucket and of its own rows of the scenario stacks,
    so the operators of the other ranks' terms never exist here."""

    def __init__(self, solver, problem):
        self._solver, self._problem = solver, problem

    def __getitem__(self, i):
        ops = self._solver.term_ops
        if ops[i] is None:
            ops[i] = self._solver._build_term_op(
                self._problem, self._problem.terms[i],
                self._solver.term_vars[i])
        return ops[i]


def device_bytes(*roots) -> int:
    """Bytes of the distinct tensor storages reachable from ``roots``
    through attributes, lists, tuples and dicts: what a set of operators
    keeps on the device (operators upload at first apply, so read it after
    a solve)."""
    import types
    seen, storages, todo = set(), {}, list(roots)
    while todo:
        o = todo.pop()
        if id(o) in seen or o is None:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            if o.layout == torch.sparse_csr:
                todo += [o.crow_indices(), o.col_indices(), o.values()]
            else:
                st = o.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        elif isinstance(o, dict):
            todo += list(o.values())
        elif isinstance(o, (list, tuple, set)):
            todo += list(o)
        elif isinstance(o, (str, bytes, int, float, np.ndarray, np.generic,
                            type, types.ModuleType, types.FunctionType,
                            types.BuiltinFunctionType)):
            continue
        elif hasattr(o, "__dict__"):
            todo += list(vars(o).values())
    return sum(storages.values())


class ProxADMMTwoBlockSolver(SolverBase):
    """Two-block consensus ADMM, on one device or sharded over the ranks of
    a process group (``params.mesh``).

    With a group, every rank constructs the solver on the same problem and
    calls :meth:`solve` together.  Terms that fit the consensus template
    stack (:mod:`.scenario`): rank r keeps its ``S / world`` rows of their
    data and state.  The remaining terms are balanced into one bucket per
    rank; a rank builds and applies the operators of its own bucket only,
    and one ``all_reduce`` per iteration (the flat-packed x, with the
    scenario fold's sums behind it) gives every rank the whole x.  z, u and
    rho of the non-stacked variables are the same on every rank, and every
    decision (the stop test, adaptive rho, an external stop) is taken from
    all-reduced values, so all ranks run the same number of iterations.
    Warm kernel state (the TV-1D PDAS dual) is threaded by the rank that
    owns the term, or holds its rows of the stack (the JAX package drops it
    on its meshed path).  A checkpoint of a meshed solve holds the state in
    its global layout (:meth:`global_state`): rank 0 writes it, and every
    rank restores its own part, so a solve resumes on another number of
    ranks whenever the groups are the same."""

    @_setup_span
    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        self.adaptive = params.adaptive_rho
        self._init_rho = params.rho
        # in adaptive mode the metric is the identity (the projection does
        # not depend on rho) and rho enters the term proxes as a tensor
        self.sqrt_rho = 1.0 if self.adaptive else float(np.sqrt(params.rho))

        self.mesh = params.mesh
        self.n_dev, self.rank = 1, 0
        self.n_collectives = 0   # collectives this solver has started
        self.buckets: Optional[List[List[int]]] = None
        self.scn_groups: List[scenario.ScenarioGroup] = []
        stacked_terms: set = set()
        tie_cons: set = set()
        self.term_vars: List[List[str]] = [_term_vars(t) for t in problem.terms]
        if self.mesh is None:
            self._build_term_ops(problem)
        else:
            self.n_dev = dist.get_world_size(self.mesh)
            self.rank = dist.get_rank(self.mesh)
            # Scenario stacking: isomorphic terms tied to a shared variable
            # by identity ZERO constraints stack along the group's ranks;
            # the tie projection folds into an all-reduced average.
            self.term_ops = [None] * len(problem.terms)
            lazy = _TermOps(self, problem)
            self.scn_groups, stacked_terms, tie_cons = \
                scenario.detect_scenario_groups(
                    problem, lazy, self.term_vars, self.n_dev, rank=self.rank,
                    exchange=self._all_gather_object)
            # Term sharding for the REMAINING terms: one bucket per rank
            # (greedy LPT on the H nnz cost model).
            rem = [i for i in range(len(problem.terms))
                   if i not in stacked_terms]
            self.buckets = self._partition_terms(self.n_dev, rem) if rem \
                else None
            own = set(self.buckets[self.rank]) if self.buckets else set()
            for i in range(len(problem.terms)):
                if i in own:
                    lazy[i]
                else:
                    # another rank's term, or a stacked one whose data now
                    # lives in its group's stacks
                    self.term_ops[i] = None
        self._scn_keys = {g.key for g in self.scn_groups}
        self._tie_cons = tie_cons
        self._folded_pvs = {pv for g in self.scn_groups for pv in g.pv_names}
        # Joint fold weight per shared variable: several scenario groups may
        # tie to the SAME shared var; the exact joint projection substitutes
        # all their copies at once, m = (w_z + sum_g tot_g)/(1 + sum_g S_g),
        # metric sqrt(1 + sum_g S_g)
        self._shared_S: Dict[str, int] = {}
        for g in self.scn_groups:
            self._shared_S[g.shared] = self._shared_S.get(g.shared, 0) + g.S
        self._proj_w = {sv: float(np.sqrt(S + 1.0))
                        for sv, S in self._shared_S.items()}

        self._build_constr_prox(problem)

        # State key sets: all_dims has the LOCAL dims (what this rank's
        # state tensors hold: S/world rows of a stacked key), state_dims the
        # GLOBAL ones.  Identical without scenario stacking.
        self.all_dims: Dict[str, int] = {}
        self.state_dims: Dict[str, int] = {}
        for k, n in self.z_dims.items():
            if k not in self._folded_pvs:
                self.all_dims[k] = self.state_dims[k] = n
        for ti, tvars in enumerate(self.term_vars):
            if ti in stacked_terms:
                continue
            for v in tvars:
                self.all_dims[v] = self.state_dims[v] = problem.var_dims[v]
        for g in self.scn_groups:
            self.all_dims[g.key] = len(g.rows) * g.d
            self.state_dims[g.key] = g.S * g.d
        # flat layout of the bucket path's all-reduce
        self._rep_keys = sorted(k for k in self.all_dims
                                if k not in self._scn_keys)
        self._rep_offs, acc = {}, 0
        for k in self._rep_keys:
            self._rep_offs[k] = acc
            acc += self.all_dims[k]

        # warm-startable kernel state (TV-1D PDAS duals), one per term this
        # process applies and then one per scenario group (this rank's rows)
        ks = [op.kernel_state_init() if hasattr(op, "kernel_state_init")
              else None for op in self.term_ops]
        ks += [g.state0 for g in self.scn_groups]
        threads = any(k is not None for k in ks)
        if self.mesh is not None:
            # the state's layout is the same on every rank, so that every
            # rank packs and checkpoints the same structure
            threads = any(self._all_gather_object(threads))
        self._kstate0 = tuple(ks) if threads else None

    # -- the process group ------------------------------------------------------
    def _all_reduce(self, t, op=None):
        self.n_collectives += 1
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.mesh)
        return t

    def _all_gather_object(self, obj) -> list:
        self.n_collectives += 1
        out = [None] * self.n_dev
        dist.all_gather_object(out, obj, group=self.mesh)
        return out

    def _agree_stop(self, stop: bool) -> bool:
        """An external stop is rank-local: with a group, every rank stops
        when any rank's callback says so (one all-reduce per epoch under
        ``drive="host"``)."""
        if self.mesh is None:
            return stop
        flag = torch.tensor(float(stop), dtype=config.default_dtype(),
                            device=config.device())
        return bool(self._all_reduce(flag, dist.ReduceOp.MAX).item())

    # -- the global layout (checkpoints, interop) ---------------------------------
    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' rows of a stacked tensor, concatenated in stack order."""
        parts = [torch.empty_like(t) for _ in range(self.n_dev)]
        self.n_collectives += 1
        dist.all_gather(parts, t.contiguous(), group=self.mesh)
        return torch.cat(parts)

    def global_state(self, state):
        """The loop state in its global layout, on the host: the stacked keys
        and the groups' warm kernel states with every rank's rows in stack
        order, and the warm state of each bucket term from the rank that
        owns it.  It does not depend on the number of ranks, so a state
        saved at one world size restores at another whenever the groups are
        the same.  Every rank calls it together and gets the same."""
        if self.mesh is None:
            return state
        z, u, rho, ks = self._unpack_state(state)

        def whole(bv):
            return BlockVector({k: (self._gather_rows(v) if k in self._scn_keys
                                    else v).detach().cpu() for k, v in bv.items()})

        ks_g = None
        if ks is not None:
            n = len(self.term_ops)
            owned = {}
            for part in self._all_gather_object(
                    {i: k.detach().cpu() for i, k in enumerate(ks[:n])
                     if k is not None}):
                owned.update(part)
            ks_g = tuple(owned.get(i) for i in range(n)) + tuple(
                None if k is None else self._gather_rows(k).cpu()
                for k in ks[n:])
        return self._pack_state(whole(z), whole(u),
                                None if rho is None else rho.detach().cpu(), ks_g)

    def local_state(self, glob):
        """The inverse of :meth:`global_state` on this rank: its rows of the
        stacked keys and of the groups' kernel states, the warm state of the
        terms of its own bucket, on the configured device."""
        if self.mesh is None:
            return glob
        dev, dt = config.device(), config.default_dtype()
        z, u, rho, ks = self._unpack_state(glob)
        rows = {g.key: slice(g.rows.start * g.d, g.rows.stop * g.d)
                for g in self.scn_groups}

        def local(bv):
            return BlockVector({k: (v[rows[k]] if k in rows else v).to(dev, dt)
                                for k, v in bv.items()})

        ks_l = None
        if ks is not None:
            n = len(self.term_ops)
            ks_l = tuple(None if mine is None else ks[i].to(dev, dt)
                         for i, mine in enumerate(self._kstate0[:n]))
            ks_l += tuple(None if k is None else
                          k[g.rows.start:g.rows.stop].to(dev, dt)
                          for g, k in zip(self.scn_groups, ks[n:]))
        return self._pack_state(local(z), local(u),
                                None if rho is None else rho.to(dev, dt), ks_l)

    def _save_checkpoint(self, step: int, state, periodic: bool):
        """With a group every rank takes part: the state is gathered into its
        global layout, rank 0 alone writes it, and a barrier follows."""
        if self.mesh is None:
            return super()._save_checkpoint(step, state, periodic)
        if periodic and not self._checkpointer.tick():
            return
        glob = self.global_state(state)
        if self.rank == 0:
            self._checkpointer.save(step, glob)
        self.n_collectives += 1
        dist.barrier(group=self.mesh)

    def _resume_state(self, state):
        """With a group, rank 0 decides whether the latest checkpoint
        restores (it exists, belongs to this problem's global layout, its
        shapes fit) and every rank follows that one decision; then every
        rank reads the same file and keeps its own part."""
        if self.mesh is None or self._checkpointer is None:
            return super()._resume_state(state)
        like = self.global_state(state)
        step = self._checkpointer.check(like) if self.rank == 0 else None
        step = self._all_gather_object(step)[0]
        if step is None:
            return state, 0
        logger.info("resuming from checkpoint at iteration %d", step)
        return self.local_state(self._checkpointer.load(step, like)), step

    def _partition_terms(self, n_buckets: int,
                         indices: Optional[List[int]] = None) -> List[List[int]]:
        idx = range(len(self.problem.terms)) if indices is None else indices
        costs = []
        for i in idx:
            term = self.problem.terms[i]
            nnz = sum(op.nnz() for op in term.H.A.blocks.values())
            # KKT-based operators pay an extra dense solve over their vars
            tn = sum(self.problem.var_dims[v] for v in self.term_vars[i])
            if term.spec.kind in (ProxKind.ZERO, ProxKind.AFFINE,
                                  ProxKind.CONSTANT, ProxKind.SUM_SQUARE):
                nnz += tn * tn
            costs.append((nnz, i))
        buckets: List[List[int]] = [[] for _ in range(n_buckets)]
        loads = [0] * n_buckets
        for cost, i in sorted(costs, reverse=True):
            j = int(np.argmin(loads))
            buckets[j].append(i)
            loads[j] += cost
        return buckets

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
        self.term_ops = [self._build_term_op(problem, t, tv)
                         for t, tv in zip(problem.terms, self.term_vars)]

    def _build_constr_prox(self, problem: ProxProblem):
        """Constraint projection operator over the constraint variables,
        EXCLUDING the folded tie constraints of scenario groups.  Folded
        shared variables carry the metric weight sqrt(1 + sum_g S_g): the
        exact reduction of the joint projection (``scenario`` docstring)."""
        Hc = BlockMatrix()
        gc = BlockVector()
        self.z_dims: Dict[str, int] = {}   # ALL constraint vars (eps scaling)
        red_z_dims: Dict[str, int] = {}
        for i, con in enumerate(problem.constraints):
            if con.cone != Cone.ZERO:
                raise ValueError(f"two-block ADMM supports ZERO cones only, "
                                 f"got {con.cone}")
            Ai, bi = _rekey_constraint(i, con.op)
            for (r, c), op in Ai.blocks.items():
                self.z_dims[c] = op.n
            if i in self._tie_cons:
                continue
            for (r, c), op in Ai.blocks.items():
                Hc.insert(r, c, op)
                red_z_dims[c] = op.n
            for r, vec in bi.items():
                gc[r] = vec
        Ac = BlockMatrix({(k, k): linop.scalar(
            self.sqrt_rho * self._proj_w.get(k, 1.0), n)
            for k, n in red_z_dims.items()})
        self.constr_prox = None
        if red_z_dims:
            self.constr_prox = create_prox_operator(
                ProxFunctionSpec(kind=ProxKind.ZERO),
                AffineOperator(Hc, gc), AffineOperator(Ac, BlockVector()))
        self.m = sum(Hc.row_dim(r) for r in Hc.row_keys())
        self.n = sum(self.z_dims.values())

    def _rebuild_operators(self, problem: ProxProblem, old: ProxProblem):
        """New data, same structure: rebuild each term operator whose data
        changed, and the constraint projection when the constraint data
        changed (the JAX package keeps its projection there).  With a group
        a rank rebuilds the changed terms of its own bucket and restacks
        its own changed rows of the scenario stacks, nothing else; the
        groups and the state layout stay.  ``last_rebuilt`` lists the terms
        this rank rebuilt."""
        changed = {i for i, (t, t_old) in enumerate(zip(problem.terms, old.terms))
                   if not (_same_spec(t.spec, t_old.spec)
                           and _same_affine(t.H, t_old.H))}
        self.last_rebuilt = []
        for i in sorted(changed):
            if self.term_ops[i] is not None:
                self.term_ops[i] = self._build_term_op(problem, problem.terms[i],
                                                       self.term_vars[i])
                self.last_rebuilt.append(i)
        for g in self.scn_groups:
            mine = [g.term_idx[r] for r in g.rows if g.term_idx[r] in changed]
            if not mine:
                continue
            # the operators of the changed rows live only until their data
            # is in the stacks again
            lazy = _TermOps(self, problem)
            scenario.refresh_group(g, lazy, changed)
            for i in mine:
                self.term_ops[i] = None
            self.last_rebuilt += mine
        if not _same_constraints(problem, old):
            self._build_constr_prox(problem)
        count("update.rebuilt_terms", len(self.last_rebuilt))

    def objective_value(self, x: BlockVector):
        """The objective at ``x``.  With a group each rank evaluates the
        terms it owns (its bucket and its rows of the stacks), so no rank
        uploads another's term data, and the sum is all-reduced."""
        if self.mesh is None:
            return problem_objective(self.problem, x)
        total = torch.zeros((), dtype=config.default_dtype(),
                            device=config.device())
        for i in self.local_terms():
            total = total + term_objective(self.problem.terms[i], x)
        return self._all_reduce(total)

    def local_terms(self) -> List[int]:
        """The terms this process applies: all without a group, else its
        bucket and its rows of the scenario stacks."""
        if self.mesh is None:
            return list(range(len(self.problem.terms)))
        own = list(self.buckets[self.rank]) if self.buckets else []
        for g in self.scn_groups:
            own += [g.term_idx[r] for r in g.rows]
        return sorted(own)

    def operator_bytes(self) -> Dict[str, int]:
        """Bytes this process keeps on the device, by what holds them: the
        term operators it built, the scenario stacks, the constraint
        projection (read after a solve: operators upload at first apply)."""
        return {"term_ops": device_bytes(self.term_ops),
                "stacks": sum(g.stacked_bytes() for g in self.scn_groups),
                "constr_prox": device_bytes(self.constr_prox)}

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

    def _apply_terms(self, terms, v, rho, ks, dims):
        """Sum of the prox applies of ``terms`` at ``v`` over ``dims``, and
        the new kernel states (entries of other terms pass through)."""
        x = _zeros(dims)
        ks_out = list(ks) if ks is not None else None
        for i in terms:
            op = self.term_ops[i]
            k_i = ks[i] if ks is not None else None
            with span(PROX_SPANS[self.problem.terms[i].spec.kind]):
                if k_i is not None:
                    # warm-startable kernel: thread its state (TV PDAS dual)
                    xi, ks_out[i] = op.apply_stateful(v, k_i, rho=rho)
                elif self.adaptive:
                    xi = op.apply_rho(v, rho)
                else:
                    xi = op.apply(v)
            x = x + xi
        return x, (tuple(ks_out) if ks is not None else None)

    def _sharded_x_update(self, z, u, v, rho, ks):
        """x-update with a group, and the fold's sums, in ONE all-reduce.

        Bucket path: this rank applies the terms of its own bucket (none,
        for an empty bucket: zeros) and packs the result flat over the
        sorted non-stacked keys; the all-reduce combines the per-variable
        contributions, so every rank gets the whole x.  Stacked scenarios:
        one batched apply over this rank's rows, each with its rows of the
        stacked data.  The z-update's fold needs the sum over ALL scenarios
        of ``x_hat + u``, whose local part depends on this rank's rows
        alone, so it rides in the same all-reduce.  Returns ``(x, new
        kernel states, the groups' all-reduced sums)``."""
        x, new_ks = _zeros(self.all_dims), ks
        parts = []
        rep_dims = {k: self.all_dims[k] for k in self._rep_keys}
        if self.buckets is not None:
            xb, new_ks = self._apply_terms(self.buckets[self.rank], v, rho, ks,
                                           rep_dims)
            parts.append(xb.pack(self._rep_keys)[0])
        new_ks = list(new_ks) if new_ks is not None else None
        alpha = self.params.over_relaxation
        zu = z - u
        for gi, g in enumerate(self.scn_groups):
            rows = len(g.rows)
            j = len(self.term_ops) + gi
            st = ks[j] if ks is not None else None
            xg = g.local_apply(zu[g.key].reshape(rows, g.d), rho,
                               self.adaptive, self.sqrt_rho, st)
            if st is not None:
                xg, new_ks[j] = xg
            xg = xg.reshape(-1)
            x[g.key] = xg
            xh = xg if alpha == 1.0 else alpha * xg + (1.0 - alpha) * z[g.key]
            parts.append((xh + u[g.key]).reshape(rows, g.d).sum(dim=0))
        flat = self._all_reduce(torch.cat(parts))
        new_ks = tuple(new_ks) if new_ks is not None else None
        n_rep = 0
        if self.buckets is not None:
            n_rep = sum(rep_dims.values())
            for k, val in BlockVector.unpack(flat, self._rep_offs, rep_dims).items():
                x[k] = val
        return x, new_ks, flat[n_rep:]

    def _iter_body(self, state):
        z, u, rho, ks = self._unpack_state(state)
        with span("epsilon.x_update"):
            zu = z - u
            v = zu if self.adaptive else self._scaled(zu)
            sums = None
            if self.mesh is None:
                x, new_ks = self._apply_terms(range(len(self.term_ops)), v, rho,
                                              ks, self.all_dims)
            else:
                x, new_ks, sums = self._sharded_x_update(z, u, v, rho, ks)
        with span("epsilon.z_update"):
            alpha = self.params.over_relaxation
            x_hat = x if alpha == 1.0 else alpha * x + (1.0 - alpha) * z
            xu = x_hat + u
            z_new = self._z_update(xu, sums)
            u_new = u + x_hat - z_new
        return self._pack_state(z_new, u_new, rho, new_ks), x

    def _z_update(self, xu, sums=None):
        """Projection onto the constraint set.  With scenario groups, the
        identity ties fold in closed form: the shared variable's projection
        input is the all-reduced average of its scenarios (+ itself), with
        metric weight sqrt(1 + sum_g S_g) in the reduced KKT (``scenario``
        docstring); the stacked copies then broadcast back from the
        projected shared variable.  ``sums``: the groups' sums over all
        scenarios of ``xu``, ``d`` entries each, already all-reduced."""
        if not self.scn_groups:
            if self.constr_prox is None:
                return xu
            zp = self.constr_prox.apply(self._scaled(xu))
            # variables untouched by constraints pass through unprojected
            return BlockVector({k: (zp[k] if k in zp else xu[k])
                                for k in self.all_dims})
        red = BlockVector({k: v for k, v in xu.items()
                           if k not in self._scn_keys})
        # joint fold across ALL groups tied to each shared var:
        # m = (w_z + sum_g tot_g) / (1 + sum_g S_g)
        tots: Dict[str, torch.Tensor] = {}
        off = 0
        for g in self.scn_groups:
            tot = sums[off:off + g.d]
            off += g.d
            tots[g.shared] = (tot if g.shared not in tots
                              else tots[g.shared] + tot)
        for sv, tot in tots.items():
            red[sv] = (red[sv] + tot) / (self._shared_S[sv] + 1.0)
        if self.constr_prox is not None:
            scaled = BlockVector({
                k: (self.sqrt_rho * self._proj_w.get(k, 1.0)) * v
                for k, v in red.items()})
            zp = self.constr_prox.apply(scaled)
            red = BlockVector({k: (zp[k] if k in zp else red[k])
                               for k in red.keys()})
        z_new = BlockVector({k: red[k] for k in self._rep_keys})
        for g in self.scn_groups:
            z_new[g.key] = red[g.shared].expand(len(g.rows), g.d).reshape(-1)
        return z_new

    @staticmethod
    def _norm(bv: BlockVector):
        total = None
        for v in bv.data.values():
            total = torch.sum(v * v) if total is None else total + torch.sum(v * v)
        if total is None:
            total = torch.zeros((), dtype=config.default_dtype(), device=config.device())
        return torch.sqrt(total)

    def _norms(self, bvs):
        """The norms of several block vectors.  With a group they come out
        of ONE all-reduce: a rank contributes the squares of its rows of
        the stacked keys in full and those of the replicated keys divided
        by the world size (they count once), so every rank reads bitwise
        the same totals and takes the same decisions from them."""
        if self.mesh is None:
            return [self._norm(bv) for bv in bvs]
        zero = torch.zeros((), dtype=config.default_dtype(), device=config.device())
        parts = []
        for bv in bvs:
            rep, loc = zero, zero
            for k, v in bv.items():
                if k in self._scn_keys:
                    loc = loc + torch.sum(v * v)
                else:
                    rep = rep + torch.sum(v * v)
            parts.append(loc + rep / self.n_dev)
        return list(torch.sqrt(self._all_reduce(torch.stack(parts))))

    def _residuals(self, state, x, z_prev):
        z, u, rho, _ks = self._unpack_state(state)
        if rho is None:
            rho = self.params.rho
        abs_tol, rel_tol = self.params.abs_tol, self.params.rel_tol
        sqrt_n = float(np.sqrt(max(self.n, 1)))
        n_r, n_s, n_x, n_z, n_u = self._norms([x - z, z - z_prev, x, z, u])
        r_norm = n_r
        s_norm = rho * n_s
        eps_p = abs_tol * sqrt_n + rel_tol * torch.maximum(n_x, n_z)
        eps_d = abs_tol * sqrt_n + rel_tol * rho * n_u
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
            return None  # state layout changed (e.g. scenario stacking)
        u = old_state[1]
        rho = old_state[2] if self.adaptive else None
        if not self.adaptive:
            # u is the scaled dual lambda/rho: keep lambda across the rho
            # change (Boyd et al. 3.4.1)
            u = (old_rho / self._init_rho) * u
        # kernel warm state restarts cold across a rebuild (the metric its
        # duals live in changed)
        return self._pack_state(z, u, rho, self._kstate0)

    def _unstack_x(self, x: BlockVector) -> BlockVector:
        """Map stacked scenario keys back onto the original per-term
        variable names: the ranks' rows are all-gathered, so every rank
        returns the same full vector."""
        if not self.scn_groups:
            return x
        out = BlockVector({k: v for k, v in x.items()
                           if k not in self._scn_keys})
        for g in self.scn_groups:
            W = self._gather_rows(x[g.key]).reshape(g.S, g.d)
            for row, pv in enumerate(g.pv_names):
                out[pv] = W[row]
        return out

    def solve(self) -> BlockVector:
        # iteratively certified inner kernels (TV-1D) certify one decade
        # tighter than the outer rel_tol, as in the JAX package
        config.set_prox_inner_tol(config.prox_inner_tol_for(self.params.rel_tol))
        if (self.adaptive != self.params.adaptive_rho
                or self.mesh is not self.params.mesh
                or (not self.adaptive and self.params.rho != self._init_rho)):
            # mode, group or fixed rho changed on a cached solver: the state
            # layout, the prox parameterization and the sqrt(rho) metric
            # differ
            self._rebuild_full()
        with span("epsilon.admm_loop") as loop:
            state, x, iters, r, conv = self._run(self._init_state())
        with span("epsilon.write_back") as wrote:
            x = self._unstack_x(x)
        self._finish(state, iters, r, conv, loop.ns, wrote.ns)
        return x


class ProxADMMSolver(SolverBase):
    """N-block Gauss-Seidel ADMM.

    Any fixed rho is supported by running the rho = 1 sweep on the
    sqrt(rho)-scaled constraint system (A, b) <- (sqrt(rho) A, sqrt(rho) b),
    with residuals converted back to unscaled units."""

    @_setup_span
    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        if params.adaptive_rho:
            raise ValueError("adaptive_rho is only supported by the "
                             "two-block solver (PROX_ADMM_TWO_BLOCK)")
        self._reject_mesh(params)
        self.sqrt_rho = float(np.sqrt(params.rho))
        self._init_rho = params.rho
        self._build_constraints(problem)
        self._build_term_ops(problem)

    @staticmethod
    def _reject_mesh(params: SolverParams):
        if params.mesh is not None:
            raise ValueError("term sharding (mesh) is only supported by the "
                             "two-block solver (PROX_ADMM_TWO_BLOCK)")

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
            count("update.rebuilt_terms", len(problem.terms))
            return
        for i, (t, t_old) in enumerate(zip(problem.terms, old.terms)):
            if not (_same_spec(t.spec, t_old.spec) and _same_affine(t.H, t_old.H)):
                self.term_ops[i] = create_prox_operator(
                    t.spec, t.H, AffineOperator(self.Ai[i], BlockVector()))
                count("update.rebuilt_terms")

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
            with span(PROX_SPANS[self.problem.terms[i].spec.kind]):
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
        config.set_prox_inner_tol(config.prox_inner_tol_for(self.params.rel_tol))
        # new params on a kept solver: a group is refused as at construction
        self._reject_mesh(self.params)
        if self.params.rho != self._init_rho:
            # rho is baked into the scaled constraint system and the cached
            # KKT factorizations
            self._rebuild_full()
        with span("epsilon.admm_loop") as loop:
            state, xs, iters, r, conv = self._run(self._init_state())
        with span("epsilon.write_back") as wrote:
            # solution = sum_i x_i
            out = BlockVector()
            for x in xs:
                out = out + x
        self._finish(state, iters, r, conv, loop.ns, wrote.ns)
        return out


def create_solver(problem: ProxProblem, params: SolverParams):
    if params.solver == SolverKind.PROX_ADMM:
        if params.mesh is not None or params.adaptive_rho:
            # The Gauss-Seidel sweep is sequential (each term's prox
            # consumes the previous term's update), so it cannot shard over
            # terms, and its cached factorizations bake in rho: solve the
            # same prox-affine problem by the mathematically equivalent
            # two-block consensus splitting, whose x-updates are independent
            # (term buckets over the group's ranks) and whose proxes are
            # rho-parameterized.
            return ProxADMMTwoBlockSolver(problem, params)
        return ProxADMMSolver(problem, params)
    return ProxADMMTwoBlockSolver(problem, params)
