"""Scenario stacking: memory-sharded term parallelism for two-block ADMM.

Counterpart of ``epsilon_tpu/solvers/scenario.py`` over a
``torch.distributed`` process group.  The term-bucket path
(``admm.py _sharded_x_update``) spreads heterogeneous terms over the ranks
and keeps the state replicated.  This module detects the *consensus
template* inside a ProxProblem —

    S isomorphic terms  f(H_i x_i + g_i),   each over a private variable
    x_i tied to one shared variable z by an identity ZERO constraint
    ``x_i - z = 0``

— and lowers it to a stacked representation: rank r of a group of W keeps
rows ``[r S/W, (r+1) S/W)`` of every stack of per-term operator data and of
the per-term state and nothing else, the x-update is one batched apply over
those rows, and the z-update folds the ties in closed form:

    proj onto {x_i = z  for all i} + C  of  (w_x1..w_xS, w_z, ...)
      =  project m = (sum_i w_xi + w_z)/(S+1) onto C with metric
         weight sqrt(S+1) on z, then broadcast x_i = z

(the exact Euclidean projection: substitute x_i = z and complete the
square), with the sum across ranks one ``all_reduce``.  When SEVERAL groups
tie to the SAME shared variable the joint substitution folds them all at
once: m = (w_z + sum_g tot_g) / (1 + sum_g S_g) with metric weight
sqrt(1 + sum_g S_g) (the solver's ``_z_update`` accumulates the totals per
shared variable before dividing).

Isomorphism is decided by the operators' structural signatures
(``ProxOperator.stack_signature``: apply path, mode, every scalar by value,
shapes and dtypes of every data array).  Two terms stack only on equal
signatures, and everything a signature leaves out is per-term data that is
stacked, so no term can inherit another's constants.  (The JAX package
decides by jaxpr equality of the traced applies with lifted constants; an
operator whose signature is None stacks there and goes to the bucket path
here.)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ir import Cone, ProxProblem
from ..ops import linop

logger = logging.getLogger("epsilon_tpu_torch")

SCN_PREFIX = "scn:"


@dataclasses.dataclass
class ScenarioGroup:
    key: str                 # state key for the stacked private vars
    shared: str              # the consensus variable the terms tie to
    term_idx: List[int]      # indices into problem.terms, stack order
    pv_names: List[str]      # private variable per term, stack order
    d: int                   # per-term private var dim
    S: int                   # number of stacked terms
    signature: Tuple         # the members' common structural signature
    tie_idx: List[int]
    rows: range              # this rank's rows of the stack
    fn: Callable             # stacked apply (data, V, rho) -> X
    stacks: List[torch.Tensor]   # this rank's rows of every data stack

    def local_apply(self, V, rho, adaptive: bool, sqrt_rho: float):
        """The prox of every scenario of this rank at the rows of ``V``
        (``(S_local, d)``), each with ITS rows of the stacked data."""
        if adaptive:
            return self.fn(self.stacks, V, rho)
        return self.fn(self.stacks, V if sqrt_rho == 1.0 else sqrt_rho * V)

    def stacked_bytes(self) -> int:
        """Bytes of stacked term data this rank holds."""
        return sum(t.numel() * t.element_size() for t in self.stacks)


def _row_data(group: ScenarioGroup, term_ops, r: int) -> List[torch.Tensor]:
    """The data arrays of the group's row ``r`` as tensors, from its term's
    operator, which must still have the group's signature."""
    op, pv = term_ops[group.term_idx[r]], group.pv_names[r]
    if op.stack_signature(pv) != group.signature:
        raise ValueError("scenario group structure changed under update")
    return [linop.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in op.stack_data(pv)]


def collect_group_stacks(group: ScenarioGroup, term_ops) -> List[torch.Tensor]:
    """This rank's rows of every data stack, from the operators of its own
    member terms (the others' are never touched, so they need not exist on
    this rank)."""
    per_term = [_row_data(group, term_ops, r) for r in group.rows]
    return [torch.stack(col) for col in zip(*per_term)]


def refresh_group(group: ScenarioGroup, term_ops, changed) -> None:
    """Rebind a group to freshly built term operators (``update_problem``):
    the rows of this rank whose term is in ``changed`` are stacked again
    from the new operators, in place.  The group, its stack order and the
    state layout stay as they are."""
    for r in group.rows:
        if group.term_idx[r] in changed:
            for stack, a in zip(group.stacks, _row_data(group, term_ops, r)):
                stack[r - group.rows.start] = a


def find_candidates(problem: ProxProblem, term_vars) -> List[Tuple[int, str, str, int]]:
    """Identity ties ``a x - a z = 0`` (no offset, a != 0) whose private
    variable x lives in exactly one term and one constraint, the owner term
    being over x alone: ``(term index, private var, shared var, tie
    constraint index)`` in constraint order.  Structural: no operator is
    built for it."""
    var_term_count: Dict[str, int] = {}
    for tvars in term_vars:
        for v in tvars:
            var_term_count[v] = var_term_count.get(v, 0) + 1
    var_con: Dict[str, List[int]] = {}
    for ci, con in enumerate(problem.constraints):
        for (_, c) in con.op.A.blocks:
            var_con.setdefault(c, []).append(ci)

    candidates = []
    for ci, con in enumerate(problem.constraints):
        if con.cone != Cone.ZERO:
            continue
        blocks = con.op.A.blocks
        rows = {r for (r, _) in blocks}
        if len(blocks) != 2 or len(rows) != 1:
            continue
        if any(np.any(np.asarray(v)) for _, v in con.op.b.items()):
            continue
        (k1, op1), (k2, op2) = sorted(blocks.items())
        s1, s2 = op1.scalar_value(), op2.scalar_value()
        # reject zero coefficients: 0*x + (-0)*z = 0 passes isclose(s1,-s2)
        # but is vacuous, not an identity tie
        if (s1 is None or s2 is None or not np.isclose(s1, -s2)
                or np.isclose(s1, 0.0)):
            continue
        v1, v2 = k1[1], k2[1]
        for pv, sv in ((v1, v2), (v2, v1)):
            if (var_term_count.get(pv, 0) != 1 or
                    len(var_con.get(pv, [])) != 1):
                continue
            owners = [ti for ti, tv in enumerate(term_vars) if pv in tv]
            if len(owners) != 1 or len(term_vars[owners[0]]) != 1:
                continue
            candidates.append((owners[0], pv, sv, ci))
            break
    return candidates


def candidate_share(candidates, n_devices: int, rank: int):
    """The contiguous 1/n_devices of the candidates whose signatures rank
    ``rank`` computes."""
    per = -(-len(candidates) // n_devices)
    return candidates[rank * per:(rank + 1) * per]


def detect_scenario_groups(problem: ProxProblem, term_ops, term_vars,
                           n_devices: int, rank: int, exchange: Callable):
    """Find stackable scenario groups.  Returns (groups, stacked_terms,
    tie_constraints) — the term/constraint indices consumed by stacking.

    ``term_ops[i]`` is term i's operator (an indexable that may build it at
    first touch).  ``rank`` picks the rows of the stacks that are kept.
    Each rank computes the signatures of its :func:`candidate_share` only,
    and ``exchange`` (a function that all-gathers one Python object per
    rank into a list in rank order) swaps them, so a rank builds the
    operators of its share and of its own rows and no others.  (The JAX
    package's ``adaptive`` and ``sqrt_rho`` arguments are already in the
    operators.)"""
    if n_devices <= 1:
        return [], set(), set()

    candidates = find_candidates(problem, term_vars)
    mine = candidate_share(candidates, n_devices, rank)
    sigs = [s for part in exchange(
        [term_ops[ti].stack_signature(pv) for ti, pv, _, _ in mine])
        for s in part]

    # group by (shared var, dim, signature)
    groups_by_sig: Dict[Tuple, List] = {}
    unstackable = 0
    for (ti, pv, sv, ci), sig in zip(candidates, sigs):
        if sig is None:
            unstackable += 1
            continue
        d = problem.var_dims[pv]
        groups_by_sig.setdefault((sv, d, sig), []).append((ti, pv, ci))
    if unstackable:
        logger.info(
            "scenario stacking: %d candidate terms have operators that do "
            "not stack in this package; they go to bucket term sharding",
            unstackable)

    groups: List[ScenarioGroup] = []
    stacked_terms: set = set()
    tie_constraints: set = set()
    claimed_pvs: set = set()
    gi = 0
    for (sv, d, sig), members in sorted(
            groups_by_sig.items(), key=lambda kv: min(m[0] for m in kv[1])):
        S = len(members)
        if S < n_devices or S % n_devices != 0:
            # no silent caps: a 12-scenario family on 8 devices falls back
            # to bucket sharding (replicated state, all-reduced compute),
            # which is correct but loses the memory sharding — say so
            logger.info(
                "scenario stacking skipped for %d isomorphic terms on %r: "
                "S=%d not a multiple of n_devices=%d (>= one per device "
                "required); falling back to bucket term sharding",
                S, sv, S, n_devices)
            continue
        if sv in claimed_pvs:
            # the shared var was already folded away as another group's
            # private var — cannot anchor a consensus average on it
            continue
        members.sort()  # deterministic stack order by term index
        per = S // n_devices
        rows = range(rank * per, (rank + 1) * per)
        group = ScenarioGroup(
            key=f"{SCN_PREFIX}{gi}", shared=sv,
            term_idx=[m[0] for m in members],
            pv_names=[m[1] for m in members],
            d=d, S=S, signature=sig,
            tie_idx=[m[2] for m in members], rows=rows,
            fn=term_ops[members[rows.start][0]].stacked_fn(
                members[rows.start][1]),
            stacks=[])
        group.stacks = collect_group_stacks(group, term_ops)
        groups.append(group)
        stacked_terms.update(m[0] for m in members)
        tie_constraints.update(m[2] for m in members)
        claimed_pvs.update(m[1] for m in members)
        gi += 1
    return groups, stacked_terms, tie_constraints
