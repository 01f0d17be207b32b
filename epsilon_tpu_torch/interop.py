"""Carry compiled problems and solver state across from the JAX package.

The port is held against ``epsilon_tpu`` on the identical compiled problem
and state.  These helpers take the reference's objects apart through their
host (numpy) interfaces only, so this module imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

from .ir import (AffineOperator, Cone, ConeConstraint, ProxFunctionSpec,
                 ProxKind, ProxProblem, ProxTerm)
from .ops import linop
from .ops.block import BlockMatrix, BlockVector


def linop_from_numpy(op) -> linop.LinOp:
    """The port's operator for a reference operator, through its host
    interface: ``scalar_value()``, ``diag_value()``, a Kronecker product as
    the product of its two converted factors, then ``as_sparse()`` for
    operators backed by a scipy matrix and ``as_dense()`` otherwise."""
    n = op.shape[1]
    if op.shape[0] == n:
        sv = op.scalar_value()
        if sv is not None:
            return linop.ScalarOp(sv, n)
        dv = op.diag_value()
        if dv is not None:
            return linop.DiagonalOp(np.asarray(dv))
    if type(op).__name__ == "KronOp":
        return linop.KronOp(linop_from_numpy(op.A), linop_from_numpy(op.B))
    if sp.issparse(getattr(op, "A", None)):
        return linop.SparseOp(op.as_sparse())
    return linop.DenseOp(np.asarray(op.as_dense()))


def _affine(aff) -> AffineOperator:
    A = BlockMatrix({key: linop_from_numpy(op) for key, op in aff.A.blocks.items()})
    b = BlockVector({k: np.asarray(v, dtype=np.float64) for k, v in aff.b.items()})
    return AffineOperator(A, b)


def _spec(s) -> ProxFunctionSpec:
    return ProxFunctionSpec(
        kind=ProxKind(s.kind.value), epigraph=s.epigraph, alpha=s.alpha,
        arg_sizes=[tuple(a) for a in s.arg_sizes], k=s.k,
        scaled_zone_params=s.scaled_zone_params, axis=s.axis)


def prox_problem_from_numpy(p) -> ProxProblem:
    """The port's ``ProxProblem`` for a JAX-package ``ProxProblem``."""
    return ProxProblem(
        terms=[ProxTerm(_spec(t.spec), _affine(t.H)) for t in p.terms],
        constraints=[ConeConstraint(Cone(c.cone.value), _affine(c.op))
                     for c in p.constraints],
        var_dims=dict(p.var_dims),
        var_shapes={k: tuple(v) for k, v in p.var_shapes.items()})


def _t(a):
    return linop.to_tensor(np.array(a, dtype=np.float64))


def _bv(d):
    return BlockVector({k: _t(v) for k, v in d.items()})


def state_from_numpy(z: Dict[str, np.ndarray], u: Dict[str, np.ndarray],
                     kstates=None, rho=None):
    """The two-block solver's warm state from per-variable numpy arrays
    (e.g. a JAX solver's state, converted with ``np.asarray``), as tensors
    on the configured device, packed as the solver packs it:
    ``(z, u[, rho][, kstates])``.  ``rho`` (adaptive mode) becomes a 0-d
    tensor; ``kstates`` is given when the solver threads warm kernel state
    (one entry per term, None for the terms without)."""
    out = (_bv(z), _bv(u))
    if rho is not None:
        out += (_t(rho).reshape(()),)
    if kstates is not None:
        out += (tuple(None if k is None else _t(k) for k in kstates),)
    return out


def two_block_state_from_reference(state):
    """:func:`state_from_numpy` of a JAX two-block solver's packed state
    ``(z, u[, rho][, kstates])``, told apart by the types of its entries."""
    rho = kstates = None
    for extra in state[2:]:
        if isinstance(extra, tuple):
            kstates = [None if k is None else np.asarray(k) for k in extra]
        else:
            rho = np.asarray(extra)
    return state_from_numpy({k: np.asarray(v) for k, v in state[0].items()},
                            {k: np.asarray(v) for k, v in state[1].items()},
                            kstates=kstates, rho=rho)


def meshed_state_from_numpy(solver, z: Dict[str, np.ndarray],
                            u: Dict[str, np.ndarray], rho=None):
    """A meshed two-block solver's warm state on THIS rank from the global
    layout of the JAX package's meshed state (``np.asarray`` of its ``z``
    and ``u``: a stacked key ``scn:k`` holds all ``S * d`` entries there):
    the rank keeps its ``S / world`` rows of every stacked key and the
    replicated keys whole.  Kernel warm state starts cold (the JAX package
    carries none on its meshed path)."""
    rows = {g.key: slice(g.rows.start * g.d, g.rows.stop * g.d)
            for g in solver.scn_groups}

    def local(d):
        return {k: np.asarray(v)[rows[k]] if k in rows else v
                for k, v in d.items()}

    state = state_from_numpy(local(z), local(u), rho=rho)
    return solver._pack_state(state[0], state[1],
                              state[2] if rho is not None else None,
                              solver._kstate0)


def meshed_state_to_numpy(solver, state):
    """The inverse of :func:`meshed_state_from_numpy`: ``(z, u, rho)`` in
    the global layout as numpy (``rho`` None unless adaptive), the ranks'
    rows of the stacked keys all-gathered.  Every rank calls it together."""
    import torch
    import torch.distributed as dist

    stacked = {g.key for g in solver.scn_groups}

    def whole(bv):
        out = {}
        for k, v in bv.items():
            if k in stacked:
                parts = [torch.empty_like(v) for _ in range(solver.n_dev)]
                dist.all_gather(parts, v.contiguous(), group=solver.mesh)
                v = torch.cat(parts)
            out[k] = v.detach().cpu().numpy()
        return out

    z, u, rho, _ = solver._unpack_state(state)
    return whole(z), whole(u), None if rho is None else float(rho)


def nblock_state_from_numpy(u: Dict[str, np.ndarray], ys):
    """The N-block solver's warm state ``(u, ys)`` from numpy arrays keyed
    by constraint row (``ys``: one dict per term), as tensors on the
    configured device."""
    return _bv(u), tuple(_bv(y) for y in ys)


def consensus_state_from_numpy(x, u, z, rho):
    """The consensus solver's state ``(x, u, z, rho)`` from numpy arrays
    (e.g. a JAX ``ConsensusADMM._last_state``, converted with
    ``np.asarray``): x and u (S, n), z (n,) as tensors on the configured
    device, rho a float."""
    x, u, z = (linop.to_tensor(np.array(a, dtype=np.float64)) for a in (x, u, z))
    return x, u, z, float(np.asarray(rho))
