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


def state_from_numpy(z: Dict[str, np.ndarray], u: Dict[str, np.ndarray],
                     kstates=None):
    """The two-block solver's warm state from per-variable numpy arrays
    (e.g. a JAX solver's state, converted with ``np.asarray``), as tensors
    on the configured device: ``(z, u)``, or ``(z, u, kstates)`` when the
    solver threads warm kernel state (one entry per term, None for the
    terms without)."""
    def t(a):
        return linop.to_tensor(np.array(a, dtype=np.float64))

    def bv(d):
        return BlockVector({k: t(v) for k, v in d.items()})
    if kstates is None:
        return bv(z), bv(u)
    return bv(z), bv(u), tuple(None if k is None else t(k) for k in kstates)


def consensus_state_from_numpy(x, u, z, rho):
    """The consensus solver's state ``(x, u, z, rho)`` from numpy arrays
    (e.g. a JAX ``ConsensusADMM._last_state``, converted with
    ``np.asarray``): x and u (S, n), z (n,) as tensors on the configured
    device, rho a float."""
    x, u, z = (linop.to_tensor(np.array(a, dtype=np.float64)) for a in (x, u, z))
    return x, u, z, float(np.asarray(rho))
