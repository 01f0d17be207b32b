"""Generalized prox operators over block affine structure.

Counterpart of ``epsilon_tpu/ops/prox/operator.py``.  Every operator
solves

    Apply(v)  =  argmin_x  alpha * f(H(x))  +  1/2 ||A(x) - v||^2

where ``H`` (the function's affine argument) and ``A`` (the scaled
constraint columns) are block linear operators.  Ported so far:

- :class:`VectorProxOperator` — canonical kernel behind the scalar or
  diagonal reduction, with the pre/post transforms v' = B v + g,
  x = C (y - g) + D v.
- KKT operators (:class:`ZeroProxOperator`, :class:`AffineProxOperator`,
  :class:`SumSquareProxOperator`) — cached block-Cholesky solves, folded
  into one dense solve operator (:class:`_CollapsedKKT`) when that is
  smaller than the factor.

Structure analysis and factorization run eagerly at construction; ``apply``
runs on tensors.  The second-order-cone and rho-parameterized operators are
not yet ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import config
from ...ir import AffineOperator, ProxFunctionSpec, ProxKind, arg_key
from .. import linop
from ..block import BlockMatrix, BlockVector
from ..cholesky import BlockCholesky
from .registry import KernelEntry, get_kernel


class ProxOperator:
    """Base class."""

    def apply(self, v: BlockVector) -> BlockVector:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# structure probes
# ---------------------------------------------------------------------------

def _block_scalar(M: BlockMatrix) -> Optional[float]:
    """If M is alpha*I on every diagonal block (no off-diagonal blocks),
    return alpha."""
    alpha = None
    for (r, c), op in M.blocks.items():
        if r != c:
            return None
        sv = op.scalar_value()
        if sv is None:
            return None
        if alpha is None:
            alpha = sv
        elif not np.isclose(alpha, sv):
            return None
    return alpha


def _block_diagonal(M: BlockMatrix) -> Optional[np.ndarray]:
    """If M is diag(d) with the same d on every diagonal block, return d."""
    d = None
    for (r, c), op in M.blocks.items():
        if r != c:
            return None
        dv = op.diag_value()
        if dv is None:
            return None
        if d is None:
            d = dv
        elif d.shape != dv.shape or not np.allclose(d, dv):
            return None
    return d


# ---------------------------------------------------------------------------
# VectorProxOperator
# ---------------------------------------------------------------------------

class VectorProxOperator(ProxOperator):
    """Canonical-kernel wrapper with scalar/diagonal reduction."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        self.spec = spec
        self.entry: KernelEntry = get_kernel(spec.kind)
        if spec.epigraph or spec.axis is not None or self.entry.matrix \
                or self.entry.nargs != 1:
            raise NotImplementedError(
                f"{spec!r}: epigraph, axis, matrix and two-argument kernels "
                "are not yet ported")
        H, A = affine_arg.A, affine_constraint.A
        self.g = affine_arg.b
        HT, AT = H.T, A.T

        self.elementwise = False
        self.D: Optional[BlockMatrix] = None

        beta_s = _block_scalar(HT @ H)
        gamma_s = _block_scalar(H @ AT @ A @ HT)
        if beta_s is not None and gamma_s is not None:
            # scalar reduction
            self.B = (H @ AT).scale(beta_s / gamma_s)
            self.C = HT.scale(1.0 / beta_s)
            self.lam = spec.alpha * beta_s * beta_s / gamma_s
        else:
            beta = _block_diagonal(HT @ H)
            gamma = _block_diagonal(H @ AT @ A @ HT)
            if beta is None or gamma is None:
                raise ValueError(
                    f"affine structure not scalar/diagonal for {spec.kind}")
            if not self.entry.elementwise:
                raise ValueError(
                    f"{spec.kind} requires scalar affine scaling")
            # diagonal reduction with zero handling
            lam = np.zeros_like(beta)
            delta = np.zeros_like(beta)
            nz = gamma != 0
            lam[nz] = spec.alpha * beta[nz] ** 2 / gamma[nz]
            beta = np.where(nz, beta, 1.0)
            gamma = np.where(nz, gamma, 1.0)
            delta[~nz] = 1.0
            B0 = BlockMatrix({(k, k): linop.diagonal(beta / gamma)
                              for k in H.col_keys()})
            C0 = BlockMatrix({(k, k): linop.diagonal(1.0 / beta)
                              for k in H.col_keys()})
            D0 = BlockMatrix({(k, k): linop.diagonal(delta)
                              for k in H.col_keys()})
            self.B = H @ B0 @ AT
            self.C = C0 @ HT
            self.D = (AT @ A).inverse() @ D0 @ AT
            self.lam = lam
            self.elementwise = True

        # argument bookkeeping
        self.n_args = len(spec.arg_sizes) if spec.arg_sizes else 1
        self.arg_dims = [int(np.prod(s)) if s else 1 for s in (spec.arg_sizes or [None])]
        if not spec.arg_sizes:
            self.arg_dims = [affine_arg.A.row_dim(arg_key(0))]

    # -- kernel invocation -------------------------------------------------
    def _params(self) -> Dict:
        p = dict(self.spec.scaled_zone_params or {})
        if self.spec.k is not None:
            p["k"] = self.spec.k
        return p

    def _lam(self):
        if isinstance(self.lam, np.ndarray):
            return linop._cached(self, "_tlam", lambda: linop.to_tensor(self.lam))
        return self.lam

    def _kernel_args(self, u: BlockVector) -> List[torch.Tensor]:
        return [u.get(arg_key(i), self.arg_dims[i]) for i in range(self.n_args)]

    def apply(self, v: BlockVector) -> BlockVector:
        g = self.g.to_device()
        u = self.B.apply(v) + g
        vals = self._kernel_args(u)
        y = BlockVector({arg_key(0): self.entry.prox(vals[0], self._lam(),
                                                     **self._params())})
        x = self.C.apply(y - g)
        if self.D is not None:
            x = x + self.D.apply(v)
        return x

    def feval(self, u: BlockVector):
        return self.entry.feval(self._kernel_args(u)[0], **self._params())


# ---------------------------------------------------------------------------
# KKT-based operators
# ---------------------------------------------------------------------------

# Same threshold as the JAX package, so both take the same branch.
_COLLAPSE_MAX_ENTRIES = float(os.environ.get(
    "EPSILON_TPU_COLLAPSE_MAX_ENTRIES", "1.6e7"))


class _CollapsedKKT:
    """Explicit solve operator ``x = S v + c`` folded out of a factored KKT
    system by basis solves: one dense matvec per apply in place of the
    substitution chain, used when it is smaller than the factor
    (``factor_nnz`` cost model)."""

    def __init__(self, chol, rhs0, out_dims: Dict[str, int],
                 in_dims: Dict[str, int]):
        dtype = config.default_np_dtype()
        self.in_keys = sorted(in_dims)
        self.out_keys = sorted(out_dims)
        self.in_dims = dict(in_dims)
        self.out_dims = dict(out_dims)
        n_in = sum(in_dims.values())
        basis = {}
        off = 0
        for k in self.in_keys:
            nk = in_dims[k]
            E = np.zeros((nk, n_in), dtype=dtype)
            E[:, off:off + nk] = np.eye(nk, dtype=dtype)
            basis[k] = linop.to_tensor(E)
            off += nk
        sol = chol.solve_mat(basis)
        self.S = torch.cat([sol[k] for k in self.out_keys], dim=0)
        csol = chol.solve(rhs0.to_device())
        self.c = torch.cat([
            (csol[k] if k in csol else self.S.new_zeros(())).to(self.S.dtype)
            .expand(out_dims[k]) for k in self.out_keys])
        self._offs = {}
        off = 0
        for k in self.out_keys:
            self._offs[k] = off
            off += out_dims[k]

    @staticmethod
    def viable(chol, out_dims, in_dims) -> bool:
        entries = float(sum(in_dims.values())) * sum(out_dims.values())
        return (entries <= _COLLAPSE_MAX_ENTRIES
                and entries < chol.factor_nnz())

    def apply(self, v: BlockVector) -> BlockVector:
        flat = torch.cat([v.get(k, self.in_dims[k]) for k in self.in_keys])
        y = self.S @ flat + self.c
        return BlockVector({k: y[self._offs[k]:self._offs[k] + self.out_dims[k]]
                            for k in self.out_keys})


def _maybe_collapse(chol, rhs0, A: BlockMatrix, var_keys, var_dims_of):
    """Build the collapsed solve operator when it beats the factor chain;
    ``A`` supplies the input (metric-row) key space, ``var_keys`` the
    output selection."""
    in_dims = {r: A.row_dim(r) for r in A.row_keys()}
    out_dims = {k: var_dims_of(k) for k in var_keys}
    if not in_dims or not out_dims:
        return None
    if not _CollapsedKKT.viable(chol, out_dims, in_dims):
        return None
    return _CollapsedKKT(chol, rhs0, out_dims, in_dims)


def _kkt_blocks(*mats: BlockMatrix) -> BlockMatrix:
    out = BlockMatrix()
    for M in mats:
        for (r, c), op in M.blocks.items():
            out.insert(r, c, op)
    return out


def _metric_change_of_vars(A: BlockMatrix, *others: BlockMatrix):
    """De-collide (k, k)-keyed per-variable metrics in the assembled KKT.

    The solvers pass the prox metric as ``A = w_k * I`` keyed ``(k, k)``
    per variable ``k``; ``_kkt_blocks`` then merges A, A' and the -I slack
    into one slot, and the merged system equals the true 3-block KKT iff
    every colliding weight is 1.  Substituting ``x~_k = w_k x_k`` (an exact
    change of variables) makes the colliding metric the identity: every
    block column over ``k`` scales by ``1/w_k`` and solutions de-scale by
    ``1/w_k``.  Returns ``{k: 1/w_k}`` for the colliding non-unit scalar
    blocks; raises on a colliding non-scalar metric.
    """
    cols = {c for (_, c) in A.blocks}
    for M in others:
        cols |= {c for (_, c) in M.blocks}
    descale = {}
    for (r, c), op in A.blocks.items():
        if r == c and r in cols:
            w = op.scalar_value()
            if w is None:
                raise ValueError(
                    f"non-scalar prox metric collides with variable {r!r}: "
                    "the assembled KKT would merge A/A'/-I incorrectly")
            if w != 1.0:
                descale[c] = 1.0 / w
    return descale


def _scale_cols(M: BlockMatrix, descale: Dict) -> BlockMatrix:
    if not descale:
        return M
    return BlockMatrix({
        (r, c): (op.scale(descale[c]) if c in descale else op)
        for (r, c), op in M.blocks.items()})


def _descale_solution(x: BlockVector, descale: Dict) -> BlockVector:
    if not descale:
        return x
    return BlockVector({k: (descale[k] * v if k in descale else v)
                        for k, v in x.items()})


class _KKTProxOperator(ProxOperator):
    """Shared apply of the KKT operators: the factored (or collapsed)
    system solved at ``rhs0 + v``, restricted to the variable blocks."""

    def _finish_init(self, A: BlockMatrix):
        self._collapsed = _maybe_collapse(
            self.chol, self.rhs0, A, self.var_keys,
            lambda k: self.chol._dims[k])

    def apply(self, v: BlockVector) -> BlockVector:
        if self._collapsed is not None:
            return _descale_solution(self._collapsed.apply(v), self._descale)
        x = self.chol.solve(self.rhs0.to_device() + v,
                            keys=self.var_keys).select(self.var_keys)
        return _descale_solution(x, self._descale)


class ZeroProxOperator(_KKTProxOperator):
    """Projection onto {H(x) + g = 0} in the metric ||A(x) - v||: solve
        [ 0   H'  A'][x]   [ 0]
        [ H   0   0 ][y] = [-g]
        [ A   0  -I ][z]   [ v]
    """

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        self._descale = _metric_change_of_vars(A, H)
        H = _scale_cols(H, self._descale)
        A = _scale_cols(A, self._descale)
        M = _kkt_blocks(H, H.T, A, A.T,
                        A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        self.rhs0 = -1.0 * g
        self.var_keys = H.col_keys()
        self._finish_init(A)


class AffineProxOperator(_KKTProxOperator):
    """f(x) = c'x (+ const): solve [0 A'; A -I][x; z] = [-c; v - b].  The
    linear functional c comes from H's 1-row blocks scaled by alpha."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        A, b = affine_constraint.A, affine_constraint.b
        self._descale = _metric_change_of_vars(A)
        A = _scale_cols(A, self._descale)
        M = _kkt_blocks(A, A.T, A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        c = BlockVector()
        if spec.kind == ProxKind.AFFINE:
            for (r, ckey), op in affine_arg.A.blocks.items():
                dense = op.as_dense()
                if dense.shape[0] != 1:
                    raise ValueError("affine arg must be 1-row")
                # linear functional in the x~ = w x variables: c' D^-1 x~
                vec = dense[0] * spec.alpha * self._descale.get(ckey, 1.0)
                c[ckey] = c[ckey] + vec if ckey in c else vec
        self.rhs0 = -1.0 * b - c
        self.var_keys = A.col_keys()
        self._finish_init(A)


class SumSquareProxOperator(_KKTProxOperator):
    """f = alpha*||H(x) + g||^2: solve
        [ 0    aH'  A'][x]   [  0 ]
        [ aH   -I   0 ][y] = [-ag ]
        [ A    0   -I ][z]   [  v ]
    with a = sqrt(2*alpha)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        self._descale = _metric_change_of_vars(A, H)
        H = _scale_cols(H, self._descale)
        A = _scale_cols(A, self._descale)
        a = float(np.sqrt(2.0 * spec.alpha))
        Ha = BlockMatrix({k: op.scale(a) for k, op in H.blocks.items()})
        M = _kkt_blocks(Ha, Ha.T, A, A.T,
                        H.left_identity().scale(-1.0),
                        A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        self.rhs0 = (-a) * g
        self.var_keys = H.col_keys()
        self._finish_init(A)


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def create_prox_operator(spec: ProxFunctionSpec,
                         affine_arg: AffineOperator,
                         affine_constraint: AffineOperator) -> ProxOperator:
    kind = spec.kind
    if kind == ProxKind.ZERO:
        return ZeroProxOperator(spec, affine_arg, affine_constraint)
    if kind in (ProxKind.AFFINE, ProxKind.CONSTANT):
        return AffineProxOperator(spec, affine_arg, affine_constraint)
    if kind == ProxKind.SUM_SQUARE and not spec.epigraph:
        return SumSquareProxOperator(spec, affine_arg, affine_constraint)
    if kind == ProxKind.SECOND_ORDER_CONE:
        raise NotImplementedError("the second-order-cone prox operator is not yet ported")
    return VectorProxOperator(spec, affine_arg, affine_constraint)
