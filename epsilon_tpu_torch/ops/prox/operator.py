"""Generalized prox operators over block affine structure.

Counterpart of ``epsilon_tpu/ops/prox/operator.py``.  Every operator
solves

    Apply(v)  =  argmin_x  alpha * f(H(x))  +  1/2 ||A(x) - v||^2

where ``H`` (the function's affine argument) and ``A`` (the scaled
constraint columns) are block linear operators:

- :class:`VectorProxOperator` — canonical kernel behind the scalar or
  diagonal reduction, with the pre/post transforms v' = B v + g,
  x = C (y - g) + D v, in every mode: prox or epigraph, on vectors, on
  matrices, on two arguments, and per slice (axis mode, batched along the
  rows of one kernel call); warm-startable kernels thread their state.
- KKT operators (:class:`ZeroProxOperator`, :class:`AffineProxOperator`,
  :class:`SumSquareProxOperator`) — cached block-Cholesky solves, folded
  into one dense solve operator (:class:`_CollapsedKKT`) when that is
  smaller than the factor.
- :class:`SecondOrderConeProxOperator` — row-wise SOC projection with
  scalar scalings.

- The rho-parameterized operators of adaptive rho
  (:func:`create_rho_prox_operator`): ``apply_rho(v, rho)`` solves
  ``argmin alpha f(H x + g) + rho/2 ||x - v||^2`` with ``rho`` a 0-d tensor
  on the device, so a change of rho costs no refactorization.

Structure analysis and factorization run eagerly at construction; ``apply``
runs on tensors.
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
from . import vector as veckernels
from .registry import (KernelEntry, epigraph_via_bisection, get_kernel,
                       kernel_params)


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

        if spec.epigraph and self.elementwise:
            raise ValueError("epigraph projection requires isotropic metric "
                             "(scalar affine scaling)")

        # argument bookkeeping
        self.n_args = len(spec.arg_sizes) if spec.arg_sizes else 1
        self.arg_dims = [int(np.prod(s)) if s else 1 for s in (spec.arg_sizes or [None])]
        if not spec.arg_sizes:
            self.arg_dims = [affine_arg.A.row_dim(arg_key(0))]

    # -- kernel invocation -------------------------------------------------
    def _params(self) -> Dict:
        return linop._cached(self, "_tparams", lambda: kernel_params(self.spec))

    def _lam(self, rho=None):
        lam = self.lam
        if isinstance(lam, np.ndarray):
            lam = linop._cached(self, "_tlam", lambda: linop.to_tensor(self.lam))
        return lam if rho is None else lam / rho

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        """Apply at penalty rho (a 0-d tensor):  argmin alpha f(H x + g)
        + rho/2 ||x - v||^2.  Valid when the operator was built with A = I
        (unit constraint metric): then B, C and D do not depend on rho and
        the penalty enters through lam -> lam/rho alone (epigraph
        projections ignore it)."""
        return self.apply(v, rho=rho)

    def _kernel_args(self, u: BlockVector) -> List[torch.Tensor]:
        return [u.get(arg_key(i), self.arg_dims[i]) for i in range(self.n_args)]

    def _mat(self, val):
        return linop.jmat(val, tuple(self.spec.arg_sizes[0]))

    def _slices(self, val):
        """mat(val) with one slice per row: axis 0 reduces along columns,
        so the kernel runs on the rows of its transpose."""
        V = self._mat(val)
        return V.T if self.spec.axis == 0 else V

    def _unslice(self, X):
        return linop.jvec(X.T if self.spec.axis == 0 else X)

    def _apply_kernel(self, vals: List[torch.Tensor], rho=None) -> List[torch.Tensor]:
        spec, entry, p = self.spec, self.entry, self._params()
        if spec.epigraph:
            epi = entry.epi or epigraph_via_bisection(spec.kind)
            if entry.matrix:
                X, t = epi(self._mat(vals[0]), vals[-1][0], **p)
                return [linop.jvec(X), t.reshape(1)]
            if entry.nargs == 2:
                x, y, t = epi((vals[0], vals[1]), vals[-1][0], **p)
                return [x, y, t.reshape(1)]
            if spec.axis is not None:
                # one epigraph projection per slice, batched along the rows
                X, t = epi(self._slices(vals[0]), vals[-1], **p)
                return [self._unslice(X), t]
            if entry.elementwise_epi:
                # per-coordinate epigraph: t is the same size as x
                return list(epi(vals[0], vals[-1], **p))
            x, t = epi(vals[0], vals[-1][0], **p)
            return [x, t.reshape(1)]

        lam = self._lam(rho)
        if entry.matrix:
            return [linop.jvec(entry.prox(self._mat(vals[0]), lam, **p))]
        if entry.nargs == 2:
            return list(entry.prox((vals[0], vals[1]), lam, **p))
        if spec.axis is not None and not entry.elementwise:
            # one vector kernel per slice, batched along the rows (a
            # separable kernel's per-slice prox is its flat prox)
            return [self._unslice(entry.prox(self._slices(vals[0]), lam, **p))]
        return [entry.prox(vals[0], lam, **p)]

    def _finish(self, v: BlockVector, outs: List[torch.Tensor]) -> BlockVector:
        y = BlockVector({arg_key(i): outs[i] for i in range(len(outs))})
        x = self.C.apply(y - self.g.to_device())
        if self.D is not None:
            x = x + self.D.apply(v)
        return x

    def apply(self, v: BlockVector, rho=None) -> BlockVector:
        u = self.B.apply(v) + self.g.to_device()
        return self._finish(v, self._apply_kernel(self._kernel_args(u), rho=rho))

    # -- warm-startable (stateful) kernels ---------------------------------
    def kernel_state_init(self):
        """Cold state for kernels that warm-start across ADMM sweeps (TV-1D:
        the PDAS dual), or None where this operator's mode cannot thread it
        (epigraph, diagonal metric, axis batching, two arguments)."""
        if (self.entry.stateful_prox is None or self.spec.epigraph
                or self.elementwise or self.spec.axis is not None
                or self.n_args != 1):
            return None
        return self.entry.state_init(self.arg_dims[0], config.default_dtype())

    def apply_stateful(self, v: BlockVector, kstate, rho=None):
        """:meth:`apply` threading the kernel's warm state; returns
        ``(x, new_state)``.  Valid when :meth:`kernel_state_init` is not
        None."""
        u = self.B.apply(v) + self.g.to_device()
        x_k, st = self.entry.stateful_prox(self._kernel_args(u)[0],
                                           self._lam(rho), kstate,
                                           **self._params())
        return self._finish(v, [x_k]), st

    def feval(self, u: BlockVector):
        vals = self._kernel_args(u)
        p = self._params()
        if self.entry.nargs == 2:
            return self.entry.feval((vals[0], vals[1]), **p)
        if self.entry.matrix:
            return self.entry.feval(self._mat(vals[0]), **p)
        return self.entry.feval(vals[0], **p)


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
# Second-order cone
# ---------------------------------------------------------------------------

class SecondOrderConeProxOperator(ProxOperator):
    """Row-wise SOC projection ||ax*x_i + bx|| <= at*t_i + bt_i;
    arg0 = t (m,), arg1 = X (m, n)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        if len(spec.arg_sizes) != 2:
            raise ValueError("SOC takes two arguments")
        self.m, self.n = spec.arg_sizes[1]
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        self.t_key = self.x_key = None
        at = ax = None
        for (r, c), op in H.blocks.items():
            if r == arg_key(0):
                self.t_key, at = c, op.scalar_value()
            elif r == arg_key(1):
                self.x_key, ax = c, op.scalar_value()
            else:
                raise ValueError(f"unexpected arg row {r}")
        if at is None or ax is None:
            raise ValueError("SOC scalings must be scalar")
        ATA = A.T @ A
        alphat = ATA[(self.t_key, self.t_key)].scalar_value()
        alphax = ATA[(self.x_key, self.x_key)].scalar_value()
        if alphat is None or alphax is None or not np.isclose(alphat, alphax):
            raise ValueError("A'A not scalar for SOC")
        self.AT = A.T.scale(1.0 / alphat)
        self.a = at / abs(ax)
        g_np = {k: np.asarray(val) for k, val in g.items()}
        bt = g_np.get(arg_key(0), np.zeros(self.m))
        bx = g_np.get(arg_key(1), np.zeros(self.m * self.n))
        self._bt_host = np.asarray(bt, dtype=np.float64) / abs(ax)
        self._bx_host = np.asarray(bx, dtype=np.float64) / ax

    def apply(self, v: BlockVector) -> BlockVector:
        bt, bx = linop._cached(self, "_tb", lambda: (
            linop.to_tensor(self._bt_host), linop.to_tensor(self._bx_host)))
        u = self.AT.apply(v)
        X = linop.jmat(u[self.x_key] + bx, (self.m, self.n))
        t = u[self.t_key] + bt / self.a
        Xp, tp = veckernels.project_soc_rows(X, t, self.a)
        return BlockVector({self.x_key: linop.jvec(Xp) - bx,
                            self.t_key: tp - bt / self.a})


# ---------------------------------------------------------------------------
# rho-parameterized operators (adaptive-rho two-block ADMM)
# ---------------------------------------------------------------------------
#
# These solve  argmin_x alpha*f(H x + g) + rho/2 ||x - v||^2  with rho a 0-d
# tensor on the device, so residual-balancing adaptive rho (Boyd et al.
# 3.4.1) costs no refactorization: projections do not depend on rho,
# canonical kernels take lam/rho, and quadratics apply through a cached
# eigendecomposition (Q diag(1/(w+rho)) Q') instead of a Cholesky factor.


class RhoProjectionOperator(ProxOperator):
    """Wrapper for operators that do not depend on rho (indicators and
    projections: ZERO, SOC, every epigraph): ``apply_rho`` ignores rho."""

    def __init__(self, inner: ProxOperator):
        self.inner = inner

    def apply(self, v: BlockVector) -> BlockVector:
        return self.inner.apply(v)

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        return self.inner.apply(v)


class RhoAffineProxOperator(ProxOperator):
    """f(x) = alpha*c'x (+ const) at penalty rho:  x = v - c/rho (the
    closed form of :class:`AffineProxOperator` in the unit metric)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 var_dims: Dict[str, int]):
        self.var_dims = dict(var_dims)
        c: Dict[str, np.ndarray] = {}
        if spec.kind == ProxKind.AFFINE:
            for (r, ckey), op in affine_arg.A.blocks.items():
                dense = op.as_dense()
                if dense.shape[0] != 1:
                    raise ValueError("affine arg must be 1-row")
                vec = dense[0] * spec.alpha
                c[ckey] = c[ckey] + vec if ckey in c else vec
        self._c_host = {k: np.asarray(v, dtype=np.float64)
                        for k, v in c.items()}

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        c = linop._cached(self, "_tc", lambda: {
            k: linop.to_tensor(ck) for k, ck in self._c_host.items()})
        out = {}
        for k, n in self.var_dims.items():
            vk = v.get(k, n)
            if k in c:
                vk = vk - c[k] / rho
            out[k] = vk
        return BlockVector(out)

    def apply(self, v: BlockVector) -> BlockVector:
        return self.apply_rho(v, 1.0)


class RhoSumSquareProxOperator(ProxOperator):
    """f = alpha*||H x + g||^2 at penalty rho:
        x = Q diag(1/(w + rho)) Q' (rho v - 2 alpha H'g),
    where Q w Q' = eigh(2 alpha H'H), computed once on the host in float64:
    the eigendecomposition analogue of the cached Cholesky factor that stays
    valid for every rho.  The two products with Q run on the device."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 var_dims: Dict[str, int]):
        H, g = affine_arg.A, affine_arg.b
        self.col_keys = sorted(var_dims)
        self.var_dims = dict(var_dims)
        # dense H with rows/cols in sorted-key order (cols may include
        # variables H never touches; pad with zero columns)
        rows = H.row_keys()
        m = sum(H.row_dim(r) for r in rows)
        n = sum(var_dims[k] for k in self.col_keys)
        Hd = np.zeros((m, n))
        roff = {}
        acc = 0
        for r in rows:
            roff[r] = acc
            acc += H.row_dim(r)
        coff = {}
        acc = 0
        for k in self.col_keys:
            coff[k] = acc
            acc += var_dims[k]
        for (r, c), op in H.blocks.items():
            Hd[roff[r]:roff[r] + op.m, coff[c]:coff[c] + op.n] = op.as_dense()
        g_flat = np.zeros(m)
        for r, val in g.items():
            g_flat[roff[r]:roff[r] + len(np.asarray(val))] = np.asarray(val)
        G = 2.0 * spec.alpha * (Hd.T @ Hd)
        w, Q = np.linalg.eigh(G)
        self._w_host = np.maximum(w, 0.0)  # G is PSD; clip eigh noise
        self._Q_host = Q
        self._r0_host = -2.0 * spec.alpha * (Hd.T @ g_flat)
        self._coff = coff

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        Q, w, r0 = linop._cached(self, "_tdev", lambda: tuple(
            linop.to_tensor(a) for a in (self._Q_host, self._w_host,
                                         self._r0_host)))
        parts = [v.get(k, self.var_dims[k]) for k in self.col_keys]
        flat = torch.cat(parts) if parts else Q.new_zeros(0)
        t = rho * flat + r0
        x = Q @ ((Q.T @ t) / (w + rho))
        return BlockVector({k: x[self._coff[k]:self._coff[k] + self.var_dims[k]]
                            for k in self.col_keys})

    def apply(self, v: BlockVector) -> BlockVector:
        return self.apply_rho(v, 1.0)


def create_rho_prox_operator(spec: ProxFunctionSpec,
                             affine_arg: AffineOperator,
                             var_dims: Dict[str, int]) -> ProxOperator:
    """Factory for rho-parameterized operators in the unit constraint
    metric (A = I over ``var_dims``); every returned operator supports
    ``apply_rho(v, rho)`` with rho a 0-d tensor."""
    kind = spec.kind
    eye = BlockMatrix({(k, k): linop.identity(n)
                       for k, n in var_dims.items()})
    unit = AffineOperator(eye, BlockVector())
    if kind == ProxKind.ZERO:
        return RhoProjectionOperator(ZeroProxOperator(spec, affine_arg, unit))
    if kind in (ProxKind.AFFINE, ProxKind.CONSTANT):
        return RhoAffineProxOperator(spec, affine_arg, var_dims)
    if kind == ProxKind.SUM_SQUARE and not spec.epigraph:
        return RhoSumSquareProxOperator(spec, affine_arg, var_dims)
    if kind == ProxKind.SECOND_ORDER_CONE:
        return RhoProjectionOperator(
            SecondOrderConeProxOperator(spec, affine_arg, unit))
    op = VectorProxOperator(spec, affine_arg, unit)
    if spec.epigraph:
        return RhoProjectionOperator(op)
    return op  # VectorProxOperator.apply_rho takes lam/rho


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
        return SecondOrderConeProxOperator(spec, affine_arg, affine_constraint)
    return VectorProxOperator(spec, affine_arg, affine_constraint)
