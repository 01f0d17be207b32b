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
    """Base class.

    Scenario stacking (``solvers/scenario.py``) asks an operator over ONE
    variable ``var`` three things, so that S such operators can apply as one
    batched call on ``(S, d)`` inputs:

    - :meth:`stack_signature` — a hashable structural signature (apply
      path, mode, every scalar by value, shapes and dtypes of every data
      array), or None when the operator cannot stack.  Two operators stack
      only on equal signatures, so whatever a signature leaves out must be
      in :meth:`stack_data`.
    - :meth:`stack_data` — the per-term data arrays, in a fixed order.
    - :meth:`stacked_fn` — ``fn(data, V, rho=None) -> X`` over those arrays
      with a leading ``(S, ...)`` axis; it keeps nothing of this operator's
      own data alive, so the operator can be dropped once its arrays are
      stacked.  Where :meth:`stacked_state_init` gives a kernel's warm
      state for one row, the stack threads it: ``fn(data, V, rho, state)
      -> (X, state)`` with ``state`` one row per row of the stack.
    """

    def apply(self, v: BlockVector) -> BlockVector:
        raise NotImplementedError

    def capturable(self) -> bool:
        """Whether :meth:`apply` (and ``apply_rho``), after a first call that
        uploads the operator's data, launches device work alone: no host
        sync, no host read of device data, no host control flow on it and no
        upload, so that a CUDA graph of the ADMM epoch may capture it."""
        return False

    def stack_signature(self, var: str):
        return None

    def stack_data(self, var: str) -> List:
        raise NotImplementedError

    def stacked_fn(self, var: str):
        raise NotImplementedError

    def stacked_state_init(self, var: str):
        return None


def _np_sig(a) -> tuple:
    """Shape and dtype of a data array, for a signature."""
    return (tuple(a.shape), str(a.dtype).replace("torch.", ""))


def _batched_matvec(M, V):
    """``M[s] @ V[s]`` for every s: M (S, m, n), V (S, n)."""
    return torch.bmm(M, V.unsqueeze(-1)).squeeze(-1)


class _Part:
    """One linear block of a stackable operator, batched over the leading
    axis of its stacked data: ``apply(data, V)`` and ``apply_t(data, V)``
    (the transpose) take ``V`` of shape ``(S, k, n)`` (k vectors per row
    of the stack) and return ``(S, k, m)``; ``data`` holds the block's own
    stacked arrays alone.  ``sig`` names the structure (scalars by value),
    ``arrays`` are the per-term data in a fixed order."""

    def __init__(self, sig, arrays, apply, apply_t):
        self.sig, self.arrays = sig, list(arrays)
        self.apply, self.apply_t = apply, apply_t


def _sparse_apply(m: int, transpose: bool):
    """Batched sparse product from the stacked COO arrays ``(values, rows,
    cols)``, one pattern per row of the stack (so the patterns may differ
    from row to row): gather the inputs, scatter-add the products into
    ``m`` outputs; the transpose swaps rows and columns."""
    def fn(data, V):
        vals, r, c = data
        if transpose:
            r, c = c, r
        S, k = V.shape[0], V.shape[1]
        prod = vals[:, None, :] * V.gather(2, c[:, None, :].expand(S, k, -1))
        out = V.new_zeros((S, k, m))
        return out.scatter_add_(2, r[:, None, :].expand(S, k, -1), prod)
    return fn


def _kron_apply(A: "_Part", B: "_Part", nA: int, shapes, trans: bool):
    """``(A (x) B) vec(X)`` = vec(B X A^T) over a stack, with the children
    batched: the k vectors and the columns of X fold into the child's k."""
    (am, an), (bm, bn) = shapes
    if trans:
        (am, an), (bm, bn) = (an, am), (bn, bm)

    def fn(data, V):
        a_data, b_data = data[:nA], data[nA:]
        ap = A.apply_t if trans else A.apply
        bp = B.apply_t if trans else B.apply
        S, k = V.shape[0], V.shape[1]
        Xt = V.reshape(S, k * an, bn)                 # rows: columns of X
        W = bp(b_data, Xt).reshape(S, k, an, bm)      # (B X)^T per vector
        Wt = W.transpose(2, 3).reshape(S, k * bm, an)  # rows of B X
        Y = ap(a_data, Wt).reshape(S, k, bm, am)      # B X A^T per vector
        return Y.transpose(2, 3).reshape(S, k, am * bm)
    return fn


def _stack_block(op) -> Optional[_Part]:
    """The :class:`_Part` of one linear block: a scalar (by value, no data),
    a diagonal, a dense matrix, a sparse matrix (applied densely where the
    port densifies it, else as a gather-scatter product with the pattern
    stacked beside the values: the JAX package lifts a BCOO's indices as
    data too, so patterns of equal nnz stack in both), a Kronecker product
    (its two factors' parts), or a cached factor applied as its
    ``apply_mode()`` says; None for any other structure."""
    sv = op.scalar_value()
    if sv is not None:
        f = (lambda data, V: V) if sv == 1.0 else (lambda data, V: sv * V)
        return _Part(("scalar", op.n, float(sv)), [], f, f)
    if isinstance(op, linop.DiagonalOp):
        f = lambda data, V: data[0][:, None, :] * V
        return _Part(("diag",) + _np_sig(op.d), [op.d], f, f)
    if isinstance(op, linop.SparseOp) and not op.densified():
        coo = op.A.tocoo()
        m, n = op.shape
        rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
        return _Part(("sparse", op.shape, int(coo.nnz), str(coo.data.dtype)),
                     [coo.data, rows, cols], _sparse_apply(m, False),
                     _sparse_apply(n, True))
    if isinstance(op, (linop.DenseOp, linop.SparseOp)):
        A = op.as_dense().astype(linop._dtype(), copy=False)
        return _Part(("dense",) + _np_sig(A), [A],
                     lambda data, V: V @ data[0].transpose(1, 2),
                     lambda data, V: V @ data[0])
    if isinstance(op, linop.KronOp):
        a, b = _stack_block(op.A), _stack_block(op.B)
        if a is None or b is None:
            return None
        shapes, nA = (op.A.shape, op.B.shape), len(a.arrays)
        return _Part(("kron", a.sig, b.sig), a.arrays + b.arrays,
                     _kron_apply(a, b, nA, shapes, False),
                     _kron_apply(a, b, nA, shapes, True))
    if isinstance(op, linop.LuFactorOp):
        return _stack_factor(op)
    return None


def _stack_factor(op) -> _Part:
    """A cached factor ``M^{-1}`` over a stack, by ``op.apply_mode()``:
    batched triangular solves for ``"solve"``, else the explicit inverse
    (the sym_packed storage of one factor has no batched form; the product
    is the same)."""
    n = op.shape[0]
    if op.apply_mode() != "solve":
        inv = op._host_inv()
        return _Part(("inverse",) + _np_sig(inv), [inv],
                     lambda data, V: V @ data[0].transpose(1, 2),
                     lambda data, V: V @ data[0])

    def lu(adjoint):
        def fn(data, V):
            return torch.linalg.lu_solve(data[0], data[1], V.transpose(1, 2),
                                         adjoint=adjoint).transpose(1, 2)
        return fn
    return _Part(("lu", n, op.transposed), [op.lu, (op.piv + 1).astype(np.int32)],
                 lu(op.transposed), lu(not op.transposed))


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

    def capturable(self) -> bool:
        """A plain elementwise prox (the kernel entry's flag; no warm
        state, no epigraph loop) between capturable affine maps."""
        return (self.entry.capturable and self.entry.stateful_prox is None
                and not self.spec.epigraph and self.B.capturable()
                and self.C.capturable()
                and (self.D is None or self.D.capturable()))

    # -- scenario stacking ---------------------------------------------------
    def _stack_parts(self, var: str):
        """``(B, C, D)`` of the stacked apply: B and C as lists of
        ``(argument index, part)``, D a list of one part or None.  None when
        a block does not map between ``var`` and the arguments, when a block
        does not stack (:func:`_stack_block`), or for a kernel with
        data-dependent host control flow (TV-1D's PDAS) per slice, where
        its rows would have to loop twice."""
        spec, entry = self.spec, self.entry
        if entry.stateful_prox is not None and (
                spec.axis is not None or self.n_args != (2 if spec.epigraph else 1)):
            return None
        args = {arg_key(i): i for i in range(self.n_args)}

        def parts(M, arg_of):
            out = []
            for key in sorted(M.blocks):
                i = arg_of(key)
                part = None if i is None else _stack_block(M.blocks[key])
                if part is None:
                    return None
                out.append((i, part))
            return out

        B = parts(self.B, lambda k: args.get(k[0]) if k[1] == var else None)
        C = parts(self.C, lambda k: args.get(k[1]) if k[0] == var else None)
        D = None if self.D is None else parts(
            self.D, lambda k: 0 if k == (var, var) else None)
        if (B is None or not C or (self.D is not None and D is None)
                or set(self.g.keys()) - set(args)):
            return None
        return B, C, D

    def stack_signature(self, var: str):
        parts = self._stack_parts(var)
        if parts is None:
            return None
        B, C, D = parts
        spec = self.spec
        params = tuple(sorted(
            (k, (_np_sig(v), np.asarray(v).tobytes()) if hasattr(v, "shape")
             else v) for k, v in (spec.scaled_zone_params or {}).items()))
        lam = (_np_sig(self.lam) if isinstance(self.lam, np.ndarray)
               else float(self.lam))
        g = tuple((k, tuple(np.shape(v))) for k, v in sorted(self.g.items()))
        return ("vector", spec.kind.value, spec.k, params, lam, spec.epigraph,
                spec.axis, tuple(tuple(a) for a in spec.arg_sizes),
                tuple(self.arg_dims), g,
                tuple((i, p.sig) for i, p in B), tuple((i, p.sig) for i, p in C),
                None if D is None else D[0][1].sig, self._threads_state())

    def stack_data(self, var: str) -> List:
        B, C, D = self._stack_parts(var)
        data = [a for _, p in B + C + (D or []) for a in p.arrays]
        if isinstance(self.lam, np.ndarray):
            data.append(self.lam)
        return data + [v for _, v in sorted(self.g.items())]

    def stacked_state_init(self, var: str):
        """The cold warm-start state of one row of a stack, or None for a
        kernel without one (:meth:`kernel_state_init`)."""
        return self.kernel_state_init()

    def _stacked_kernel(self):
        """The kernel over a stack: ``k(U, lam) -> Y`` with ``U`` and ``Y``
        one ``(S, dim)`` tensor per argument.  Every mode but TV-1D runs once
        over the stack (its kernels broadcast over leading axes, as the
        per-slice mode already uses them); TV-1D's PDAS has host control
        flow that depends on the data, so it loops over the rows and threads
        each row's warm dual: ``k(U, lam, state) -> (Y, state)`` (its
        epigraph, a bisection over PDAS, loops the same way)."""
        spec, entry, p = self.spec, self.entry, self._params()
        shape = tuple(spec.arg_sizes[0]) if spec.arg_sizes else None
        axis = spec.axis

        def slices(U0):
            V = linop.jmat(U0, shape)
            V = V.transpose(-1, -2) if axis == 0 else V
            return V.reshape(-1, V.shape[-1]), V.shape

        def unslice(X, shp):
            X = X.reshape(shp)
            return linop.jvec(X.transpose(-1, -2) if axis == 0 else X)

        if entry.stateful_prox is not None and spec.epigraph:
            epi = entry.epi or epigraph_via_bisection(spec.kind)

            def k(U, lam):
                rows = [epi(u, t[0], **p) for u, t in zip(U[0], U[-1])]
                return [torch.stack([r[0] for r in rows]),
                        torch.stack([r[1] for r in rows]).reshape(-1, 1)]
            return k
        if entry.stateful_prox is not None:
            def k(U, lam, state=None):
                if state is None:
                    return [torch.stack([entry.prox(u, lam, **p) for u in U[0]])]
                rows = [entry.stateful_prox(u, lam, st, **p)
                        for u, st in zip(U[0], state)]
                return ([torch.stack([r[0] for r in rows])],
                        torch.stack([r[1] for r in rows]))
            return k
        if spec.epigraph:
            epi = entry.epi or epigraph_via_bisection(spec.kind)
            if entry.matrix:
                def k(U, lam):
                    X, t = epi(linop.jmat(U[0], shape), U[-1][:, 0], **p)
                    return [linop.jvec(X), t.reshape(-1, 1)]
            elif entry.nargs == 2:
                def k(U, lam):
                    x, y, t = epi((U[0], U[1]), U[-1][:, 0], **p)
                    return [x, y, t.reshape(-1, 1)]
            elif axis is not None:
                def k(U, lam):
                    rows, shp = slices(U[0])
                    X, t = epi(rows, U[-1].reshape(-1), **p)
                    return [unslice(X, shp), t.reshape(U[-1].shape)]
            elif entry.elementwise_epi:
                def k(U, lam):
                    return list(epi(U[0], U[-1], **p))
            else:
                def k(U, lam):
                    x, t = epi(U[0], U[-1][:, 0], **p)
                    return [x, t.reshape(-1, 1)]
            return k
        prox = entry.prox
        if entry.matrix:
            return lambda U, lam: [linop.jvec(prox(linop.jmat(U[0], shape), lam, **p))]
        if entry.nargs == 2:
            return lambda U, lam: list(prox((U[0], U[1]), lam, **p))
        if axis is not None and not entry.elementwise:
            def k(U, lam):
                rows, shp = slices(U[0])
                return [unslice(prox(rows, lam, **p), shp)]
            return k
        return lambda U, lam: [prox(U[0], lam, **p)]

    def stacked_fn(self, var: str):
        """``fn(data, V, rho=None, state=None)``: the applies of a stack,
        ``x = C (k(B v + g) - g) + D v`` per row, with ``(X, new state)``
        returned when a state is threaded."""
        B, C, D = self._stack_parts(var)
        kernel = self._stacked_kernel()
        lam0 = None if isinstance(self.lam, np.ndarray) else float(self.lam)
        arg_of = {arg_key(i): i for i in range(self.n_args)}
        g_args = [arg_of[k] for k, _ in sorted(self.g.items())]
        dims = list(self.arg_dims)
        # C maps each argument's output back; D (argument None) reads v
        post = C + [(None, p) for _, p in (D or [])]
        counts = [len(p.arrays) for _, p in B + post]

        def fn(data, V, rho=None, state=None):
            chunks, pos = [], 0
            for n in counts:
                chunks.append(data[pos:pos + n])
                pos += n
            lam = lam0
            if lam is None:
                lam, pos = data[pos], pos + 1
            if rho is not None:
                lam = lam / rho
            g = dict(zip(g_args, data[pos:]))
            U = [None] * len(dims)
            for (i, p), dd in zip(B, chunks):
                t = p.apply(dd, V.unsqueeze(1)).squeeze(1)
                U[i] = t if U[i] is None else U[i] + t
            for i, gi in g.items():
                U[i] = gi if U[i] is None else U[i] + gi
            U = [V.new_zeros((V.shape[0], dims[i])) if u is None else u
                 for i, u in enumerate(U)]
            if state is None:
                Y = kernel(U, lam)
            else:
                Y, state = kernel(U, lam, state)
            for i, gi in g.items():
                Y[i] = Y[i] - gi
            X = None
            for (i, p), dd in zip(post, chunks[len(B):]):
                t = p.apply(dd, (V if i is None else Y[i]).unsqueeze(1)).squeeze(1)
                X = t if X is None else X + t
            return X if state is None else (X, state)
        return fn

    # -- warm-startable (stateful) kernels ---------------------------------
    def _threads_state(self) -> bool:
        return not (self.entry.stateful_prox is None or self.spec.epigraph
                    or self.elementwise or self.spec.axis is not None
                    or self.n_args != 1)

    def kernel_state_init(self):
        """Cold state for kernels that warm-start across ADMM sweeps (TV-1D:
        the PDAS dual), or None where this operator's mode cannot thread it
        (epigraph, diagonal metric, axis batching, two arguments)."""
        if not self._threads_state():
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
_COLLAPSE_MAX_ENTRIES = 1.6e7


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

    # the classes whose apply a CUDA graph may capture (:meth:`capturable`)
    _captures = False

    def _finish_init(self, A: BlockMatrix):
        self._collapsed = _maybe_collapse(
            self.chol, self.rhs0, A, self.var_keys,
            lambda k: self.chol._dims[k])

    def capturable(self) -> bool:
        """The collapsed solve (one dense product), or a substitution chain
        whose every block applies as a capturable product (the explicit
        inverse and dense GEMVs on the card)."""
        if not self._captures:
            return False
        if self._collapsed is not None:
            return True
        return all(D_inv.capturable() and all(op.capturable() for op in L.values())
                   for _, D_inv, L in self.chol._steps)

    def apply(self, v: BlockVector) -> BlockVector:
        if self._collapsed is not None:
            return _descale_solution(self._collapsed.apply(v), self._descale)
        x = self.chol.solve(self.rhs0.to_device() + v,
                            keys=self.var_keys).select(self.var_keys)
        return _descale_solution(x, self._descale)

    # -- scenario stacking ----------------------------------------------------
    # Every KKT operator over one variable applies alike (the class only
    # shaped the system), so the signatures name the apply path: the
    # collapsed solve ``x = w (S v + c)``, whose S and c are stacked data
    # (two families of different H heights share it), or the factored
    # substitution chain, whose structure (elimination order, each block's
    # key, kind and shape, scalars by value) is the signature and whose
    # factor values and right-hand-side constants are stacked data.
    def _chain_parts(self, var: str):
        """``(steps, needed, rhs keys)`` of the stacked chain: per pivot
        ``(key, dim, D^{-1} part, [(row key, L part)])``; None when a block
        does not stack."""
        chol = self.chol
        steps = []
        for pivot, D_inv, L in chol._steps:
            d = _stack_block(D_inv)
            ls = [(r, _stack_block(op)) for r, op in L.items()]
            if d is None or any(part is None for _, part in ls):
                return None
            steps.append((pivot, chol._dims[pivot], d, ls))
        return steps, chol._needed([var]), sorted(self.rhs0.keys())

    def stack_signature(self, var: str):
        if list(self.var_keys) != [var]:
            return None
        w = float(self._descale.get(var, 1.0))
        c = self._collapsed
        if c is not None:
            if c.in_keys != [var] or c.out_keys != [var]:
                return None
            return ("collapsed_kkt", w, _np_sig(c.S), _np_sig(c.c))
        parts = self._chain_parts(var)
        if parts is None:
            return None
        steps, needed, rhs = parts
        # the private variable's name differs from term to term
        key = lambda k: None if k == var else k
        return ("kkt_chain", w,
                tuple((key(k), n, d.sig, tuple((key(r), p.sig) for r, p in ls))
                      for k, n, d, ls in steps),
                tuple(sorted(needed - {var})),
                tuple((key(k), tuple(np.shape(self.rhs0[k]))) for k in rhs))

    def stack_data(self, var: str) -> List:
        if self._collapsed is not None:
            return [self._collapsed.S, self._collapsed.c]
        steps, _, rhs = self._chain_parts(var)
        data = [a for _, _, d, ls in steps
                for part in [d] + [p for _, p in ls] for a in part.arrays]
        return data + [np.asarray(self.rhs0[k]) for k in rhs]

    def stacked_fn(self, var: str):
        w = float(self._descale.get(var, 1.0))
        if self._collapsed is not None:
            def collapsed(data, V, rho=None):
                y = _batched_matvec(data[0], V) + data[1]
                return y if w == 1.0 else w * y
            return collapsed
        steps, needed, rhs = self._chain_parts(var)
        layout = [(k, n, d, ls, [len(d.arrays)] + [len(p.arrays) for _, p in ls])
                  for k, n, d, ls in steps]

        def chain(data, V, rho=None):
            """:meth:`BlockCholesky.solve` at ``rhs0 + v`` over the stack:
            forward substitution, the pivots' solves, back substitution of
            the blocks ``var`` depends on."""
            pos, blocks = 0, []
            for _, _, _, _, counts in layout:
                per = []
                for n in counts:
                    per.append(data[pos:pos + n])
                    pos += n
                blocks.append(per)
            work = dict(zip(rhs, data[pos:]))
            work[var] = work[var] + V if var in work else V
            mv = lambda part, dd, X: part.apply(dd, X.unsqueeze(1)).squeeze(1)
            y = {}
            for (k, n, _, ls, _), per in zip(layout, blocks):
                yp = work.get(k)
                if yp is None:
                    yp = V.new_zeros((V.shape[0], n))
                y[k] = yp
                for (r, p), dd in zip(ls, per[1:]):
                    upd = mv(p, dd, yp)
                    work[r] = work[r] - upd if r in work else -upd
            x = {}
            for (k, _, d, ls, _), per in reversed(list(zip(layout, blocks))):
                if k not in needed:
                    continue
                xp = mv(d, per[0], y[k])
                for (r, p), dd in zip(ls, per[1:]):
                    if r in x:
                        xp = xp - p.apply_t(dd, x[r].unsqueeze(1)).squeeze(1)
                x[k] = xp
            return x[var] if w == 1.0 else w * x[var]
        return chain


class ZeroProxOperator(_KKTProxOperator):
    """Projection onto {H(x) + g = 0} in the metric ||A(x) - v||: solve
        [ 0   H'  A'][x]   [ 0]
        [ H   0   0 ][y] = [-g]
        [ A   0  -I ][z]   [ v]
    """

    _captures = True

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

    _captures = True

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

    def capturable(self) -> bool:
        return self.inner.capturable()

    def stack_signature(self, var: str):
        sig = self.inner.stack_signature(var)
        return None if sig is None else ("rho_free",) + sig

    def stack_data(self, var: str) -> List:
        return self.inner.stack_data(var)

    def stacked_fn(self, var: str):
        inner = self.inner.stacked_fn(var)
        return lambda data, V, rho=None: inner(data, V)


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

    def stack_signature(self, var: str):
        if list(self.var_dims) != [var] or set(self._c_host) - {var}:
            return None
        return ("rho_affine", self.var_dims[var], var in self._c_host)

    def stack_data(self, var: str) -> List:
        return [self._c_host[var]] if var in self._c_host else []

    def stacked_fn(self, var: str):
        return lambda data, V, rho=None: (V - data[0] / rho) if data else V


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

    def capturable(self) -> bool:
        return True   # two dense products with the cached eigenvectors

    def stack_signature(self, var: str):
        if self.col_keys != [var]:
            return None
        # the height of H went into Q, w and r0, which are stacked data
        return ("rho_sum_square", self.var_dims[var])

    def stack_data(self, var: str) -> List:
        return [self._Q_host, self._w_host, self._r0_host]

    def stacked_fn(self, var: str):
        def fn(data, V, rho=None):
            Q, w, r0 = data
            t = _batched_matvec(Q.transpose(1, 2), rho * V + r0)
            return _batched_matvec(Q, t / (w + rho))
        return fn


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
