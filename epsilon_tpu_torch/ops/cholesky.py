"""Block LDL^T factorization with min-fill pivot ordering.

Counterpart of ``epsilon_tpu/ops/cholesky.py``.  The symbolic analysis
(greedy min-fill ordering with the structured-operator nonzero cost model)
and the numeric elimination (Schur complement ``A <- A - V D^{-1} V^T``)
run eagerly on the host at solver-init time; ``solve`` and ``solve_mat``
run the substitution chain on tensors.

Systems of three or more keys are ordered in one whole-system pass
(:func:`epsilon_tpu_torch.native.min_fill_order`, the same order as the JAX
package's native library), so both packages eliminate in the same order.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import config, native
from .block import BlockMatrix, BlockVector
from .linop import LinOp

__all__ = ["BlockCholesky"]


class BlockCholesky:
    """Factor a symmetric quasi-definite BlockMatrix; solve many times."""

    def __init__(self, A: BlockMatrix):
        self.A = A
        self._factorized = False
        # Elimination data: per-pivot (key, D_inv LinOp, {row_key: L block})
        self._steps: List[Tuple[str, LinOp, Dict[str, LinOp]]] = []
        self._dims: Dict[str, int] = {}

    # -- symbolic + numeric factorization (host, eager) --------------------
    def factor(self) -> "BlockCholesky":
        """Eliminate every block on the host, under the ``epsilon.factor``
        span (its argument: the largest pivot's dimension)."""
        from ..utils.timing import span  # here: utils imports ir, which imports ops
        blocks: Dict[Tuple[str, str], LinOp] = dict(self.A.blocks)
        keys = sorted({r for r, _ in blocks} | {c for _, c in blocks})
        for k in keys:
            self._dims[k] = _dim_of(blocks, k)
        with span("epsilon.factor", (max(self._dims.values(), default=0),)):
            self._eliminate(blocks, keys)
        self._factorized = True
        return self

    def _eliminate(self, blocks, keys):
        remaining = set(keys)
        order = self._native_order(blocks, keys)
        while remaining:
            pivot = None
            if order is not None:
                while order and order[0] not in remaining:
                    order.pop(0)
                # the whole-system order predicts fill structurally; if its
                # next pivot has no concrete diagonal block yet, the
                # per-step heuristic picks this step (as in the JAX package)
                if order and (order[0], order[0]) in blocks:
                    pivot = order.pop(0)
            if pivot is None:
                pivot = self._min_fill_pivot(blocks, remaining)
            D = blocks.get((pivot, pivot))
            if D is None:
                raise ValueError(
                    f"BlockCholesky: zero diagonal block at {pivot!r}; "
                    "system is not factorizable in this ordering")
            D_inv = D.inverse()
            if config.use_explicit_inverse() and hasattr(D_inv, "_host_inv"):
                # a cached factor's device apply is its explicit inverse:
                # form it here, with the factor, and not at its first apply
                D_inv._host_inv()

            # Off-diagonal column under the pivot: rows i != pivot with A[i,p]
            col = {r: op for (r, c), op in blocks.items()
                   if c == pivot and r != pivot and r in remaining}

            # L[i,p] = A[i,p] D^{-1}
            L = {r: op @ D_inv for r, op in col.items()}

            # Schur complement update: A[i,j] -= A[i,p] D^{-1} A[p,j]
            for i, Aip in col.items():
                for (r, j), Apj in list(blocks.items()):
                    if r != pivot or j == pivot or j not in remaining:
                        continue
                    update = (L[i] @ Apj).scale(-1.0)
                    key = (i, j)
                    if key in blocks:
                        blocks[key] = blocks[key] + update
                    else:
                        blocks[key] = update

            for key in [k for k in blocks if pivot in k]:
                del blocks[key]
            remaining.discard(pivot)
            self._steps.append((pivot, D_inv, L))

    def _native_order(self, blocks, keys) -> Optional[List[str]]:
        """The whole elimination order for systems of three or more keys;
        None for smaller ones, which the per-step heuristic orders."""
        if len(keys) < 3:
            return None
        idx = {k: i for i, k in enumerate(keys)}
        n = len(keys)
        nnz = np.zeros((n, n), dtype=np.int64)
        for (r, c), op in blocks.items():
            nnz[idx[r], idx[c]] = max(1, op.nnz())
        dims = np.asarray([self._dims[k] for k in keys], dtype=np.int64)
        return [keys[i] for i in native.min_fill_order(nnz, dims)]

    def _min_fill_pivot(self, blocks, remaining) -> str:
        """Greedy min-fill: pick the pivot whose elimination creates the
        least predicted fill, using the nnz cost model."""
        best, best_cost = None, None
        for p in sorted(remaining):
            if (p, p) not in blocks:
                continue
            col = [(r, op) for (r, c), op in blocks.items()
                   if c == p and r != p and r in remaining]
            # fill cost ~ sum over pairs (i,j) of nnz(A[i,p]) * nnz(A[p,j]) / dim
            cost = 0
            for i, Aip in col:
                for j, Apj in col:
                    cost += Aip.nnz() * Apj.nnz() // max(1, self._dims[p])
            if best_cost is None or cost < best_cost:
                best, best_cost = p, cost
        if best is None:
            raise ValueError(
                f"BlockCholesky: no pivot with diagonal block among {sorted(remaining)}")
        return best

    def factor_nnz(self) -> int:
        """Cost-model size of the stored factor (per-solve traffic): nnz of
        every D^{-1} and L block the substitution chain touches."""
        total = 0
        for _pivot, D_inv, L in self._steps:
            total += D_inv.nnz()
            for op in L.values():
                total += op.nnz()
        return total

    def solve_mat(self, B: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:meth:`solve` for matrix right-hand sides: ``B`` maps row key ->
        ``(dim_key, R)`` tensors.  Used to collapse the factored system into
        an explicit solve operator (basis solves)."""
        if not self._factorized:
            raise RuntimeError("call factor() before solve_mat()")
        R = next(iter(B.values())).shape[1]

        y: Dict[str, torch.Tensor] = {}
        work = dict(B)
        for pivot, D_inv, L in self._steps:
            yp = work.get(pivot)
            if yp is None:
                yp = torch.zeros((self._dims[pivot], R), dtype=config.default_dtype(),
                                 device=config.device())
            y[pivot] = yp
            for i, Lip in L.items():
                upd = Lip.matmat(yp)
                work[i] = work[i] - upd if i in work else -upd

        z = {p: D_inv.matmat(y[p]) for p, D_inv, _ in self._steps}

        x: Dict[str, torch.Tensor] = {}
        for pivot, D_inv, L in reversed(self._steps):
            xp = z[pivot]
            for i, Lip in L.items():
                if i in x:
                    xp = xp - Lip.T.matmat(x[i])
            x[pivot] = xp
        return x

    def _needed(self, keys: Optional[Iterable[str]]) -> set:
        """Pivots whose back-substituted value ``keys`` depend on: x_p reads
        x_i for every i in L[p], all eliminated after p."""
        if keys is None:
            return {p for p, _, _ in self._steps}
        needed = set(keys)
        for pivot, _D_inv, L in self._steps:
            if pivot in needed:
                needed |= set(L)
        return needed

    def solve(self, b: BlockVector, keys: Optional[Iterable[str]] = None) -> BlockVector:
        """Solve ``A x = b``.  With ``keys``, back substitution stops at the
        blocks those keys depend on: the eager counterpart of the dead-code
        elimination ``jit`` gives the JAX package when a caller selects
        keys (the KKT operators discard the multiplier blocks)."""
        if not self._factorized:
            raise RuntimeError("call factor() before solve()")
        needed = self._needed(keys)

        # Forward substitution in pivot order: y = L^{-1} b with unit block
        # lower L (L[i,p] stored for rows i eliminated after p).
        y: Dict[str, torch.Tensor] = {}
        work = dict(b.data)
        for pivot, D_inv, L in self._steps:
            yp = work.get(pivot)
            if yp is None:
                yp = torch.zeros(self._dims[pivot], dtype=config.default_dtype(),
                                 device=config.device())
            y[pivot] = yp
            for i, Lip in L.items():
                upd = Lip.matvec(yp)
                work[i] = work[i] - upd if i in work else -upd

        # Diagonal solve: z_p = D_p^{-1} y_p
        z = {p: D_inv.matvec(y[p]) for p, D_inv, _ in self._steps if p in needed}

        # Back substitution: x_p = z_p - sum_i L[i,p]^T x_i, reverse order.
        x: Dict[str, torch.Tensor] = {}
        for pivot, D_inv, L in reversed(self._steps):
            if pivot not in needed:
                continue
            xp = z[pivot]
            for i, Lip in L.items():
                if i in x:
                    xp = xp - Lip.T.matvec(x[i])
            x[pivot] = xp

        return BlockVector(x)


def _dim_of(blocks, key: str) -> int:
    for (r, c), op in blocks.items():
        if r == key:
            return op.m
        if c == key:
            return op.n
    raise KeyError(key)
