"""Host kernels: block-Cholesky elimination ordering and the exact TV-1D
prox.

Counterpart of ``epsilon_tpu/native`` (``min_fill_order``, ``tv1d_prox``
and ``tv1d_prox_batch``, the C++ kernels of ``native/``).  The JAX package
ships those as a built library, so its ``BlockCholesky`` orders every
system of three or more keys with it.  The port computes the same
whole-system order with numpy, in the same integer arithmetic and with the
same tie-breaking, so both packages eliminate in the same order (and round
the same way) with nothing to build; its TV-1D entry points run the numpy
taut string the JAX package uses when its library is not built.
"""

from __future__ import annotations

import numpy as np

__all__ = ["available", "min_fill_order", "tv1d_prox", "tv1d_prox_batch"]


def available() -> bool:
    """Whether a built native library is loaded: never, the port has
    nothing to build (the numpy versions below always run)."""
    return False


def tv1d_prox(y: np.ndarray, lam: float) -> np.ndarray:
    """Exact TV-1D prox on the host in float64 (the numpy taut string)."""
    from ..ops.prox.tv1d import tv1d_exact_numpy
    return tv1d_exact_numpy(np.ascontiguousarray(y, dtype=np.float64), lam)


def tv1d_prox_batch(Y: np.ndarray, lams: np.ndarray) -> np.ndarray:
    """:func:`tv1d_prox` of every row of ``Y``, ``lams`` one per row (or
    one for all)."""
    from ..ops.prox.tv1d import tv1d_exact_numpy
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    lams = np.ascontiguousarray(np.broadcast_to(lams, (Y.shape[0],)),
                                dtype=np.float64)
    return np.stack([tv1d_exact_numpy(Y[i], lams[i])
                     for i in range(Y.shape[0])])


def min_fill_order(nnz: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Greedy min-fill elimination order of an ``n``-key block system.

    ``nnz[i, j]`` is the cost-model nonzero count of block (i, j) (0 where
    there is no block) and ``dims[i]`` the dimension of key i.  Each step
    takes the first remaining key with a diagonal block whose predicted
    fill ``sum_ij nnz[i, p] * nnz[p, j] // dims[p]`` is smallest, then adds
    that fill to the remaining blocks, capped at ``dims[i] * dims[j]``."""
    cost = np.array(nnz, dtype=np.int64)
    dims = np.asarray(dims, dtype=np.int64)
    n = dims.size
    div = np.maximum(dims, 1)
    cap = np.outer(dims, dims)
    done = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    for step in range(n):
        best, best_fill = -1, None
        for p in range(n):
            if done[p] or cost[p, p] == 0:
                continue
            keep = ~done
            keep[p] = False
            col = np.where(keep, cost[:, p], 0)
            row = np.where(keep, cost[p, :], 0)
            fill = int((np.outer(col, row) // div[p]).sum())
            if best_fill is None or fill < best_fill:
                best, best_fill = p, fill
        if best < 0:
            # no remaining key has a diagonal block: take the first one
            best = int(np.flatnonzero(~done)[0])
        order[step] = best
        done[best] = True
        col = np.where(~done, cost[:, best], 0)
        row = np.where(~done, cost[best, :], 0)
        hit = (col != 0)[:, None] & (row != 0)[None, :]
        upd = np.outer(col, row) // div[best]
        cost = np.where(hit, np.minimum(cost + upd, cap), cost)
    return order
