"""Structured linear-operator algebra.

Counterpart of ``epsilon_tpu/ops/linop.py``.  All operator algebra
(products, sums, inverses, promotion) runs eagerly on the host in
numpy/scipy, exactly as in the JAX package; only ``matvec``/``matmat``
touch the device, as PyTorch tensors cached on the operator.

Left out against the JAX package (TPU-only): constant lifting into ``jit``
arguments, the tracer-aware device cache, the device-operand LRU for the
host tunnel, and device-resident dense inverses (``_device_inverse``).  A
symmetric pivot therefore always becomes a symmetric factor operator, which
applies through the ``sym_packed`` kernel above ``config.SYM_PACKED_MIN_DIM``.

Vectorization convention is column-major (Fortran) ``vec``, so the
Kronecker identity is ``(A (x) B) vec(X) = vec(B X A^T)``.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from .. import config
from .kernels.sym_packed import (SYM_TILE, pack_sym_tiles, sym_packed_matmul,
                                 sym_packed_plan)

__all__ = [
    "LinOp", "ScalarOp", "DiagonalOp", "DenseOp", "SparseOp", "KronOp",
    "CholFactorOp", "LuFactorOp",
    "vec", "mat",
    "as_linop", "identity", "scalar", "diagonal", "dense", "sparse",
    "kronecker", "zero",
    "index_op", "one_hot", "sum_op", "sum_left", "sum_right", "promote",
    "negate", "left_matrix_product", "right_matrix_product",
    "transpose_matrix", "diag_mat", "diag_vec", "trace_op", "upper_tri_op",
]


# ---------------------------------------------------------------------------
# vec/mat helpers (column-major convention)
# ---------------------------------------------------------------------------

def vec(X: np.ndarray) -> np.ndarray:
    """Column-major vectorization (numpy)."""
    return np.asarray(X).flatten(order="F")


def mat(x: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`vec` (numpy)."""
    m, n = shape
    return np.asarray(x).reshape((n, m)).T


def jvec(X: torch.Tensor) -> torch.Tensor:
    """Column-major vectorization of the last two axes of a tensor."""
    return X.transpose(-1, -2).reshape(X.shape[:-2] + (-1,))


def jmat(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`jvec`."""
    m, n = shape
    return x.reshape(x.shape[:-1] + (n, m)).transpose(-1, -2)


def _dtype():
    return config.default_np_dtype()


def to_tensor(a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host array -> tensor on the configured device (solver dtype)."""
    return torch.as_tensor(np.asarray(a), dtype=dtype or config.default_dtype(),
                           device=config.device())


def _cached(obj, attr, make):
    """Cache a device value on ``obj.attr``, keyed by the configured device
    and dtype so a change of either rebuilds it."""
    key = (config.device(), config.default_dtype())
    hit = getattr(obj, attr, None)
    if hit is not None and hit[0] == key:
        return hit[1]
    val = make()
    setattr(obj, attr, (key, val))
    return val


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

class LinOp(abc.ABC):
    """A structured linear map R^n -> R^m.

    Host-side value object; algebra is eager (numpy/scipy), application
    takes and returns tensors on the configured device.
    """

    shape: Tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    # -- device application ------------------------------------------------
    @abc.abstractmethod
    def matvec(self, x):
        """Apply to a vector (tensor of shape (n,))."""

    def matmat(self, X):
        """Apply to a matrix columnwise (tensor (n, k))."""
        return torch.stack([self.matvec(X[:, j]) for j in range(X.shape[1])],
                           dim=1)

    def host_matvec(self, x: np.ndarray) -> np.ndarray:
        """Apply to a concrete numpy vector on the host (compile-time use)."""
        return self.as_dense() @ np.asarray(x)

    # -- host-side representations ----------------------------------------
    @abc.abstractmethod
    def as_dense(self) -> np.ndarray:
        ...

    def as_sparse(self) -> sp.spmatrix:
        return sp.csr_matrix(self.as_dense())

    # -- structure ---------------------------------------------------------
    @property
    @abc.abstractmethod
    def T(self) -> "LinOp":
        ...

    def inverse(self) -> "LinOp":
        """Structured inverse (square ops only)."""
        if self.m != self.n:
            raise ValueError(f"inverse of non-square operator {self.shape}")
        A = self.as_dense()
        if _is_symmetric(A):
            return LuFactorOp.symmetric(A)
        return LuFactorOp(A)

    def nnz(self) -> int:
        """Cost-model nonzeros (used by the block-Cholesky min-fill
        heuristic and the KKT collapse test)."""
        return self.m * self.n

    # -- predicates --------------------------------------------------------
    def scalar_value(self) -> Optional[float]:
        """If this operator is alpha*I, return alpha; else None."""
        return None

    def diag_value(self) -> Optional[np.ndarray]:
        """If this operator is diag(d), return d; else None."""
        return None

    @property
    def is_scalar(self) -> bool:
        return self.scalar_value() is not None

    @property
    def is_diagonal(self) -> bool:
        return self.diag_value() is not None

    # -- algebra -----------------------------------------------------------
    def __matmul__(self, other):
        if isinstance(other, LinOp):
            return multiply(self, other)
        return self.matvec(other)

    def __add__(self, other: "LinOp") -> "LinOp":
        return add(self, other)

    def __sub__(self, other: "LinOp") -> "LinOp":
        return add(self, other.scale(-1.0))

    def __neg__(self) -> "LinOp":
        return self.scale(-1.0)

    def __rmul__(self, alpha: float) -> "LinOp":
        return self.scale(float(alpha))

    @abc.abstractmethod
    def scale(self, alpha: float) -> "LinOp":
        ...

    def __eq__(self, other):
        if not isinstance(other, LinOp):
            return NotImplemented
        if self.shape != other.shape:
            return False
        return np.allclose(self.as_dense(), other.as_dense())

    def __hash__(self):
        return id(self)

    def gram(self) -> "LinOp":
        """A^T A as a structured operator."""
        return multiply(self.T, self)


def _is_symmetric(A: np.ndarray, tol: float = 1e-12) -> bool:
    return A.shape[0] == A.shape[1] and np.allclose(A, A.T, atol=tol)


# ---------------------------------------------------------------------------
# Concrete impls
# ---------------------------------------------------------------------------

class ScalarOp(LinOp):
    """alpha * I_n."""

    def __init__(self, alpha: float, n: int):
        self.alpha = float(alpha)
        self.shape = (n, n)

    def matvec(self, x):
        if self.alpha == 1.0:
            return x
        return self.alpha * x

    def matmat(self, X):
        return self.matvec(X)

    def host_matvec(self, x):
        return self.alpha * np.asarray(x)

    def as_dense(self):
        return self.alpha * np.eye(self.n, dtype=_dtype())

    def as_sparse(self):
        return sp.identity(self.n, dtype=_dtype(), format="csr") * self.alpha

    @property
    def T(self):
        return self

    def inverse(self):
        return ScalarOp(1.0 / self.alpha, self.n)

    def nnz(self):
        return self.n

    def scalar_value(self):
        return self.alpha

    def diag_value(self):
        return np.full(self.n, self.alpha, dtype=_dtype())

    def scale(self, alpha):
        return ScalarOp(self.alpha * alpha, self.n)

    def __repr__(self):
        return f"Scalar({self.alpha}, n={self.n})"


class DiagonalOp(LinOp):
    """diag(d)."""

    def __init__(self, d: np.ndarray):
        self.d = np.asarray(d, dtype=_dtype()).ravel()
        self.shape = (self.d.size, self.d.size)

    def _device_d(self):
        return _cached(self, "_td", lambda: to_tensor(self.d))

    def matvec(self, x):
        return self._device_d() * x

    def matmat(self, X):
        return self._device_d()[:, None] * X

    def host_matvec(self, x):
        return self.d * np.asarray(x)

    def as_dense(self):
        return np.diag(self.d)

    def as_sparse(self):
        return sp.diags(self.d).tocsr()

    @property
    def T(self):
        return self

    def inverse(self):
        return DiagonalOp(1.0 / self.d)

    def nnz(self):
        return self.n

    def scalar_value(self):
        if self.d.size and np.all(self.d == self.d[0]):
            return float(self.d[0])
        return None

    def diag_value(self):
        return self.d

    def scale(self, alpha):
        return DiagonalOp(self.d * alpha)

    def __repr__(self):
        return f"Diagonal(n={self.n})"


class DenseOp(LinOp):
    """Dense host matrix, applied as a device matmul.  A transpose shares
    its parent's buffer on both sides: the device apply of ``A.T`` is the
    transposed view of ``A``'s tensor, so one copy goes to the device."""

    def __init__(self, A):
        self.A = np.ascontiguousarray(np.asarray(A, dtype=_dtype()))
        if self.A.ndim != 2:
            raise ValueError(f"dense operator must be 2-D, got {self.A.shape}")
        self.shape = tuple(self.A.shape)
        self._trans_of: "Optional[DenseOp]" = None

    def _device_A(self):
        if self._trans_of is not None:
            return self._trans_of._device_A().T
        return _cached(self, "_tA", lambda: to_tensor(self.A))

    def matvec(self, x):
        return self._device_A() @ x

    def matmat(self, X):
        return self._device_A() @ X

    def host_matvec(self, x):
        return self.A @ np.asarray(x, dtype=self.A.dtype)

    def as_dense(self):
        return self.A

    @property
    def T(self):
        t = getattr(self, "_t_cache", None)
        if t is None:
            t = DenseOp.__new__(DenseOp)
            t.A = self.A.T          # a view of the parent's buffer
            t.shape = (self.shape[1], self.shape[0])
            t._trans_of = self
            t._t_cache = self
            self._t_cache = t
        return t

    def scale(self, alpha):
        return DenseOp(self.A * alpha)

    def __repr__(self):
        return f"Dense{self.shape}"


class SparseOp(LinOp):
    """Sparse CSR matrix.  On the device it is densified when small or
    dense enough (``config.SPARSE_DENSIFY_*``, the JAX package's rule, so
    both packages take the same branch) and otherwise applied as a torch
    sparse CSR product (cuSPARSE on the card)."""

    def __init__(self, A: sp.spmatrix):
        self.A = sp.csr_matrix(A).astype(_dtype())
        self.shape = self.A.shape

    def densified(self) -> bool:
        m, n = self.shape
        density = self.A.nnz / max(1, m * n)
        return ((m * n <= config.SPARSE_DENSIFY_MAX_ELEMS
                 and density >= config.SPARSE_DENSIFY_DENSITY)
                or m * n <= 65536)

    def _device_A(self):
        def make():
            if self.densified():
                return to_tensor(self.A.toarray())
            dev = config.device()
            return torch.sparse_csr_tensor(
                torch.as_tensor(self.A.indptr, dtype=torch.int64, device=dev),
                torch.as_tensor(self.A.indices, dtype=torch.int64, device=dev),
                to_tensor(self.A.data), size=self.shape,
                check_invariants=False)
        return _cached(self, "_tA", make)

    def matvec(self, x):
        A = self._device_A()
        if A.layout == torch.strided:
            return A @ x
        return (A @ x[:, None])[:, 0]

    def matmat(self, X):
        return self._device_A() @ X

    def host_matvec(self, x):
        return self.A @ np.asarray(x)

    def as_dense(self):
        return self.A.toarray()

    def as_sparse(self):
        return self.A

    @property
    def T(self):
        t = getattr(self, "_t_cache", None)
        if t is None:
            t = SparseOp(self.A.T.tocsr())
            t._t_cache = self
            self._t_cache = t
        return t

    def inverse(self):
        sv = self.scalar_value()
        if sv is not None:
            return ScalarOp(1.0 / sv, self.n)
        dv = self.diag_value()
        if dv is not None:
            return DiagonalOp(1.0 / dv)
        return super().inverse()

    def nnz(self):
        return self.A.nnz

    def scalar_value(self):
        dv = self.diag_value()
        if dv is not None and dv.size and np.all(dv == dv[0]):
            return float(dv[0])
        return None

    def diag_value(self):
        if self.m != self.n:
            return None
        off_diag = self.A - sp.diags(self.A.diagonal())
        if off_diag.nnz == 0 or np.max(np.abs(off_diag.data)) == 0:
            return np.asarray(self.A.diagonal())
        return None

    def scale(self, alpha):
        return SparseOp(self.A * alpha)

    def __repr__(self):
        return f"Sparse{self.shape}(nnz={self.A.nnz})"


class KronOp(LinOp):
    """Kronecker product A (x) B, applied with the vec trick
    ``(A (x) B) vec(X) = vec(B X A^T)``: two child products, never the
    Kronecker matrix itself."""

    def __init__(self, A: LinOp, B: LinOp):
        self.A = A
        self.B = B
        self.shape = (A.m * B.m, A.n * B.n)

    def matvec(self, x):
        # x = vec(X), X in R^{B.n x A.n} (column-major)
        X = jmat(x, (self.B.n, self.A.n))
        BX = self.B.matmat(X)                      # (B.m, A.n)
        Y = self.A.matmat(BX.T).T                  # (B.m, A.m) = B X A^T
        return jvec(Y)

    def matmat(self, X):
        """All k columns through the same two child products: the batch
        axis folds into the column axis."""
        k = X.shape[1]
        Xs = jmat(X.T, (self.B.n, self.A.n))               # (k, B.n, A.n)
        Xb = Xs.permute(1, 0, 2).reshape(self.B.n, k * self.A.n)
        BX = self.B.matmat(Xb).reshape(self.B.m, k, self.A.n)
        T = BX.permute(2, 1, 0).reshape(self.A.n, k * self.B.m)
        Y = self.A.matmat(T).reshape(self.A.m, k, self.B.m)
        # Y[:, j, :] = (B X_j A^T)^T; its row-major flatten is vec(B X_j A^T)
        return Y.permute(1, 0, 2).reshape(k, self.m).T

    def host_matvec(self, x):
        X = mat(np.asarray(x), (self.B.n, self.A.n))
        BX = np.stack([self.B.host_matvec(X[:, j]) for j in range(X.shape[1])],
                      axis=1)
        Y = np.stack([self.A.host_matvec(BX[i, :]) for i in range(BX.shape[0])],
                     axis=0)
        return vec(Y)

    def as_dense(self):
        return np.kron(self.A.as_dense(), self.B.as_dense())

    def as_sparse(self):
        return sp.kron(self.A.as_sparse(), self.B.as_sparse(), format="csr")

    @property
    def T(self):
        return KronOp(self.A.T, self.B.T)

    def inverse(self):
        return KronOp(self.A.inverse(), self.B.inverse())

    def nnz(self):
        return self.A.nnz() * self.B.nnz()

    def scale(self, alpha):
        return KronOp(self.A.scale(alpha), self.B)

    def scalar_value(self):
        a, b = self.A.scalar_value(), self.B.scalar_value()
        if a is not None and b is not None:
            return a * b
        return None

    def diag_value(self):
        a, b = self.A.diag_value(), self.B.diag_value()
        if a is not None and b is not None:
            return np.kron(a, b)
        return None

    def __repr__(self):
        return f"Kron({self.A!r}, {self.B!r})"


def _sym_packed_apply(op, X):
    """Apply a cached symmetric explicit inverse as ``inv @ X`` through the
    packed-lower-triangle kernel (``kernels/sym_packed.py``): only n^2/2
    factor elements are read from device memory.  The packed tiles and the
    kernel's reduction plan are built once and cached on the op.  X: (n, R)."""
    n = op.shape[0]

    def build():
        tiles, ii, jj, n_pad = pack_sym_tiles(op._host_inv(), tile=SYM_TILE)
        row_ptr, entries = sym_packed_plan(ii, jj, n_pad // SYM_TILE)
        idx = lambda a: torch.as_tensor(a, device=config.device())
        return (to_tensor(tiles), idx(ii), idx(jj),
                (idx(row_ptr), idx(entries)), n_pad)

    tiles, ii, jj, plan, n_pad = _cached(op, "_tpacked", build)
    if n_pad == n:
        return sym_packed_matmul(tiles, ii, jj, X.contiguous(), plan)
    Xp = X.new_zeros((n_pad,) + tuple(X.shape[1:]))
    Xp[:n] = X
    return sym_packed_matmul(tiles, ii, jj, Xp, plan)[:n]


class CholFactorOp(LinOp):
    """Operator representing ``M^{-1}`` for SPD ``M``, via a cached
    Cholesky factor."""

    def __init__(self, M: np.ndarray):
        M = np.asarray(M, dtype=np.float64)
        self.L = scipy.linalg.cholesky(M, lower=True)
        self.shape = M.shape

    def _device_L(self):
        return _cached(self, "_tL", lambda: to_tensor(self.L))

    def _device_inv(self):
        return _cached(self, "_tinv", lambda: to_tensor(self._host_inv()))

    def _host_inv(self):
        if getattr(self, "_hinv", None) is None or self._hinv.dtype != _dtype():
            self._hinv = self.as_dense().astype(_dtype())
        return self._hinv

    def matvec(self, x):
        if config.use_sym_packed(self.shape[0]):
            return _sym_packed_apply(self, x[:, None])[:, 0]
        if config.use_explicit_inverse():
            return self._device_inv() @ x
        return torch.cholesky_solve(x[:, None], self._device_L())[:, 0]

    def matmat(self, X):
        if config.use_sym_packed(self.shape[0]):
            return _sym_packed_apply(self, X)
        if config.use_explicit_inverse():
            return self._device_inv() @ X
        return torch.cholesky_solve(X, self._device_L())

    def host_matvec(self, x):
        return scipy.linalg.cho_solve((self.L, True), np.asarray(x))

    def as_dense(self):
        n = self.shape[0]
        return scipy.linalg.cho_solve((self.L, True), np.eye(n))

    @property
    def T(self):
        return self  # symmetric

    def scale(self, alpha):
        return DenseOp(self.as_dense() * alpha)

    def __repr__(self):
        return f"CholFactor{self.shape}"


class LuFactorOp(LinOp):
    """Operator representing ``M^{-1}`` for square (possibly indefinite)
    ``M`` via a cached LU factorization (quasi-definite KKT pivots)."""

    def __init__(self, M: np.ndarray, transposed: bool = False):
        M = np.asarray(M, dtype=np.float64)
        self._M = M
        self.lu, self.piv = scipy.linalg.lu_factor(M)
        self.shape = M.shape
        self.transposed = transposed
        self._sym = False

    @classmethod
    def symmetric(cls, M: np.ndarray) -> "LuFactorOp":
        op = cls(M)
        op._sym = True   # M = M^T, so M^{-1} is symmetric: packed apply OK
        return op

    def _device_lu(self):
        # LAPACK getrf layout on both sides; torch pivots are 1-based
        return _cached(self, "_tlu", lambda: (
            to_tensor(self.lu),
            torch.as_tensor(self.piv + 1, dtype=torch.int32,
                            device=config.device())))

    def _host_inv(self):
        if getattr(self, "_hinv", None) is None or self._hinv.dtype != _dtype():
            self._hinv = self.as_dense().astype(_dtype())
        return self._hinv

    def _device_inv(self):
        return _cached(self, "_tinv", lambda: to_tensor(self._host_inv()))

    def matvec(self, x):
        if self._sym and config.use_sym_packed(self.shape[0]):
            return _sym_packed_apply(self, x[:, None])[:, 0]
        if config.use_explicit_inverse():
            return self._device_inv() @ x
        return self._lu_solve(x[:, None])[:, 0]

    def matmat(self, X):
        if self._sym and config.use_sym_packed(self.shape[0]):
            return _sym_packed_apply(self, X)
        if config.use_explicit_inverse():
            return self._device_inv() @ X
        return self._lu_solve(X)

    def _lu_solve(self, X):
        lu, piv = self._device_lu()
        return torch.linalg.lu_solve(lu, piv, X, adjoint=self.transposed)

    def host_matvec(self, x):
        return scipy.linalg.lu_solve((self.lu, self.piv), np.asarray(x),
                                     trans=1 if self.transposed else 0)

    def as_dense(self):
        M = self._M.T if self.transposed else self._M
        return np.linalg.inv(M)

    @property
    def T(self):
        t = getattr(self, "_t_cache", None)
        if t is None:
            t = LuFactorOp.__new__(LuFactorOp)
            t._M = self._M
            t.lu, t.piv = self.lu, self.piv
            t.shape = self.shape
            t.transposed = not self.transposed
            t._sym = self._sym
            t._t_cache = self
            self._t_cache = t
        return t

    def scale(self, alpha):
        return DenseOp(self.as_dense() * alpha)

    def __repr__(self):
        return f"LuFactor{self.shape}"


# ---------------------------------------------------------------------------
# Algebra: multiply / add with structure-preserving promotion
# ---------------------------------------------------------------------------

def _sparse_like(op: LinOp) -> bool:
    if isinstance(op, (ScalarOp, DiagonalOp, SparseOp)):
        return True
    if isinstance(op, KronOp):
        return _sparse_like(op.A) and _sparse_like(op.B)
    return False


def multiply(lhs: LinOp, rhs: LinOp) -> LinOp:
    if lhs.n != rhs.m:
        raise ValueError(f"dimension mismatch in multiply: {lhs.shape} @ {rhs.shape}")

    ls, rs = lhs.scalar_value(), rhs.scalar_value()
    if ls is not None:
        return rhs.scale(ls) if ls != 1.0 else rhs
    if rs is not None:
        return lhs.scale(rs) if rs != 1.0 else lhs

    ld, rd = lhs.diag_value(), rhs.diag_value()
    if ld is not None and rd is not None:
        return DiagonalOp(ld * rd)

    if isinstance(lhs, KronOp) and isinstance(rhs, KronOp):
        # (A1 (x) B1)(A2 (x) B2) = (A1 A2) (x) (B1 B2) when dims conform
        if lhs.A.n == rhs.A.m and lhs.B.n == rhs.B.m:
            return KronOp(multiply(lhs.A, rhs.A), multiply(lhs.B, rhs.B))

    if ld is not None and isinstance(rhs, SparseOp):
        return SparseOp(sp.diags(ld) @ rhs.A)
    if rd is not None and isinstance(lhs, SparseOp):
        return SparseOp(lhs.A @ sp.diags(rd))
    if ld is not None and isinstance(rhs, DenseOp):
        return DenseOp(ld[:, None] * rhs.A)
    if rd is not None and isinstance(lhs, DenseOp):
        return DenseOp(lhs.A * rd[None, :])

    if _sparse_like(lhs) and _sparse_like(rhs):
        return SparseOp(lhs.as_sparse() @ rhs.as_sparse())

    if isinstance(lhs, SparseOp) and isinstance(rhs, DenseOp):
        return DenseOp(lhs.A @ rhs.A)
    if isinstance(lhs, DenseOp) and isinstance(rhs, SparseOp):
        return DenseOp((rhs.A.T @ lhs.A.T).T)

    if isinstance(lhs, DenseOp) and isinstance(rhs, DenseOp):
        return DenseOp(_dense_product(lhs.A, rhs.A))
    return DenseOp(_dense_product(lhs.as_dense(), rhs.as_dense()))


# Large compile-time products (e.g. the H'H Schur complement of a dense
# least-squares KKT) run on the card, as the JAX package ran them on its
# accelerator: at 16384 x 8192 the 2.2e12-flop product would take the host
# many seconds.  The result comes back to the host, where the rest of the
# operator algebra lives.
_DEVICE_GEMM_MIN_FLOPS = 5e10


def _dense_product(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    if A.dtype != B.dtype:
        wide = np.promote_types(A.dtype, B.dtype)
        A, B = A.astype(wide), B.astype(wide)
    flops = 2.0 * A.shape[0] * A.shape[1] * B.shape[1]
    if flops >= _DEVICE_GEMM_MIN_FLOPS and config.on_cuda():
        dev = config.device()
        tA = torch.as_tensor(np.ascontiguousarray(A), device=dev)
        tB = torch.as_tensor(np.ascontiguousarray(B), device=dev)
        return (tA @ tB).cpu().numpy()
    return A @ B


def add(lhs: LinOp, rhs: LinOp) -> LinOp:
    if lhs.shape != rhs.shape:
        raise ValueError(f"dimension mismatch in add: {lhs.shape} + {rhs.shape}")

    # structure preservation: s*I + (aI_k (x) B) = I_k (x) (aB + sI)
    # (and symmetrically for scalar right factors)
    for a, b in ((lhs, rhs), (rhs, lhs)):
        sv = a.scalar_value()
        if sv is not None and isinstance(b, KronOp) and b.m == b.n:
            asv = b.A.scalar_value()
            if asv is not None and b.B.m == b.B.n:
                inner = add(b.B.scale(asv), ScalarOp(sv, b.B.n))
                return KronOp(ScalarOp(1.0, b.A.n), inner)
            bsv = b.B.scalar_value()
            if bsv is not None and b.A.m == b.A.n:
                outer = add(b.A.scale(bsv), ScalarOp(sv, b.A.n))
                return KronOp(outer, ScalarOp(1.0, b.B.n))

    ld, rd = lhs.diag_value(), rhs.diag_value()
    if ld is not None and rd is not None:
        s = ld + rd
        if s.size and np.all(s == s[0]):
            return ScalarOp(float(s[0]), lhs.n)
        return DiagonalOp(s)

    if _sparse_like(lhs) and _sparse_like(rhs):
        return SparseOp(lhs.as_sparse() + rhs.as_sparse())

    return DenseOp(lhs.as_dense() + rhs.as_dense())


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def as_linop(A) -> LinOp:
    if isinstance(A, LinOp):
        return A
    if sp.issparse(A):
        return SparseOp(A)
    A = np.asarray(A)
    if A.ndim == 0:
        raise ValueError("scalar needs explicit dimension; use scalar(alpha, n)")
    if A.ndim == 1:
        return DiagonalOp(A)
    return DenseOp(A)


def identity(n: int) -> LinOp:
    return ScalarOp(1.0, n)


def scalar(alpha: float, n: int) -> LinOp:
    return ScalarOp(alpha, n)


def diagonal(d) -> LinOp:
    return DiagonalOp(np.asarray(d))


def dense(A) -> LinOp:
    return DenseOp(np.asarray(A))


def sparse(A) -> LinOp:
    return SparseOp(A)


def zero(m: int, n: int) -> LinOp:
    return SparseOp(sp.csr_matrix((m, n), dtype=_dtype()))


def kronecker(A: LinOp, B: LinOp) -> LinOp:
    """Kronecker product with scalar collapsing."""
    a, b = A.scalar_value(), B.scalar_value()
    if a is not None and b is not None:
        return ScalarOp(a * b, A.n * B.n)
    if a is not None and A.n == 1:
        return B.scale(a)
    if b is not None and B.n == 1:
        return A.scale(b)
    return KronOp(A, B)


def index_op(start: int, stop: int, step: int, n: int) -> LinOp:
    """Row-selector for a python slice of an n-vector."""
    idx = np.arange(start, stop, step)
    m = idx.size
    data = np.ones(m, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (np.arange(m), idx)), shape=(m, n)))


def rows_op(idx: np.ndarray, n: int) -> LinOp:
    """Selector for arbitrary row indices."""
    idx = np.asarray(idx)
    m = idx.size
    data = np.ones(m, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (np.arange(m), idx)), shape=(m, n)))


def one_hot(i: int, n: int) -> LinOp:
    """e_i^T : R^n -> R."""
    return SparseOp(sp.csr_matrix((np.ones(1, dtype=_dtype()), ([0], [i])), shape=(1, n)))


def sum_op(n: int) -> LinOp:
    """1^T : R^n -> R."""
    return DenseOp(np.ones((1, n), dtype=_dtype()))


def sum_left(m: int, n: int) -> LinOp:
    """X -> 1^T X  summing over rows: maps vec(X) (m x n) to R^n."""
    return kronecker(identity(n), sum_op(m))


def sum_right(m: int, n: int) -> LinOp:
    """X -> X 1  summing over cols: maps vec(X) (m x n) to R^m."""
    return kronecker(sum_op(n), identity(m))


def promote(n: int) -> LinOp:
    """R -> R^n, x -> x*1."""
    return DenseOp(np.ones((n, 1), dtype=_dtype()))


def negate(n: int) -> LinOp:
    return ScalarOp(-1.0, n)


def left_matrix_product(A: LinOp, n: int) -> LinOp:
    """X -> A X for X with n columns: I_n (x) A."""
    return kronecker(identity(n), A)


def right_matrix_product(B: LinOp, m: int) -> LinOp:
    """X -> X B for X with m rows: B^T (x) I_m."""
    return kronecker(B.T, identity(m))


def transpose_matrix(m: int, n: int) -> LinOp:
    """vec(X) -> vec(X^T) permutation for X in R^{m x n}."""
    row = np.arange(m * n)
    # Output index k = i_out + j_out*n addresses X^T[i_out, j_out] (X^T is
    # n x m, column-major vec), which equals vec(X)[j_out + i_out*m].
    i_out = row % n
    j_out = row // n
    col = j_out + i_out * m
    data = np.ones(m * n, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (row, col)), shape=(m * n, m * n)))


def diag_vec(n: int) -> LinOp:
    """v in R^n -> vec(diag(v)) in R^{n^2}."""
    row = np.arange(n) * (n + 1)
    col = np.arange(n)
    data = np.ones(n, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (row, col)), shape=(n * n, n)))


def diag_mat(n: int) -> LinOp:
    """vec(X) in R^{n^2} -> diag(X) in R^n."""
    row = np.arange(n)
    col = np.arange(n) * (n + 1)
    data = np.ones(n, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (row, col)), shape=(n, n * n)))


def trace_op(n: int) -> LinOp:
    """vec(X) -> tr(X)."""
    col = np.arange(n) * (n + 1)
    data = np.ones(n, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (np.zeros(n, dtype=int), col)), shape=(1, n * n)))


def upper_tri_op(n: int) -> LinOp:
    """vec(X) -> entries strictly above the diagonal, row-major order of
    (i, j), i<j."""
    rows, cols = [], []
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            rows.append(k)
            cols.append(j * n + i)   # column-major vec index of X[i, j]
            k += 1
    m = k
    data = np.ones(m, dtype=_dtype())
    return SparseOp(sp.csr_matrix((data, (rows, cols)), shape=(m, n * n)))
