"""Affine canonicalization: expression trees -> structured linear operators.

Merges two reference layers into one: the Python LINEAR_MAP chain construction
(``python/epopt/compiler/transforms/linear.py``) and the C++ affine-operator
fold (``src/epsilon/affine/affine.cc:94-140``).  Because constants are
concrete at compile time, an affine expression folds directly into

    AffineFold: {variable_id: LinOp}  +  constant offset vector (numpy)

with all operator products/sums evaluated eagerly through the structured
promotion rules of :mod:`epsilon_tpu_torch.ops.linop`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import scipy.sparse as sp

from ..frontend.expression import Expression, ExprType
from ..ir import AffineOperator
from ..ops import linop
from ..ops.block import BlockMatrix, BlockVector
from ..utils.timing import count


@dataclasses.dataclass
class AffineFold:
    """x -> sum_v M_v vec(x_v) + c, for expression of total dimension dim."""

    maps: Dict[str, linop.LinOp]
    offset: np.ndarray  # shape (dim,)

    @property
    def dim(self):
        return self.offset.shape[0]

    def compose(self, L: linop.LinOp) -> "AffineFold":
        # Zero offsets stay zero under any linear map; skipping the concrete
        # host matvec matters at scale (a 60000x4000 dense gemv per compose
        # on an all-zero offset dominated MNIST-RFF compile time).
        if not np.any(self.offset):
            off = np.zeros(L.m, dtype=self.offset.dtype)
        else:
            off = L.host_matvec(self.offset)
        return AffineFold({v: L @ M for v, M in self.maps.items()}, off)

    def __add__(self, other: "AffineFold") -> "AffineFold":
        maps = dict(self.maps)
        for v, M in other.maps.items():
            maps[v] = maps[v] + M if v in maps else M
        return AffineFold(maps, self.offset + other.offset)

    def scale(self, alpha: float) -> "AffineFold":
        return AffineFold({v: M.scale(alpha) for v, M in self.maps.items()},
                          alpha * self.offset)


def constant_value(e: Expression) -> np.ndarray:
    """Numerically evaluate a DCP-constant expression (dense numpy)."""
    t = e.expr_type
    if t == ExprType.CONSTANT:
        if "scalar" in e.attr:
            return np.full((1, 1), e.attr["scalar"])
        v = e.attr["value"]
        return v.toarray() if sp.issparse(v) else np.asarray(v, dtype=float)
    if t == ExprType.VARIABLE and e.attr.get("is_parameter"):
        var = e.attr.get("var_object")
        if var is None or var.value is None:
            raise ValueError(f"Parameter {e.attr['variable_id']} has no value")
        val = np.asarray(var.value, dtype=float)
        return val.reshape(e.size) if val.size > 1 else np.full((1, 1), float(val))
    args = [constant_value(a) for a in e.args]
    if t == ExprType.ADD:
        out = np.zeros(e.size)
        for a in args:
            out = out + (a if a.size > 1 else float(a.ravel()[0]))
        return out
    if t == ExprType.NEGATE:
        return -args[0]
    if t == ExprType.MULTIPLY:
        a, b = args
        if a.size == 1:
            return float(a.ravel()[0]) * b
        if b.size == 1:
            return a * float(b.ravel()[0])
        return a @ b
    if t == ExprType.MULTIPLY_ELEMENTWISE:
        return args[0] * args[1]
    if t == ExprType.INDEX:
        return args[0][e.attr["key"]]
    if t == ExprType.TRANSPOSE:
        return args[0].T
    if t == ExprType.RESHAPE:
        return args[0].reshape(e.size, order="F")
    if t == ExprType.SUM:
        axis = e.attr.get("axis")
        out = args[0].sum(axis=axis, keepdims=True) if axis is not None \
            else np.full((1, 1), args[0].sum())
        return out
    if t == ExprType.HSTACK:
        return np.hstack(args)
    if t == ExprType.VSTACK:
        return np.vstack(args)
    if t == ExprType.DIAG_VEC:
        return np.diag(args[0].ravel(order="F"))
    if t == ExprType.DIAG_MAT:
        return np.diag(args[0]).reshape(-1, 1)
    if t == ExprType.TRACE:
        return np.full((1, 1), np.trace(args[0]))
    if t == ExprType.UPPER_TRI:
        A = args[0]
        n = A.shape[0]
        vals = [A[i, j] for i in range(n) for j in range(i + 1, n)]
        return np.asarray(vals).reshape(-1, 1)
    if t == ExprType.KRON:
        return np.kron(args[0], args[1])
    if t == ExprType.ABS:
        return np.abs(args[0])
    if t == ExprType.POWER:
        return np.power(args[0], e.attr["p"])
    if t == ExprType.SQUARE_ROOT:
        return np.sqrt(args[0])
    if t == ExprType.EXP:
        return np.exp(args[0])
    if t == ExprType.LOG:
        return np.log(args[0])
    if t == ExprType.MAX_ELEMENTWISE:
        out = args[0]
        for a in args[1:]:
            out = np.maximum(out, a)
        return out
    if t == ExprType.MIN_ELEMENTWISE:
        out = args[0]
        for a in args[1:]:
            out = np.minimum(out, a)
        return out
    # nonlinear scalar-valued atoms at constants (constant_atoms_test.py
    # parity: the compiler must evaluate EVERY atom at constants, not just
    # the affine/elementwise ones)
    if t == ExprType.ENTR:
        x = args[0]
        return np.where(x > 0, -x * np.log(np.where(x > 0, x, 1.0)), 0.0)
    if t == ExprType.LOGISTIC:
        return np.logaddexp(0.0, args[0])
    if t == ExprType.HUBER:
        M = float(e.attr["M"])
        a = np.abs(args[0])
        return np.where(a <= M, a * a, 2 * M * a - M * M)
    if t == ExprType.KL_DIV:
        x, y = args
        return np.full((1, 1), float(np.sum(x * np.log(x / y) - x + y)))
    if t == ExprType.NORM_P:
        p = e.attr["p"]
        axis = e.attr.get("axis")
        x = args[0]
        if axis is None:
            return np.full((1, 1), np.linalg.norm(x.ravel(), ord=p))
        out = np.linalg.norm(x, ord=p, axis=axis)
        return out.reshape(e.size)
    if t == ExprType.QUAD_OVER_LIN:
        x, y = args
        return np.full((1, 1), float(np.sum(x * x) / float(y.ravel()[0])))
    if t == ExprType.LOG_SUM_EXP:
        axis = e.attr.get("axis")
        x = args[0]
        if axis is None:
            m = float(np.max(x))
            return np.full((1, 1), m + np.log(np.sum(np.exp(x - m))))
        m = np.max(x, axis=axis, keepdims=True)
        out = (np.squeeze(m, axis=axis)
               + np.log(np.sum(np.exp(x - m), axis=axis)))
        return out.reshape(e.size)
    if t == ExprType.MAX_ENTRIES:
        axis = e.attr.get("axis")
        if axis is None:
            return np.full((1, 1), np.max(args[0]))
        return np.max(args[0], axis=axis).reshape(e.size)
    if t == ExprType.MIN_ENTRIES:
        axis = e.attr.get("axis")
        if axis is None:
            return np.full((1, 1), np.min(args[0]))
        return np.min(args[0], axis=axis).reshape(e.size)
    if t == ExprType.SUM_LARGEST:
        x = np.sort(args[0].ravel())[::-1]
        return np.full((1, 1), float(np.sum(x[:int(e.attr["k"])])))
    if t == ExprType.GEO_MEAN:
        x = args[0].ravel()
        return np.full((1, 1), float(np.exp(np.mean(np.log(x)))))
    if t == ExprType.LOG_DET:
        return np.full((1, 1), float(np.linalg.slogdet(args[0])[1]))
    if t == ExprType.NORM_NUC:
        s = np.linalg.svd(args[0], compute_uv=False)
        return np.full((1, 1), float(np.sum(s)))
    if t == ExprType.LAMBDA_MAX:
        return np.full((1, 1), float(np.linalg.eigvalsh(args[0])[-1]))
    if t == ExprType.LAMBDA_MIN:
        return np.full((1, 1), float(np.linalg.eigvalsh(args[0])[0]))
    if t == ExprType.SIGMA_MAX:
        s = np.linalg.svd(args[0], compute_uv=False)
        return np.full((1, 1), float(s[0]))
    if t == ExprType.MATRIX_FRAC:
        x, P = args
        x = x.ravel()
        return np.full((1, 1), float(x @ np.linalg.solve(P, x)))
    raise ValueError(f"cannot evaluate constant expression {t}")


def _const_as_linop(e: Expression, m: int) -> linop.LinOp:
    """A DCP-constant multiplier as a structured operator for left-mult
    (``linear.py:multiply_constant``)."""
    if e.expr_type == ExprType.CONSTANT:
        if "scalar" in e.attr:
            return linop.scalar(e.attr["scalar"], m)
        v = e.attr["value"]
        if sp.issparse(v):
            return _folded(linop.sparse(v))
        return _folded(linop.dense(v))   # device constants stay device-resident
    if e.expr_type == ExprType.TRANSPOSE:
        return _const_as_linop(e.args[0], m).T
    # general constant: evaluate
    val = constant_value(e)
    if val.size == 1:
        return linop.scalar(float(val.ravel()[0]), m)
    return _folded(linop.dense(val))


def _folded(op: linop.LinOp) -> linop.LinOp:
    """Count the host bytes of a constant folded into an operator
    (``compile.folded_bytes``)."""
    A = op.A
    if sp.issparse(A):
        count("compile.folded_bytes", A.data.nbytes + A.indices.nbytes + A.indptr.nbytes)
    else:
        count("compile.folded_bytes", A.nbytes)
    return op


def _kron_left_map(A: np.ndarray, mb: int, nb: int) -> linop.LinOp:
    """Map vec(X) -> vec(A (x) X) for X in R^{mb x nb}, A constant
    (``linear_map.kronecker_product_single_arg``)."""
    ma, na = A.shape
    out_rows = ma * mb * na * nb
    rows, cols, vals = [], [], []
    # vec index of (A kron X)[ia*mb + ib, ja*nb + jb] with column-major vec:
    # r = (ia*mb + ib) + (ja*nb + jb) * (ma*mb)
    for ja in range(na):
        for ia in range(ma):
            a = A[ia, ja]
            if a == 0:
                continue
            for jb in range(nb):
                for ib in range(mb):
                    r = (ia * mb + ib) + (ja * nb + jb) * (ma * mb)
                    c = ib + jb * mb
                    rows.append(r)
                    cols.append(c)
                    vals.append(a)
    M = sp.csr_matrix((vals, (rows, cols)),
                      shape=(out_rows, mb * nb))
    return linop.sparse(M)


def fold_affine(e: Expression) -> AffineFold:
    """Fold a DCP-affine expression into var maps + offset (column-major
    vec semantics throughout)."""
    t = e.expr_type
    dim = e.dim

    if e.dcp_props.constant:
        return AffineFold({}, constant_value(e).ravel(order="F"))

    if t == ExprType.VARIABLE:
        return AffineFold({e.attr["variable_id"]: linop.identity(dim)},
                          np.zeros(dim))

    if t == ExprType.ADD:
        out = AffineFold({}, np.zeros(dim))
        for a in e.args:
            fa = fold_affine(a)
            if fa.dim == 1 and dim != 1:
                fa = fa.compose(linop.promote(dim))
            out = out + fa
        return out

    if t == ExprType.NEGATE:
        return fold_affine(e.args[0]).scale(-1.0)

    if t == ExprType.MULTIPLY:
        a, b = e.args
        m, n = e.size
        if a.dcp_props.constant:
            fb = fold_affine(b)
            if a.dim == 1:
                alpha = float(constant_value(a).ravel()[0])
                return fb.scale(alpha)
            if b.dim == 1:
                # constant matrix * scalar expr
                col = constant_value(a).ravel(order="F")
                return fb.compose(linop.dense(col.reshape(-1, 1)))
            A = _const_as_linop(a, m)
            return fb.compose(linop.left_matrix_product(A, n))
        if b.dcp_props.constant:
            fa = fold_affine(a)
            if b.dim == 1:
                beta = float(constant_value(b).ravel()[0])
                return fa.scale(beta)
            if a.dim == 1:
                row = constant_value(b).ravel(order="F")
                return fa.compose(linop.dense(row.reshape(-1, 1)))
            B = _const_as_linop(b, n)
            return fa.compose(linop.right_matrix_product(B, m))
        raise ValueError("multiply of two non-constant expressions")

    if t == ExprType.MULTIPLY_ELEMENTWISE:
        a, b = e.args
        c_expr, x_expr = (a, b) if a.dcp_props.constant else (b, a)
        if not c_expr.dcp_props.constant:
            raise ValueError("elementwise multiply of two non-constants")
        fx = fold_affine(x_expr)
        c = constant_value(c_expr).ravel(order="F")
        if c.size == 1:
            return fx.scale(float(c[0]))
        if fx.dim == 1 and c.size != 1:
            fx = fx.compose(linop.promote(c.size))
        return fx.compose(linop.diagonal(c))

    if t == ExprType.INDEX:
        x = e.args[0]
        ki, kj = e.attr["key"]
        row_sel = linop.index_op(*ki.indices(x.m), x.m)
        col_sel = linop.index_op(*kj.indices(x.n), x.n)
        return fold_affine(x).compose(linop.kronecker(col_sel, row_sel))

    if t == ExprType.TRANSPOSE:
        x = e.args[0]
        return fold_affine(x).compose(linop.transpose_matrix(x.m, x.n))

    if t == ExprType.RESHAPE:
        return fold_affine(e.args[0])

    if t == ExprType.SUM:
        x = e.args[0]
        axis = e.attr.get("axis")
        if axis is None:
            return fold_affine(x).compose(
                linop.kronecker(linop.sum_op(x.n), linop.sum_op(x.m)))
        if axis == 0:
            return fold_affine(x).compose(linop.sum_left(x.m, x.n))
        return fold_affine(x).compose(linop.sum_right(x.m, x.n))

    if t == ExprType.HSTACK:
        m, n = e.size
        out = AffineFold({}, np.zeros(dim))
        offset = 0
        for a in e.args:
            # embed columns [offset, offset+a.n) of the stack
            emb = linop.rows_op(np.arange(offset * m, (offset + a.n) * m), dim).T
            out = out + fold_affine(a).compose(emb)
            offset += a.n
        return out

    if t == ExprType.VSTACK:
        m, n = e.size
        out = AffineFold({}, np.zeros(dim))
        offset = 0
        for a in e.args:
            # rows [offset, offset+a.m): vec index i + j*m
            idx = np.concatenate([offset + np.arange(a.m) + j * m
                                  for j in range(n)])
            emb = linop.rows_op(idx, dim).T
            out = out + fold_affine(a).compose(emb)
            offset += a.m
        return out

    if t == ExprType.DIAG_VEC:
        return fold_affine(e.args[0]).compose(linop.diag_vec(e.args[0].m))

    if t == ExprType.DIAG_MAT:
        return fold_affine(e.args[0]).compose(linop.diag_mat(e.size[0]))

    if t == ExprType.TRACE:
        return fold_affine(e.args[0]).compose(linop.trace_op(e.args[0].m))

    if t == ExprType.UPPER_TRI:
        return fold_affine(e.args[0]).compose(linop.upper_tri_op(e.args[0].m))

    if t == ExprType.KRON:
        a, b = e.args
        if not a.dcp_props.constant:
            raise ValueError("kron: first argument must be constant")
        A = constant_value(a)
        return fold_affine(b).compose(_kron_left_map(A, b.m, b.n))

    if t == ExprType.POWER and e.attr["p"] == 1.0:
        return fold_affine(e.args[0])

    raise ValueError(f"not an affine node: {t}")


def fold_to_operator(args, row_keys) -> AffineOperator:
    """Assemble per-arg AffineFolds into an AffineOperator with the given
    row keys (``affine.cc:121-140``)."""
    A = BlockMatrix()
    b = BlockVector()
    for fold, key in zip(args, row_keys):
        for var, M in fold.maps.items():
            A.insert(key, var, M)
        if np.any(fold.offset != 0):
            # host array: converted at apply time via BlockVector.to_device
            # so it participates in constant lifting
            b[key] = fold.offset.astype(np.float64)
    return AffineOperator(A, b)


# -- structure predicates used by the prox compiler -------------------------

def fold_is_diagonal(f: AffineFold) -> bool:
    """True if the fold is elementwise on a single variable (diagonal map),
    the reference's AffineProperties.diagonal (``affine.py:97-126``)."""
    if len(f.maps) != 1:
        return len(f.maps) == 0
    M = next(iter(f.maps.values()))
    return M.m == M.n and M.is_diagonal


def fold_is_scalar(f: AffineFold) -> bool:
    if len(f.maps) != 1:
        return len(f.maps) == 0
    M = next(iter(f.maps.values()))
    return M.m == M.n and M.is_scalar
