"""Block vector/matrix substrate.

Counterpart of ``epsilon_tpu/ops/block.py``: keyed collections of tensors
and of structured linear operators.  ``BlockVector`` holds tensors in the
hot loop; compiled problem constants keep host numpy leaves, which
:meth:`BlockVector.to_device` converts (once per vector, then cached).
``BlockMatrix`` is a host-side static structure whose ``apply`` runs on
tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import config
from . import linop
from .linop import LinOp

__all__ = ["BlockVector", "BlockMatrix"]


def _zeros_like(v):
    if isinstance(v, np.ndarray):
        return np.zeros_like(v)
    return torch.zeros_like(v)


class BlockVector:
    """map<key, vector> with vector-space ops."""

    def __init__(self, data: Optional[Dict[str, object]] = None):
        self.data: Dict[str, object] = dict(data or {})

    # container ------------------------------------------------------------
    def keys(self):
        return self.data.keys()

    def items(self):
        return self.data.items()

    def __contains__(self, key):
        return key in self.data

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def get(self, key, n: Optional[int] = None):
        """Get-or-zero semantics."""
        if key in self.data:
            return self.data[key]
        if n is None:
            raise KeyError(key)
        return torch.zeros(n, dtype=config.default_dtype(), device=config.device())

    def select(self, keys: Iterable[str]) -> "BlockVector":
        return BlockVector({k: self.data[k] for k in keys if k in self.data})

    def to_device(self) -> "BlockVector":
        """Convert numpy leaves to tensors on the configured device.  The
        result is cached on this vector (problem constants are converted
        once, not every iteration) and rebuilt if a leaf or the device
        changes."""
        key = (config.device(), config.default_dtype(),
               tuple((k, id(v)) for k, v in self.data.items()))
        hit = getattr(self, "_device_cache", None)
        if hit is not None and hit[0] == key:
            return hit[1]
        out = BlockVector({
            k: (linop.to_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in self.data.items()})
        self._device_cache = (key, out)
        return out

    # algebra --------------------------------------------------------------
    def _binary(self, other: "BlockVector", f):
        out = dict(self.data)
        for k, v in other.data.items():
            out[k] = f(out[k], v) if k in out else f(_zeros_like(v), v)
        return BlockVector(out)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, alpha):
        return BlockVector({k: alpha * v for k, v in self.data.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    def dot(self, other: "BlockVector"):
        terms = [torch.vdot(v, other.data[k]) for k, v in self.data.items()
                 if k in other.data]
        if not terms:
            return torch.zeros((), dtype=config.default_dtype(), device=config.device())
        return sum(terms)

    def norm(self):
        return torch.sqrt(self.norm_squared())

    def norm_squared(self):
        terms = [torch.sum(v * v) for v in self.data.values()]
        if not terms:
            return torch.zeros((), dtype=config.default_dtype(), device=config.device())
        return sum(terms)

    @property
    def total_size(self) -> int:
        return sum(int(np.prod(v.shape)) for v in self.data.values())

    def __repr__(self):
        return f"BlockVector({ {k: tuple(v.shape) for k, v in self.data.items()} })"

    # flat packing
    def pack(self, keys=None):
        """Concatenate blocks (sorted keys) into one flat vector + offsets."""
        keys = sorted(self.data) if keys is None else list(keys)
        offsets = {}
        acc = 0
        parts = []
        for k in keys:
            offsets[k] = acc
            acc += int(np.prod(self.data[k].shape))
            parts.append(torch.ravel(self.data[k]))
        if not parts:
            return torch.zeros(0, dtype=config.default_dtype(), device=config.device()), offsets
        return torch.cat(parts), offsets

    @staticmethod
    def unpack(flat, offsets, dims):
        """Inverse of :meth:`pack` given {key: offset} and {key: dim}."""
        return BlockVector({k: flat[off:off + dims[k]]
                            for k, off in offsets.items()})


class BlockMatrix:
    """map<(row_key, col_key), LinOp>.

    Host-side static structure; ``apply`` runs on tensors.
    """

    def __init__(self, blocks: Optional[Dict[Tuple[str, str], LinOp]] = None):
        self.blocks: Dict[Tuple[str, str], LinOp] = dict(blocks or {})

    # construction ---------------------------------------------------------
    def insert(self, row: str, col: str, op: LinOp):
        key = (row, col)
        if key in self.blocks:
            self.blocks[key] = self.blocks[key] + op
        else:
            self.blocks[key] = op
        return self

    def __setitem__(self, key: Tuple[str, str], op: LinOp):
        self.blocks[key] = op

    def __getitem__(self, key: Tuple[str, str]) -> LinOp:
        return self.blocks[key]

    def __contains__(self, key):
        return key in self.blocks

    def row_keys(self):
        return sorted({r for r, _ in self.blocks})

    def col_keys(self):
        return sorted({c for _, c in self.blocks})

    def row_dim(self, row: str) -> int:
        for (r, _), op in self.blocks.items():
            if r == row:
                return op.m
        raise KeyError(row)

    def col_dim(self, col: str) -> int:
        for (_, c), op in self.blocks.items():
            if c == col:
                return op.n
        raise KeyError(col)

    def col_blocks(self, col: str) -> Dict[str, LinOp]:
        return {r: op for (r, c), op in self.blocks.items() if c == col}

    def row_blocks(self, row: str) -> Dict[str, LinOp]:
        return {c: op for (r, c), op in self.blocks.items() if r == row}

    # algebra (host-side, eager) -------------------------------------------
    @property
    def T(self) -> "BlockMatrix":
        return BlockMatrix({(c, r): op.T for (r, c), op in self.blocks.items()})

    def __add__(self, other: "BlockMatrix") -> "BlockMatrix":
        out = BlockMatrix(dict(self.blocks))
        for (r, c), op in other.blocks.items():
            out.insert(r, c, op)
        return out

    def __matmul__(self, other):
        if isinstance(other, BlockVector):
            return self.apply(other)
        if isinstance(other, BlockMatrix):
            return self.matmul(other)
        return NotImplemented

    def matmul(self, other: "BlockMatrix") -> "BlockMatrix":
        """Sparse block matmul."""
        out = BlockMatrix()
        other_by_row: Dict[str, Dict[str, LinOp]] = {}
        for (r, c), op in other.blocks.items():
            other_by_row.setdefault(r, {})[c] = op
        for (r, k), op1 in self.blocks.items():
            for c, op2 in other_by_row.get(k, {}).items():
                out.insert(r, c, op1 @ op2)
        return out

    def scale(self, alpha: float) -> "BlockMatrix":
        return BlockMatrix({k: op.scale(alpha) for k, op in self.blocks.items()})

    def select_rows(self, rows) -> "BlockMatrix":
        rows = set(rows)
        return BlockMatrix({(r, c): op for (r, c), op in self.blocks.items()
                            if r in rows})

    def select_cols(self, cols) -> "BlockMatrix":
        cols = set(cols)
        return BlockMatrix({(r, c): op for (r, c), op in self.blocks.items()
                            if c in cols})

    # application (device) --------------------------------------------------
    def apply(self, x: BlockVector) -> BlockVector:
        out: Dict[str, object] = {}
        for (r, c), op in self.blocks.items():
            if c not in x:
                continue
            y = op.matvec(x[c])
            out[r] = out[r] + y if r in out else y
        return BlockVector(out)

    def as_dense(self):
        """Materialize as a single dense matrix with rows/cols ordered by
        sorted key (for tests and small KKT systems)."""
        rows = self.row_keys()
        cols = self.col_keys()
        rdims = {r: self.row_dim(r) for r in rows}
        cdims = {c: self.col_dim(c) for c in cols}
        roff, acc = {}, 0
        for r in rows:
            roff[r] = acc
            acc += rdims[r]
        M = acc
        coff, acc = {}, 0
        for c in cols:
            coff[c] = acc
            acc += cdims[c]
        N = acc
        out = np.zeros((M, N))
        for (r, c), op in self.blocks.items():
            out[roff[r]:roff[r] + rdims[r], coff[c]:coff[c] + cdims[c]] = op.as_dense()
        return out

    def left_identity(self) -> "BlockMatrix":
        """Identity on the row space."""
        return BlockMatrix({(r, r): linop.identity(self.row_dim(r))
                            for r in self.row_keys()})

    def right_identity(self) -> "BlockMatrix":
        return BlockMatrix({(c, c): linop.identity(self.col_dim(c))
                            for c in self.col_keys()})

    def inverse(self) -> "BlockMatrix":
        """Inverse for block-diagonal-permutation matrices: each row and
        column must have exactly one block."""
        by_row: Dict[str, Tuple[str, LinOp]] = {}
        by_col: Dict[str, Tuple[str, LinOp]] = {}
        for (r, c), op in self.blocks.items():
            if r in by_row or c in by_col:
                raise ValueError("BlockMatrix.inverse: not block-diagonal/permutation")
            by_row[r] = (c, op)
            by_col[c] = (r, op)
        return BlockMatrix({(c, r): op.inverse() for (r, c), op in self.blocks.items()})

    def __repr__(self):
        return f"BlockMatrix({ {k: v.shape for k, v in self.blocks.items()} })"
