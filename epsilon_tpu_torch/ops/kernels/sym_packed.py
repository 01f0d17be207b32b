"""Symmetric-packed apply ``y = M X``, reading only M's lower triangle.

Hand-written CUDA counterpart of the Pallas TPU kernel
``sym_packed_matmul`` (``epsilon_tpu/ops/pallas_kernels.py``, kernel body
``_sym_kernel``).  Large cached KKT pivots applied as explicit inverses are
symmetric, so only the n^2/2 elements of the packed lower triangle need to
leave device memory; each off-diagonal tile is applied twice, as
``M_ij x_j`` into row block i and ``M_ij^T x_i`` into row block j.

The apply is bound by device memory: at n = 8192 in f32 the packed
triangle is 134 MB, about 40 us at the H100's 3.35 TB/s.  The kernel
(``csrc/sym_packed.cu``) reads each tile once, for any number R of x's
columns: pass 1 writes both products of every tile to a per-tile partial
buffer (one column: one block a tile, from registers; several: the tile,
or in f64 each half of it, staged in shared memory while the block loops
over x's columns in chunks); pass 2 sums each row block's contributions
in the fixed order of the plan built by :func:`sym_packed_plan`.  No
float atomics, so results repeat bitwise.

On a CPU tensor :func:`sym_packed_matmul` runs the plain PyTorch version
:func:`sym_packed_matmul_reference`; on a CUDA tensor it launches the kernel
or raises.  The library is compiled with ``nvcc`` at first use from the
package's own source into ``build/kernels/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["SYM_TILE", "pack_sym_tiles", "sym_packed_plan", "sym_packed_matmul",
           "sym_packed_matmul_reference", "build", "launches", "launches_by_width"]

# Tile edge on the H100: a 128 x 128 tile gives each lane of a warp 4
# consecutive columns (one 16-byte f32 load per row), and n = 8192 gives
# 2080 tiles to spread over the 132 SMs.  The JAX package's tile=512 was
# sized for v5e VMEM.
SYM_TILE = 128

# Kernel launches made by sym_packed_matmul (CUDA tensors only), in all and
# by the width R of x (``{R: launches}``).
launches = 0
launches_by_width = {}

_LIB = None


def pack_sym_tiles(M, tile: int = SYM_TILE, dtype=None):
    """Pack the lower triangle of symmetric ``M`` (host numpy, n x n) into
    ``(tiles, ii, jj, n_pad)``: ``tiles[k]`` is the (tile x tile) block at
    block coordinates ``(ii[k], jj[k])``, ``ii >= jj``.  Rows and columns
    are zero-padded to a tile multiple.  Same layout as the JAX package's
    ``pack_sym_tiles``."""
    n = M.shape[0]
    B = -(-n // tile)
    n_pad = B * tile
    Mp = np.zeros((n_pad, n_pad), dtype=dtype or M.dtype)
    Mp[:n, :n] = M
    ks = [(i, j) for i in range(B) for j in range(i + 1)]
    tiles = np.stack([Mp[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
                      for i, j in ks])
    ii = np.array([i for i, _ in ks], dtype=np.int32)
    jj = np.array([j for _, j in ks], dtype=np.int32)
    return tiles, ii, jj, n_pad


def sym_packed_plan(ii, jj, B: int):
    """The kernel's reduction plan: for each row block b, the partial-buffer
    slots that add into it, in a fixed order.  Slot ``2k`` holds tile k's
    ``M_ij x_j`` (into block ``ii[k]``), slot ``2k + 1`` its ``M_ij^T x_i``
    (into block ``jj[k]``, off-diagonal tiles only).  Returns int32
    ``(row_ptr (B+1,), entries)`` in CSR form."""
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    if ii.shape != jj.shape or ii.ndim != 1:
        raise ValueError(f"ii {ii.shape} and jj {jj.shape} must be equal 1-D")
    if ii.size and (ii.min() < 0 or ii.max() >= B or jj.min() < 0
                    or (jj > ii).any()):
        raise ValueError(f"tile coordinates must satisfy 0 <= jj <= ii < {B}")
    k = np.arange(ii.size)
    off = ii != jj
    block = np.concatenate([ii, jj[off]])
    slot = np.concatenate([2 * k, 2 * k[off] + 1])
    order = np.argsort(block, kind="stable")
    row_ptr = np.zeros(B + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(block, minlength=B))
    return row_ptr, slot[order].astype(np.int32)


def sym_packed_matmul_reference(tiles, ii, jj, x):
    """Plain PyTorch ``y = M @ x`` for packed ``tiles`` at block coordinates
    ``(ii, jj)``; ``x`` (n_pad, R) -> (n_pad, R).  Accumulates in at least
    f32, as the JAX kernel does."""
    K, T, _ = tiles.shape
    n_pad, R = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    t = tiles.to(acc)
    xb = x.to(acc).reshape(n_pad // T, T, R)
    ii, jj = ii.long(), jj.long()
    off = ii != jj
    y = torch.zeros_like(xb)
    y.index_add_(0, ii, torch.bmm(t, xb[jj]))
    y.index_add_(0, jj[off], torch.bmm(t[off].transpose(1, 2), xb[ii[off]]))
    return y.reshape(n_pad, R).to(x.dtype)


def build():
    """Compile ``csrc/sym_packed.cu`` (see :func:`._build.build`).  Returns
    ``(path, seconds, compiler_log)``."""
    return _build.build("sym_packed")


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.sym_packed_tile.argtypes = []
        lib.sym_packed_tile.restype = ctypes.c_int
        for name in ("sym_packed_matmul_f32", "sym_packed_matmul_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.sym_packed_partial_slots.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sym_packed_partial_slots.restype = ctypes.c_int
        if lib.sym_packed_tile() != SYM_TILE:
            raise RuntimeError("sym_packed library tile does not match SYM_TILE")
        _LIB = lib
    return _LIB


def _check_cuda_args(tiles, ii, jj, x, row_ptr, entries):
    # Plain int and dtype comparisons: this runs on every apply of the
    # solver's hot loop.
    dev = x.device
    for name, t in (("tiles", tiles), ("ii", ii), ("jj", jj), ("x", x),
                    ("row_ptr", row_ptr), ("entries", entries)):
        if t.device != dev:
            raise ValueError(f"sym_packed_matmul: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sym_packed_matmul: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.float64) or tiles.dtype != x.dtype:
        raise TypeError(f"sym_packed_matmul: tiles {tiles.dtype} and x {x.dtype} "
                        "must both be float32 or both float64")
    if tiles.dim() != 3 or tiles.shape[1] != SYM_TILE or tiles.shape[2] != SYM_TILE:
        raise ValueError(f"sym_packed_matmul: tiles {tuple(tiles.shape)} must be "
                         f"(K, {SYM_TILE}, {SYM_TILE})")
    K = tiles.shape[0]
    for name, t in (("ii", ii), ("jj", jj)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != K:
            raise ValueError(f"sym_packed_matmul: {name} must be int32 of shape ({K},)")
    if x.dim() != 2 or x.shape[0] % SYM_TILE or x.shape[1] < 1:
        raise ValueError(f"sym_packed_matmul: x {tuple(x.shape)} must be "
                         f"(n_pad, R) with n_pad a multiple of {SYM_TILE}")
    B = x.shape[0] // SYM_TILE
    if (row_ptr.dtype != torch.int32 or row_ptr.dim() != 1 or row_ptr.shape[0] != B + 1
            or entries.dtype != torch.int32 or entries.dim() != 1):
        raise ValueError("sym_packed_matmul: plan must be int32 (row_ptr (B+1,), entries)")
    if tiles.data_ptr() % 16:
        raise ValueError("sym_packed_matmul: tiles must be 16-byte aligned")


def sym_packed_matmul(tiles, ii, jj, x, plan):
    """``y = M @ x`` with M given as packed lower-triangle ``tiles`` at block
    coordinates ``(ii, jj)``; ``x`` (n_pad, R) -> (n_pad, R).  ``plan`` is
    :func:`sym_packed_plan`'s ``(row_ptr, entries)`` as tensors on x's
    device, built once when the tiles are packed; the plain version on the
    CPU does not read it."""
    if x.device.type == "cpu":
        return sym_packed_matmul_reference(tiles, ii, jj, x)
    if x.device.type != "cuda":
        raise ValueError(f"sym_packed_matmul: unsupported device {x.device}")
    row_ptr, entries = plan
    _check_cuda_args(tiles, ii, jj, x, row_ptr, entries)
    K = tiles.shape[0]
    n_pad, R = x.shape
    lib = _library()
    fn = lib.sym_packed_matmul_f32 if x.dtype == torch.float32 else lib.sym_packed_matmul_f64
    # pass 1's partial buffers, as many a tile as the kernel's launch writes
    slots = K * lib.sym_packed_partial_slots(R, x.element_size())
    partial = torch.empty((slots, SYM_TILE, R), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        launches_by_width[R] = launches_by_width.get(R, 0) + 1
        err = fn(tiles.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 row_ptr.data_ptr(), entries.data_ptr(), x.data_ptr(),
                 partial.data_ptr(), y.data_ptr(), K, n_pad // SYM_TILE, R, stream)
    if err != 0:
        raise RuntimeError(f"sym_packed kernel launch failed with CUDA error {err}")
    return y
