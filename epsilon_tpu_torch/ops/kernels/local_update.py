"""Fused consensus local update over the leading block axis.

Hand-written CUDA counterpart of the Pallas TPU kernel ``fused_local_update``
(``epsilon_tpu/ops/pallas_kernels.py``, kernel body ``_make_kernel._kernel``).
For each scenario block s::

    x_s    = Finv_s (Atb_s + rho (z - u_s))
    xu_sum = sum_s (x_s + u_s)

The update is bound by bytes: it reads each block's n x n inverse once per
call, S n^2 elements (32 MB at the consensus row's 200 blocks of 200 x 200 in
f32, which stays in the H100's 50 MB L2 between iterations; 4 GB of device
memory at 40 blocks of 5000 x 5000).  The kernels (``csrc/local_update.cu``)
read each element once:

* Pass 1, the ring path: a persistent grid (SM count x resident blocks) whose
  blocks each walk a contiguous run of work items, an item being R consecutive
  rows of one ``Finv_s``.  A producer warp has the copy engine fill a ring of
  STAGES slabs in shared memory (``cp.async.bulk`` completing on an
  ``mbarrier``) and computes ``rhs_s`` under the copy; eight consumer warps
  read slab and right-hand side from shared memory and release the slab
  through a second barrier.
* Pass 1, the streaming path (the earlier design): one short-lived block per
  (s, 32 rows) that loads ``Finv`` straight into registers.  It takes what the
  ring cannot: rows or pointers off 16-byte alignment, and rows so long that
  two slabs do not fit in shared memory.
* Pass 2 sums ``x + u`` over the blocks in a fixed order.  It is a launch of
  its own, chained to pass 1 by programmatic dependent launch, so its launch
  and ramp overlap pass 1.

:func:`local_update_plan` chooses the path and the ring's sizes from the
shape, the element size and the alignment alone; the C entry points take the
plan as integers and check it.  No float atomics, and every sum has an order
fixed by (n, dtype, path), so results repeat bitwise.  rho is a runtime
argument: a new rho does not rebuild anything.

On a CPU tensor :func:`fused_local_update` runs the plain PyTorch version
:func:`local_update_reference`; on a CUDA tensor it launches the kernels or
raises.  The library is compiled with ``nvcc`` at first use from the
package's own source into ``build/kernels/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fused_local_update", "local_update_reference", "local_update_supported",
           "local_update_plan", "LocalUpdatePlan", "build", "launches"]

# Kernel launches made by fused_local_update (CUDA tensors only).
launches = 0
# The plan of the latest launch.
last_plan = None

_LIB = None

# Shared memory of one H100 SM, what the system keeps of it for each resident
# block, and the most one block may ask for.
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
BLOCK_SMEM_LIMIT = 232448
# Rows of Finv_s per block of the streaming path (ROWS_PER_BLOCK in the source).
STREAM_ROWS = 32
# Ring path: 32 rows per item where they make a slab of at most this many
# bytes (then 8 lanes read a row, 4 rows to a consumer warp); longer rows take
# the smallest item, a whole warp to a row.
RING_SLAB_BYTES = 65536
RING_MIN_ROWS = {4: 4, 8: 2}
# Slabs in the ring: on an H100, 2 or 3 with two blocks on an SM beat deeper
# rings with one at every timed shape (tools/profile_port.py --k1-tune).
RING_STAGES = (3, 2)
RING_MIN_ITEMS_PER_BLOCK = 2


class LocalUpdatePlan(NamedTuple):
    """How one call runs: ``path`` "ring" or "stream"; ``rows`` of one
    ``Finv_s`` per work item; for the ring, ``stages`` slabs, ``rhs_bufs``
    right-hand-side buffers, ``lanes`` per row and ``smem_bytes`` of dynamic
    shared memory (all 0 on the streaming path); ``items`` in all and the
    ``grid`` that walks them."""
    path: str
    rows: int
    stages: int
    rhs_bufs: int
    lanes: int
    smem_bytes: int
    items: int
    grid: int


def ring_layout(n, itemsize, rows, stages, rhs_bufs):
    """Byte offsets in the ring kernel's dynamic shared memory: the slabs, the
    right-hand sides, the barriers (a "full" and an "empty" one per stage),
    and the total."""
    slab = rows * n * itemsize
    rhs_stride = -(-n * itemsize // 16) * 16
    slabs = [q * slab for q in range(stages)]
    rhs = [stages * slab + q * rhs_stride for q in range(rhs_bufs)]
    bars = stages * slab + rhs_bufs * rhs_stride
    return slabs, rhs, bars, bars + 16 * stages


def plan_items(plan, S, n):
    """``(s, first row, rows)`` of each work item, in the order of the item
    index; block b of the ring walks items ``[b items // grid + min(b, items
    % grid), ...)``, a block of the streaming path is one item."""
    tiles = -(-n // plan.rows)
    return [(s, t * plan.rows, min(plan.rows, n - t * plan.rows))
            for s in range(S) for t in range(tiles)]


def ring_plan(S, n, itemsize, sm_count, rows, lanes, stages, blocks_per_sm):
    """The ring plan with these sizes (no check that it fits)."""
    rows = min(rows, n)
    tiles = -(-n // rows)
    # a right-hand side is overwritten only when the items that read it are
    # consumed: (rhs_bufs - 1) tiles >= stages - 1
    rhs_bufs = -(-(stages - 1) // tiles) + 1
    smem = ring_layout(n, itemsize, rows, stages, rhs_bufs)[3]
    items = S * tiles
    return LocalUpdatePlan("ring", rows, stages, rhs_bufs, lanes, smem, items,
                           max(1, min(items, sm_count * blocks_per_sm)))


def _ring_that_fits(S, n, itemsize, sm_count, smem_limit):
    """The ring plan for aligned rows of n elements, or None if two slabs of
    the smallest item do not fit: two blocks on an SM if a ring fits in half
    of its shared memory, else one."""
    row = n * itemsize
    if 32 * row <= RING_SLAB_BYTES:
        rows, lanes = 32, 8
    else:
        rows, lanes = RING_MIN_ROWS[itemsize], 32
    for blocks_per_sm in (2, 1):
        budget = min(smem_limit, SM_SMEM_BYTES // blocks_per_sm - BLOCK_RESERVED_SMEM)
        for stages in RING_STAGES:
            plan = ring_plan(S, n, itemsize, sm_count, rows, lanes, stages, blocks_per_sm)
            if plan.smem_bytes <= budget:
                return plan, blocks_per_sm
    return None, 0


@functools.lru_cache(maxsize=256)
def local_update_plan(S, n, itemsize, aligned, sm_count, smem_limit=BLOCK_SMEM_LIMIT):
    """The path and sizes for ``Finv`` of shape (S, n, n) with elements of
    ``itemsize`` bytes on a card of ``sm_count`` SMs.  ``aligned``: every
    operand's pointer is a multiple of 16 bytes.  The ring takes rows that
    are a multiple of 16 bytes and short enough for two slabs of the
    smallest item, where there are at least two items to a persistent
    block; everything else streams.  The ring's ``rows`` and ``lanes``,
    which fix the order of its sums, depend on (n, itemsize) alone."""
    if aligned and (n * itemsize) % 16 == 0:
        plan, blocks_per_sm = _ring_that_fits(S, n, itemsize, sm_count, smem_limit)
        # The ring overlaps one item's copy with another's arithmetic within
        # a block: with fewer than two items to a block it has nothing to
        # overlap, and the streaming path is as fast or faster
        # (tools/profile_port.py --k1-tune, the crossover).
        if plan is not None and plan.items >= RING_MIN_ITEMS_PER_BLOCK * sm_count * blocks_per_sm:
            return plan
    tiles = -(-n // STREAM_ROWS)
    return LocalUpdatePlan("stream", STREAM_ROWS, 0, 0, 0, 0, S * tiles, S * tiles)


def local_update_reference(Finv, Atb, u, z, rho):
    """Plain PyTorch version: ``x`` (S, n) and ``sum(x + u)`` (n,)."""
    rhs = Atb + rho * (z[None, :] - u)
    x = torch.bmm(Finv, rhs.unsqueeze(-1)).squeeze(-1)
    return x, torch.sum(x + u, dim=0)


def local_update_supported(S: int, n: int) -> bool:
    """The JAX package's gate (``pallas_supported``): the fused kernel from
    n = 128, so that the port takes the same branches."""
    return n >= 128


def build():
    """Compile ``csrc/local_update.cu`` (see :func:`._build.build`).
    Returns ``(path, seconds, compiler_log)``."""
    return _build.build("local_update")


def _library():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ("local_update_f32", "local_update_f64"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_double]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda_args(Finv, Atb, u, z):
    dev = Finv.device
    for name, t in (("Finv", Finv), ("Atb", Atb), ("u", u), ("z", z)):
        if t.device != dev:
            raise ValueError(f"fused_local_update: {name} on {t.device}, Finv on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_local_update: {name} must be contiguous")
        if t.dtype != Finv.dtype:
            raise TypeError(f"fused_local_update: {name} is {t.dtype}, Finv {Finv.dtype}")
    if Finv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_local_update: {Finv.dtype} is not float32 or float64")
    if Finv.dim() != 3 or Finv.shape[1] != Finv.shape[2]:
        raise ValueError(f"fused_local_update: Finv {tuple(Finv.shape)} must be (S, n, n)")
    S, n, _ = Finv.shape
    if S < 1 or n < 1 or S >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"fused_local_update: S={S}, n={n} out of range")
    for name, t, shape in (("Atb", Atb, (S, n)), ("u", u, (S, n)), ("z", z, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_local_update: {name} {tuple(t.shape)} must be {shape}")


def _launch(plan, Finv, Atb, u, z, rho):
    """Run ``plan`` (None: the plan of :func:`plan_for`) on CUDA tensors:
    pass 1 by the plan's path, then pass 2."""
    _check_cuda_args(Finv, Atb, u, z)
    if plan is None:
        plan = plan_for(Finv, Atb, u, z)
    S, n, _ = Finv.shape
    fn = (_library().local_update_f32 if Finv.dtype == torch.float32
          else _library().local_update_f64)
    x = torch.empty_like(Atb)
    xu = torch.empty_like(z)
    global launches, last_plan
    with torch.cuda.device(Finv.device):
        stream = torch.cuda.current_stream(Finv.device).cuda_stream
        launches += 1
        last_plan = plan
        err = fn(Finv.data_ptr(), Atb.data_ptr(), u.data_ptr(), z.data_ptr(),
                 float(rho), x.data_ptr(), xu.data_ptr(), S, n,
                 int(plan.path == "ring"), plan.rows, plan.stages, plan.rhs_bufs, plan.lanes,
                 plan.smem_bytes, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"local_update kernel launch failed with CUDA error {err} ({plan})")
    return x, xu


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_for(Finv, Atb, u, z, aligned=None):
    """The plan :func:`fused_local_update` takes for these CUDA tensors;
    ``aligned=False`` gives the streaming path's plan."""
    S, n, _ = Finv.shape
    if aligned is None:
        aligned = (Finv.data_ptr() | Atb.data_ptr() | u.data_ptr() | z.data_ptr()) % 16 == 0
    return local_update_plan(S, n, Finv.element_size(), aligned, _sm_count(Finv.device))


def fused_local_update(Finv, Atb, u, z, rho):
    """Fused consensus local update.

    Args: Finv (S, n, n), Atb (S, n), u (S, n), z (n,), rho a Python float.
    Returns: x (S, n), xu_sum (n,).
    """
    if Finv.device.type == "cpu":
        return local_update_reference(Finv, Atb, u, z, rho)
    if Finv.device.type != "cuda":
        raise ValueError(f"fused_local_update: unsupported device {Finv.device}")
    return _launch(None, Finv, Atb, u, z, rho)
