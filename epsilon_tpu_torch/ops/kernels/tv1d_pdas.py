"""The TV-1D prox by PDAS as one cooperative kernel launch
(``csrc/tv1d_pdas.cu``): every round of the primal-dual active-set loop,
its PCR solve and its stop test on the device, with no host sync between
rounds.

The JAX package compiles ``prox_tv1d_pdas`` (``epsilon_tpu/ops/prox/tv1d.py``,
one ``lax.while_loop``) into one device program.  The port's plain version
(:func:`~epsilon_tpu_torch.ops.prox.tv1d.prox_tv1d_pdas_reference`) issues
each round as eager operations and reads its stop test back to the host.

The kernel (the tile build) runs a round's first PCR levels in shared
memory, a tile of rows and its halo a block, then, where the classes of
rows mod 2^K fit a block's shared memory, the remaining levels there too,
a group of classes a block (the residue stage), and merges passes, so that
a round needs 4 grid syncs, or ``steps - K + 2`` without the residue stage
(:func:`syncs_per_round`; :func:`tile_plan` picks the levels, the tile and
the groups).  The build it replaced, a grid sync after every level and
every pass, stays as :func:`pdas_levels` (uncounted): the tile build is
held to it bitwise.
Both builds count the grid syncs they run on the device
(:func:`sync_counter`).

These are the kernel entries: they take CUDA tensors only and raise on any
other device.  The dispatch (the plain version on a CPU tensor) is in
``ops/prox/tv1d.py``.  :func:`pcr` runs the tile build's PCR solve alone
(uncounted; it is checked bitwise against the plain ``pcr_tridiag_solve``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.timing import count
from . import _rows

__all__ = ["pdas", "pdas_levels", "pcr", "pcr_steps", "tile_plan", "plan_for", "TilePlan",
           "syncs_per_round", "levels_syncs_per_round", "grid_syncs", "sync_counter", "grid",
           "threads", "build", "launches"]

# Launches of the tile build (pdas's; pdas_levels' and pcr's are not
# counted).  While a profiler records, each also counts ``tv1d.residue``:
# 1 where its plan runs the residue stage, else 0.
launches = 0

# Dynamic shared memory a block of the tile build may take, in bytes
# (``SMEM_BUDGET`` in the source): two blocks of 512 threads stay resident
# on an SM, so the tile build runs the levels build's grid and sums in its
# order.
SMEM_BUDGET = 110_592
# A tile level writes a row two passes of 512 rows after computing it, so
# it may read 2^k <= 1024 rows back: at most 11 levels in shared memory.
MAX_TILE_LEVELS = 11
# The PCR levels a tile runs in shared memory, by element size: (least,
# most, without): the rule takes the residue stage at the least K from
# least to most whose classes fit, else K = without and no residue stage.
# From the sweep of K = 6..11 with and without the residue stage at n =
# 10,000, 100,000 and 1,000,000, cold and warm, on an H100 (``python3 -m
# tools.profile_port --k7-tiles``): with it the least K whose classes fit
# was the fastest that fits everywhere, K = 7 at 10,000 (K = 6 ties it, but
# its 64 classes leave two thirds of the grid idle at 100,000, 50 % slower
# there) and 100,000, in f32 3-4 % under K = 8; at 1,000,000 K = 8 in f32
# and K = 9 in f64, where the classes of K = 7 (and 8 in f64) do not fit;
# K = 9 is the deepest measured.  Without it, K = 8 in f32, K = 7 in f64
# (the sweep at 10,000 and 100,000 that set them before the residue stage).
TILE_LEVELS = {4: (7, 9, 8), 8: (7, 9, 7)}

_LIB = None
_GRIDS = {}
_PLANS = {}
_SYNCS = {}


def build():
    """Compile ``csrc/tv1d_pdas.cu``; returns ``(path, seconds, log)``."""
    return _rows.build("tv1d_pdas")


def entries():
    """The C entries of ``csrc/tv1d_pdas.cu`` and their argument types
    (``_rows.load``'s form)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {"tv1d_pdas_threads": [], "tv1d_pdas_smem_budget": []}
    for t in ("f32", "f64"):
        out[f"tv1d_pdas_{t}"] = [P, P, P, "scalar", "scalar", I, I, I, I, I, I, I, P, P, P, P,
                                 P, P, P, P, I, P]
        out[f"tv1d_pdas_levels_{t}"] = [P, P, P, "scalar", "scalar", I, I, I, P, P, P, P, P, P,
                                        P, P, I, P]
        out[f"tv1d_pcr_{t}"] = [P, P, I, I, I, I, I, I, P, I, P]
        for entry in ("pdas", "pcr", "pdas_levels"):
            out[f"tv1d_{entry}_grid_{t}"] = [I]
    return out


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _rows.load("tv1d_pdas", entries())
    return _LIB


def padded(m: int) -> int:
    """The length of each scratch array of a row of m: m rounded up to 32
    elements, so that every array starts on 128 bytes and a warp's 32 rows
    take whole cache lines (``padded`` in the source)."""
    return -(-m // 32) * 32


def pcr_steps(m: int) -> int:
    """The PCR steps of a system of m rows (``pcr_tridiag_solve``'s count)."""
    return max(1, int(np.ceil(np.log2(max(m, 2)))))


@dataclass(frozen=True)
class TilePlan:
    """The tile build's solve of m rows: ``levels`` PCR levels in shared
    memory (K), in tiles of ``tile`` rows (T) with a halo of ``2^K - 1``
    rows on each side, tile t taken by block t mod grid, or, when
    ``whole``, every level over the whole row in every block.  With
    ``group`` > 0 (the residue stage) levels K..steps-1 run in shared
    memory too, on the 2^K classes of rows mod 2^K, ceil(m / 2^K) rows or
    fewer each, ``group`` classes a block at a time, each level testing
    the class's ends.  With group 0 levels K..steps-2 run in device
    memory.  ``window`` rows of a, b, c and d in shared memory (rows past
    the row's ends hold identity rows)."""
    steps: int
    levels: int
    tile: int
    whole: bool
    window: int
    group: int = 0

    @property
    def residue(self) -> bool:
        """Whether levels K..steps-1 run in the residue stage."""
        return self.group > 0

    def smem(self, itemsize: int) -> int:
        """Bytes of dynamic shared memory a block."""
        return 4 * itemsize * self.window

    def scratch_rows(self, m: int) -> int:
        """The length of each of the PDAS's 12 scratch arrays (the PCR's
        8) for m rows: m, or with the residue stage 2^K classes of
        ceil(m / 2^K) rows, rounded up to 32 (``scratch_rows`` in the
        source)."""
        return padded(_classes(m, self.levels) << self.levels if self.residue else m)


def _classes(m, levels):
    # csrc/tv1d_pdas.cu class_rows: rows of the longest class mod 2^levels
    return -(-m >> levels)


def _window(m, levels, tile, whole, group=0):
    # csrc/tv1d_pdas.cu window_slots: the tile and its halos, or the
    # residue stage's group of classes where that is more, or the whole row
    # and 2^(steps-1) rows past each end (levels = steps)
    if whole:
        return m + (1 << levels)
    return max(tile + 2 * ((1 << levels) - 1), group * _classes(m, levels))


def _largest_tile(levels, itemsize):
    """The most rows a tile with ``levels`` levels may hold within
    SMEM_BUDGET (below 1: none)."""
    return SMEM_BUDGET // (4 * itemsize) - 2 * ((1 << levels) - 1)


def _classes_held(m, levels, itemsize):
    """The classes of the residue stage after ``levels`` levels that a
    window holds within SMEM_BUDGET (0: a class does not fit)."""
    return SMEM_BUDGET // (4 * itemsize) // _classes(m, levels)


def tile_plan(m: int, grid: int, itemsize: int, levels: int | None = None,
              residue: bool | None = None) -> TilePlan:
    """The rule of the tile build for a system of m rows on ``grid`` blocks
    in elements of ``itemsize`` bytes: K levels (the least K of
    TILE_LEVELS[itemsize]'s range at which the residue stage fits, else its
    depth without; or ``levels``, for a sweep); when K reaches the solve's
    steps, every block solves the whole row (K = steps); otherwise tiles of
    T = ceil(m / grid) rows, one a block, fewer rows (and some blocks two
    tiles or more) where the window would not fit SMEM_BUDGET, and the
    residue stage wherever a class of ceil(m / 2^K) rows fits SMEM_BUDGET
    (``residue``, for a sweep: True takes it, False keeps levels K..steps-2
    in device memory), in groups of as many classes as the budget holds, up
    to the 2^K classes' share of the grid.  Raises for a ``levels`` outside
    1..MAX_TILE_LEVELS or one whose halos do not fit, or a residue stage
    that does not fit."""
    if m < 1 or grid < 1 or itemsize not in TILE_LEVELS:
        raise ValueError(f"tile_plan: m {m}, grid {grid}, itemsize {itemsize}")
    steps = pcr_steps(m)
    k = levels
    if levels is None:
        least, most, k = TILE_LEVELS[itemsize]
        if k < steps and residue is not False:
            for depth in range(least, min(steps, most + 1)):
                if _largest_tile(depth, itemsize) < 1:
                    break
                if _classes_held(m, depth, itemsize) >= 1:
                    k = depth
                    break
    if not 1 <= k <= MAX_TILE_LEVELS:
        raise ValueError(f"tile_plan: levels {k} outside 1..{MAX_TILE_LEVELS}")
    if k >= steps:
        return TilePlan(steps, steps, m, True, _window(m, steps, m, True))
    most = _largest_tile(k, itemsize)
    if most < 1:
        raise ValueError(f"tile_plan: {k} levels' halos exceed {SMEM_BUDGET} bytes of shared "
                         f"memory in elements of {itemsize} bytes")
    tile = min(-(-m // grid), most)
    rows = _classes(m, k)
    held = _classes_held(m, k, itemsize)
    if residue is None:
        residue = held >= 1
    elif residue and held < 1:
        raise ValueError(f"tile_plan: a class of {rows} rows exceeds {SMEM_BUDGET} bytes of "
                         f"shared memory in elements of {itemsize} bytes")
    if not residue:
        return TilePlan(steps, k, tile, False, _window(m, k, tile, False))
    group = min(-(-(1 << k) // grid), held)
    return TilePlan(steps, k, tile, False, _window(m, k, tile, False, group), group)


def plan_for(v: torch.Tensor) -> TilePlan:
    """The plan of :func:`pdas` for the vector v (its length, dtype and
    device), cached."""
    key = (v.shape[0], v.dtype, v.device)
    if key not in _PLANS:
        n = v.shape[0]
        _PLANS[key] = tile_plan(n - 1, grid("pdas", n, v), v.element_size())
    return _PLANS[key]


def syncs_per_round(plan: TilePlan) -> int:
    """Grid syncs a PDAS round of the tile build: one after the tile stage,
    then one after the residue stage, or one after each level in device
    memory (K..steps-2), then one after the trials (the last level merged
    without the residue stage) and one after the step (the next start
    merged); 2 when the whole solve runs in shared memory."""
    if plan.whole:
        return 2
    return 4 if plan.residue else plan.steps - plan.levels + 2


def levels_syncs_per_round(steps: int) -> int:
    """Grid syncs a PDAS round of the levels build: after the start, each
    PCR level, the trials and the step."""
    return steps + 3


def grid_syncs(rounds: int, per_round: int) -> int:
    """Grid syncs of a PDAS call of ``rounds`` rounds: the rounds' and two
    more (after the opening sums and before the final gap's)."""
    return 2 + rounds * per_round


def sync_counter(device) -> torch.Tensor:
    """The grid syncs that launches of :func:`pdas` and :func:`pdas_levels`
    have run on the CUDA ``device``: one int64 there, to which each launch
    adds the syncs its block 0 counted.  Zero it with ``.zero_()``; reading
    it is a host sync."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _SYNCS:
        _SYNCS[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _SYNCS[device]


def threads() -> int:
    """Threads a block of the kernels."""
    return _library().tv1d_pdas_threads()


def grid(entry: str, length: int, t: torch.Tensor) -> int:
    """The blocks of a launch of ``entry`` (``"pdas"``, ``"pdas_levels"``
    or ``"pcr"``) over ``length`` elements of t's dtype on t's device: the
    blocks the card keeps resident, or the row's, whichever is fewer."""
    key = (entry, length, t.dtype, t.device)
    if key not in _GRIDS:
        with torch.cuda.device(t.device):
            g = getattr(_library(), f"tv1d_{entry}_grid_{_rows.suffix(t)}")(length)
        if g <= 0:
            raise RuntimeError(f"tv1d_{entry}: the occupancy query failed on {t.device}")
        _GRIDS[key] = g
    return _GRIDS[key]


def _vector(fname, name, a, n=None):
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{fname}: {name} must be a tensor, got {type(a).__name__}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fname}: {name} must be float32 or float64, got {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"{fname}: the kernel needs a CUDA tensor, got one on {a.device}")
    if a.dim() != 1 or (n is not None and a.shape[0] != n):
        want = "a vector" if n is None else f"a vector of {n}"
        raise ValueError(f"{fname}: {name} {tuple(a.shape)} must be {want}")
    if a.shape[0] >= 2 ** 31 - 1024:
        raise ValueError(f"{fname}: {name} {tuple(a.shape)} is too large")
    return a.contiguous()


def pdas(v, lam, tol: float, max_iters: int = 40, z0=None):
    """The TV-1D prox of the vector v (CUDA, f32 or f64, n >= 2) by PDAS
    at the gap tolerance ``tol`` (``tv1d.tv_gap_tol``), at most
    ``max_iters`` rounds, from the dual ``z0`` (n - 1, clamped into the
    box) or from 0; ``lam`` a number or a one-element tensor (on v's device
    it is read there, never on the host).  Returns ``(x, z, gap, rounds)``,
    gap a 0-d tensor of v's dtype and rounds a 0-d int32 tensor, all on v's
    device.  One launch of the tile build."""
    return _launch_pdas(_pdas_args("tv1d_pdas", v, lam, z0), tol, max_iters, "tiles")


def pdas_levels(v, lam, tol: float, max_iters: int = 40, z0=None):
    """:func:`pdas` by the levels build (a grid sync after every PCR level
    and every pass), which the tile build replaced: the same bits
    (uncounted)."""
    return _launch_pdas(_pdas_args("tv1d_pdas_levels", v, lam, z0), tol, max_iters, "levels")


def _pdas_args(fname, v, lam, z0):
    v = _vector(fname, "v", v)
    n = v.shape[0]
    if n < 2:
        raise ValueError(f"{fname}: v {tuple(v.shape)} needs at least two elements")
    lam_ptr, lam_value, keep = None, 0.0, None
    if isinstance(lam, torch.Tensor):
        if lam.numel() != 1:
            raise ValueError(f"{fname}: lam {tuple(lam.shape)} must be one value")
        if lam.device.type == "cpu":
            lam_value = float(lam.reshape(()))
        elif lam.device != v.device:
            raise ValueError(f"{fname}: lam on {lam.device}, v on {v.device}")
        else:
            keep = lam.reshape(()).to(v.dtype)
            lam_ptr = keep.data_ptr()
    else:
        lam_value = float(lam)
    if z0 is not None:
        if not isinstance(z0, torch.Tensor) or z0.device != v.device:
            raise ValueError(f"{fname}: z0 must be a tensor on {v.device}")
        z0 = _vector(fname, "z0", z0.to(v.dtype), n - 1)
    return fname, v, lam_ptr, lam_value, keep, z0


def _launch_pdas(args, tol, max_iters, build_name, plan=None):
    """One launch of the tile build (``"tiles"``; its plan from
    :func:`plan_for`, or ``plan`` for a sweep; counted in ``launches`` and
    ``tv1d.residue``) or of the levels build (``"levels"``)."""
    global launches
    fname, v, lam_ptr, lam_value, _, z0 = args   # args holds lam's tensor through the launch
    n = v.shape[0]
    m, mp = n - 1, padded(n - 1)
    entry = "pdas" if build_name == "tiles" else "pdas_levels"
    g = grid(entry, n, v)
    x = torch.empty_like(v)
    z = torch.empty(m, dtype=v.dtype, device=v.device)
    gap = torch.empty((), dtype=v.dtype, device=v.device)
    rounds = torch.empty((), dtype=torch.int32, device=v.device)
    if build_name == "tiles":
        plan = plan or plan_for(v)
        mp = plan.scratch_rows(m)
    scratch = torch.empty(12 * mp + 16 * g, dtype=v.dtype, device=v.device)
    # the active set, a byte a row: the tile build's by round parity
    act = torch.empty((2 if build_name == "tiles" else 1) * m, dtype=torch.int8,
                      device=v.device)
    flags = torch.empty(2 * g, dtype=torch.int32, device=v.device)
    head = (v.data_ptr(), None if z0 is None else z0.data_ptr(), lam_ptr, lam_value,
            float(tol), n, int(max_iters), pcr_steps(m))
    tail = (x.data_ptr(), z.data_ptr(), gap.data_ptr(), rounds.data_ptr(),
            sync_counter(v.device).data_ptr(), scratch.data_ptr(), act.data_ptr(),
            flags.data_ptr(), g)
    if build_name == "tiles":
        head += (plan.levels, plan.tile, int(plan.whole), plan.group)
    fn = getattr(_library(), f"tv1d_{entry}_{_rows.suffix(v)}")
    if build_name == "tiles":
        launches += 1
        count("tv1d.residue", int(plan.residue))
    _rows.launch(fname, fn, head + tail, v)
    return x, z, gap, rounds


def pcr(a, b, c, d, levels=None, residue=None):
    """``pcr_tridiag_solve(a, b, c, d)`` for vectors on the card (f32 or
    f64) by the tile build's PCR code in one cooperative launch
    (uncounted), on the PDAS's grid for a row of m + 1: its plan from
    :func:`tile_plan`, with a sweep's ``levels`` and ``residue`` where
    given."""
    fname = "tv1d_pcr"
    a = _vector(fname, "a", a)
    m = a.shape[0]
    if m < 1:
        raise ValueError(f"{fname}: the system needs at least one row")
    b, c, d = (_vector(fname, name, t, m) for name, t in (("b", b), ("c", c), ("d", d)))
    if not all(t.dtype == a.dtype and t.device == a.device for t in (b, c, d)):
        raise ValueError(f"{fname}: a, b, c and d must share a dtype and a device")
    g = grid("pcr", m, a)
    plan = tile_plan(m, g, a.element_size(), levels, residue)
    mp = padded(m)
    src = torch.zeros(4, mp, dtype=a.dtype, device=a.device)
    for row, t in zip(src, (a, b, c, d)):
        row[:m] = t
    out = torch.empty_like(a)
    scratch = torch.empty(8 * plan.scratch_rows(m), dtype=a.dtype, device=a.device)
    fn = getattr(_library(), f"tv1d_pcr_{_rows.suffix(a)}")
    _rows.launch(fname, fn, (src.data_ptr(), out.data_ptr(), m, plan.steps, plan.levels,
                             plan.tile, int(plan.whole), plan.group, scratch.data_ptr(), g),
                   a)
    return out
