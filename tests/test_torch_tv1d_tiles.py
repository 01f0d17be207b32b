"""The premises of the TV-1D kernel's tile build (``csrc/tv1d_pdas.cu``),
on the CPU: its schedule of the PCR solve, emulated in plain PyTorch by
``tv1d.pcr_tiled_solve`` (tiles of T rows with a halo of 2^K - 1 rows run
levels 0..K-1 in a window, then the levels left run over the whole row or,
in the residue stage, class by class of the rows mod 2^K, in windows of a
group of classes), gives ``pcr_tridiag_solve``'s bits; the rule that picks
K, T and the residue stage (``tv1d_pdas.tile_plan``) keeps K within the
solve's steps and the windows within the shared memory budget; and the
grid syncs a round are as the design counts them.

Tolerances: the emulation against the plain solve bitwise (each row's
operations are the same, in the same order); against the JAX package's
``pcr_tridiag_solve`` rtol 1e-9, atol 1e-10 in f64, as
``tests/test_torch_tv1d.py`` holds the plain solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ops.prox import tv1d as jtv
from epsilon_tpu_torch.ops.kernels import tv1d_pdas as k7
from epsilon_tpu_torch.ops.prox import tv1d as ttv

RTOL, ATOL = 1e-9, 1e-10
# The main path's tile: n = 100,000 on 196 blocks
TILE = 511
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(autouse=True)
def _one_thread():
    # many small tensor operations: intra-op threads only contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _systems(m, dtype, seed):
    """A diagonally dominant random system and one as a PDAS round builds
    it (pinned rows b = 1, a = c = 0; free rows -1, 2, -1; c = a)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    free = rng.rand(m) < 0.7
    a = t(np.where(free, -1.0, 0.0))
    return {"random": (t(-rng.rand(m)), t(2.5 + rng.rand(m)), t(-rng.rand(m)), t(rng.randn(m))),
            "pdas": (a, t(np.where(free, 2.0, 1.0)), a, t(rng.randn(m)))}


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _edge_lengths(levels):
    """Rows at the tile's and the halo's edges for K = levels."""
    halo = (1 << levels) - 1
    return sorted({1, 2, TILE - 1, TILE, TILE + 1, TILE + halo, (1 << levels) - 1,
                   (1 << levels) + 1, 4097, 10_000} - {0})


@pytest.mark.parametrize("levels", range(1, 16))
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_schedule_is_the_plain_pcr_bitwise(dtype, levels):
    """At every K from 1 to the solve's steps + 1 (past the steps: the
    whole row in one window), on rows at the tile's and the halo's edges,
    the tiled schedule gives pcr_tridiag_solve's bits, with no row read
    before it was computed (that would be NaN)."""
    checked = 0
    for m in _edge_lengths(levels):
        if levels > k7.pcr_steps(m) + 1:
            continue
        for name, system in _systems(m, dtype, m + levels).items():
            got = ttv.pcr_tiled_solve(*system, levels, TILE)
            want = ttv.pcr_tridiag_solve(*system)
            assert torch.isfinite(got).all(), (m, name)
            assert torch.equal(_bits(got), _bits(want)), (m, name)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("m,levels,tile", [(1, 1, TILE), (2, 1, TILE), (510, 8, TILE),
                                           (1021, 8, TILE), (4097, 8, TILE), (10_000, 8, 500),
                                           (10_000, 11, TILE), (10_000, 14, TILE),
                                           (3000, 5, 37)])
def test_tiled_schedule_matches_jax(m, levels, tile):
    """The tiled schedule against the JAX package's pcr_tridiag_solve (f64),
    on both systems, within the plain solve's tolerance."""
    for name, system in _systems(m, torch.float64, 7 * m + levels).items():
        got = ttv.pcr_tiled_solve(*system, levels, tile).numpy()
        want = np.asarray(jtv.pcr_tridiag_solve(*(jnp.asarray(t.numpy()) for t in system)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _grid(n):
    # the card's grid in f32: the 264 blocks an H100 keeps resident, or the row's
    return min(264, -(-n // 512))


def _windows(m, plan):
    """Rows of each tile's window as the kernel lays it out: the tile and
    its halos (the whole row and 2^(steps-1) rows past each end)."""
    if plan.whole:
        reach = 1 << (plan.steps - 1)
        return [m + 2 * reach]
    halo = (1 << plan.levels) - 1
    return [min(t0 + plan.tile, m) - t0 + 2 * halo for t0 in range(0, m, plan.tile)]


@pytest.mark.parametrize("n", [2, 3, 17, 257, 1025, 2049, 4097, 10_000, 100_000, 300_000,
                               1_000_000])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_plan_rule(n, itemsize):
    """The rule's K never passes the solve's steps (at the steps the whole
    row runs in one window), a window (every tile's) fits the plan's and
    the plan's fits the shared memory budget, in f64 too; a tile is the
    row's share of the grid unless the budget cuts it."""
    m = n - 1
    plan = k7.tile_plan(m, _grid(n), itemsize)
    assert plan.steps == k7.pcr_steps(m)
    assert 1 <= plan.levels <= plan.steps
    assert plan.whole == (plan.levels == plan.steps)
    least, most, without = k7.TILE_LEVELS[itemsize]
    fits = [k for k in range(least, min(most, plan.steps - 1) + 1)
            if k7.tile_plan(m, _grid(n), itemsize, levels=k).residue]
    if without >= plan.steps:
        assert plan.levels == plan.steps
    elif fits:
        assert plan.residue and plan.levels == fits[0]
    else:
        assert not plan.residue and plan.levels == without
    assert plan.smem(itemsize) <= k7.SMEM_BUDGET
    assert max(_windows(m, plan)) <= plan.window
    if not plan.whole:
        share = -(-m // _grid(n))
        halo = (1 << plan.levels) - 1
        assert plan.tile <= share
        assert plan.window >= plan.tile + 2 * halo
        if plan.tile < share:
            # cut by the budget: one row more would not fit
            assert 4 * itemsize * (plan.tile + 1 + 2 * halo) > k7.SMEM_BUDGET


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_plan_sweep_bounds(itemsize):
    """A sweep's K from 1 to MAX_TILE_LEVELS at the main path's tile fits
    the budget but K = 11 in f64, whose halos alone pass it; K outside
    1..MAX_TILE_LEVELS raises."""
    for levels in range(1, k7.MAX_TILE_LEVELS + 1):
        if itemsize == 8 and levels == 11:
            with pytest.raises(ValueError, match="shared"):
                k7.tile_plan(99_999, 196, itemsize, levels=levels)
            continue
        plan = k7.tile_plan(99_999, 196, itemsize, levels=levels)
        assert (plan.levels, plan.tile, plan.whole) == (levels, TILE, False)
        assert plan.smem(itemsize) <= k7.SMEM_BUDGET
    for levels in (0, k7.MAX_TILE_LEVELS + 1):
        with pytest.raises(ValueError):
            k7.tile_plan(99_999, 196, itemsize, levels=levels)


@pytest.mark.parametrize("n,steps,tile_syncs,levels_syncs", [
    (100_000, 17, 4, 20), (10_000, 14, 4, 17), (1_000_000, 20, 4, 23), (2_000_000, 21, 4, 24),
    (4_000_000, 22, 16, 25),
    (257, 8, 2, 11), (2, 1, 2, 4)])
def test_syncs_a_round(n, steps, tile_syncs, levels_syncs):
    """Grid syncs a round: 4 for the tile build with the residue stage,
    steps - K + 2 without it (2 when the whole solve runs in shared
    memory), steps + 3 for the levels build; 2 more a call.  In f32: 4
    against 20 at n = 100,000 and 23 at n = 1,000,000 (11 and 14 with K = 8
    without the residue stage); at n = 4,000,000, whose classes do not fit
    at K = 7..9, 16 against 25."""
    plan = k7.tile_plan(n - 1, _grid(n), 4)
    assert plan.steps == steps
    assert k7.syncs_per_round(plan) == tile_syncs
    assert k7.levels_syncs_per_round(steps) == levels_syncs
    assert k7.grid_syncs(7, tile_syncs) == 2 + 7 * tile_syncs
    if plan.whole:
        assert tile_syncs == 2
    if not plan.whole:
        without = k7.tile_plan(n - 1, _grid(n), 4, residue=False)
        assert without.levels == k7.TILE_LEVELS[4][2]
        assert k7.syncs_per_round(without) == steps - without.levels + 2
    for levels in range(plan.steps, k7.MAX_TILE_LEVELS + 1):
        assert k7.syncs_per_round(k7.tile_plan(n - 1, _grid(n), 4, levels)) == 2


def _class_edges(levels):
    """Rows at the residue stage's class edges for K = levels (P = 2^K
    classes): P j - 1, P j and P j + 1 (every class the same length, or
    one class a row longer, or all but one), P + 1 (classes of one row but
    the first), and lengths whose last classes are short."""
    p = 1 << levels
    long = {37 * p - 1, 37 * p + 3} if levels <= 8 else set()   # classes of 37, 38 rows
    return sorted({p + 1, p + 2, 2 * p - 1, 2 * p, 2 * p + 1, 3 * p - 1, 5 * p, 5 * p + 1,
                   5 * p + p // 2} | long)


@pytest.mark.parametrize("levels,group", [(1, 1), (2, 1), (3, 2), (5, 1), (5, 7), (8, 1),
                                          (8, 2), (8, 13), (8, 256), (11, 3)])
@pytest.mark.parametrize("tile", [TILE, 1000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residue_stage_is_the_plain_pcr_bitwise(dtype, tile, levels, group):
    """The residue stage (levels K..steps-1 class by class of the rows mod
    2^K, groups of classes a window, each level testing the class's ends)
    gives pcr_tridiag_solve's bits on both systems at every class edge,
    after tile stages of either tile length (no sum depends on it), a row a
    window lacks, one read before it was computed or one of another class
    showing as NaN."""
    checked = 0
    for m in _class_edges(levels):
        assert k7.pcr_steps(m) > levels
        for name, system in _systems(m, dtype, 3 * m + levels).items():
            got = ttv.pcr_tiled_solve(*system, levels, tile, group)
            want = ttv.pcr_tridiag_solve(*system)
            assert torch.isfinite(got).all(), (m, name)
            assert torch.equal(_bits(got), _bits(want)), (m, name)
            checked += 1
    assert checked == 2 * len(_class_edges(levels))


@pytest.mark.parametrize("group", [1, 5])
def test_residue_classes_are_independent(group):
    """A NaN in one row of level K's system reaches every row of that row's
    class mod 2^K and no row of another: the classes solve apart."""
    m, levels, row = 10_000, 8, 4_321
    held = [t.clone() for t in _systems(m, torch.float64, 11)["random"]]
    held[3][row] = float("nan")
    got = ttv._residue_solve(held, levels, k7.pcr_steps(m), group)
    same = torch.arange(m) % (1 << levels) == row % (1 << levels)
    assert torch.isnan(got[same]).all() and torch.isfinite(got[~same]).all()


@pytest.mark.parametrize("m,levels,tile,group", [
    (300, 8, TILE, 256), (99_999, 8, TILE, 2), (10_000, 7, 500, 7), (3000, 5, 37, 3),
    (3000, 5, 37, 1)])
def test_residue_stage_matches_jax(m, levels, tile, group):
    """The residue stage against the JAX package's pcr_tridiag_solve (f64),
    on both systems, within the plain solve's tolerance."""
    for name, system in _systems(m, torch.float64, 5 * m + levels).items():
        got = ttv.pcr_tiled_solve(*system, levels, tile, group).numpy()
        want = np.asarray(jtv.pcr_tridiag_solve(*(jnp.asarray(t.numpy()) for t in system)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _budget_rows(itemsize):
    return k7.SMEM_BUDGET // (4 * itemsize)


@pytest.mark.parametrize("n", [257, 258, 300, 1025, 10_000, 100_000, 1_000_000, 1_500_001,
                               1_769_473, 1_769_474, 2_000_000, 4_000_000])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_residue_rule(n, itemsize):
    """The rule takes the residue stage exactly where a class of ceil(m /
    2^K) rows fits the shared memory budget at the plan's K (in f32 to m =
    1,769,472 at K = 8 and past that at K = 9; in f64 at 10^6 at K = 9, as
    the classes of 7,813 rows of K = 7 and 3,907 of K = 8 do not fit); a
    group is the classes' share of the grid, cut to what a window holds,
    and the window holds it; the scratch arrays hold the classes."""
    m = n - 1
    g = _grid(n) if itemsize == 4 else min(132, -(-n // 512))
    plan = k7.tile_plan(m, g, itemsize)
    if plan.whole:
        assert not plan.residue and m <= 1 << plan.levels
        return
    p = 1 << plan.levels
    rows = -(-m // p)
    fits = rows <= _budget_rows(itemsize)
    assert plan.residue == fits
    if n == 1_000_000:
        assert (plan.levels, plan.residue) == ((8, True) if itemsize == 4 else (9, True))
    if itemsize == 4 and 1_769_472 < m <= 2_000_000:
        assert (plan.levels, plan.residue) == (9, True)
    if itemsize == 8 and n == 4_000_000:
        assert (plan.levels, plan.residue) == (7, False)
    if plan.residue:
        assert plan.group == min(-(-p // g), _budget_rows(itemsize) // rows)
        assert plan.group * rows <= plan.window
        assert plan.smem(itemsize) <= k7.SMEM_BUDGET
        assert plan.scratch_rows(m) >= p * rows and plan.scratch_rows(m) % 32 == 0
        assert k7.syncs_per_round(plan) == 4
        forced = k7.tile_plan(m, g, itemsize, residue=False)
        assert (forced.levels, forced.group) == (k7.TILE_LEVELS[itemsize][2], 0)
        assert k7.syncs_per_round(forced) == forced.steps - forced.levels + 2
    else:
        assert plan.group == 0 and plan.scratch_rows(m) == k7.padded(m)
        with pytest.raises(ValueError, match="class"):
            k7.tile_plan(m, g, itemsize, residue=True)
