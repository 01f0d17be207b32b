"""The premises of the TV-1D kernel's tile build (``csrc/tv1d_pdas.cu``),
on the CPU: its schedule of the PCR solve, emulated in plain PyTorch by
``tv1d.pcr_tiled_solve`` (tiles of T rows with a halo of 2^K - 1 rows run
levels 0..K-1 in a window, then the levels left run over the whole row),
gives ``pcr_tridiag_solve``'s bits; the rule that picks K and T
(``tv1d_pdas.tile_plan``) keeps K within the solve's steps and the window
within the shared memory budget; and the grid syncs a round are as the
design counts them.

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
    assert plan.levels == min(k7.TILE_LEVELS[itemsize], plan.steps)
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
    (100_000, 17, 11, 20), (10_000, 14, 8, 17), (1_000_000, 20, 14, 23), (257, 8, 2, 11),
    (2, 1, 2, 4)])
def test_syncs_a_round(n, steps, tile_syncs, levels_syncs):
    """Grid syncs a round: steps - K + 2 for the tile build (2 when the
    whole solve runs in shared memory), steps + 3 for the levels build;
    2 more a call.  At the main path's K = 8: 11 against 20 at n =
    100,000 and 8 against 17 at n = 10,000."""
    plan = k7.tile_plan(n - 1, _grid(n), 4)
    assert plan.steps == steps
    assert k7.syncs_per_round(plan) == tile_syncs
    assert k7.levels_syncs_per_round(steps) == levels_syncs
    assert k7.grid_syncs(7, tile_syncs) == 2 + 7 * tile_syncs
    if plan.whole:
        assert tile_syncs == 2
    for levels in range(plan.steps, k7.MAX_TILE_LEVELS + 1):
        assert k7.syncs_per_round(k7.tile_plan(n - 1, _grid(n), 4, levels)) == 2
