"""Port kernel K1 (fused_local_update): the port's wrapper on CPU tensors
(its plain PyTorch version) against the JAX package's
``local_update_reference`` and its Pallas kernel in interpret mode, the
n >= 128 gate and the wrapper's checks.  The CUDA kernel itself is tested in
test_torch_cuda.py.

Tolerances, relative to the largest reference value: 1e-12 in f64 and 1e-5
in f32 (the sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ops import pallas_kernels as pk
from epsilon_tpu_torch.ops.kernels import local_update as lu

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _inputs(rng, S, n, dtype):
    A = rng.randn(S, 2 * n, n)
    Finv = np.linalg.inv(np.einsum("smi,smj->sij", A, A) + np.eye(n))
    return tuple(a.astype(dtype) for a in
                 (Finv, rng.randn(S, n), rng.randn(S, n), rng.randn(n)))


def _close(got, want, dtype):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("rho", [0.7, 2.5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("S,n", [(4, 16), (1, 8), (3, 130)])
def test_matches_jax(rng, S, n, dtype, rho):
    args = _inputs(rng, S, n, dtype)
    x, xu = lu.fused_local_update(*map(torch.as_tensor, args), rho)
    x, xu = x.numpy(), xu.numpy()
    x_ref, xu_ref = pk.local_update_reference(*map(jnp.asarray, args), rho)
    _close(x, x_ref, dtype)
    _close(xu, xu_ref, dtype)
    if dtype == np.float32:
        # the Pallas kernel takes f32 only: its f32 dot cannot be stored into
        # an f64 output
        x_k, xu_k = pk.fused_local_update(*map(jnp.asarray, args), rho, interpret=True)
        _close(x, x_k, dtype)
        _close(xu, xu_k, dtype)


@pytest.mark.parametrize("n", [127, 128])
def test_gate_matches_pallas_supported(n):
    assert lu.local_update_supported(4, n) == pk.pallas_supported(4, n)


def _good(S=3, n=5, dtype=torch.float32):
    return dict(Finv=torch.zeros(S, n, n, dtype=dtype), Atb=torch.zeros(S, n, dtype=dtype),
                u=torch.zeros(S, n, dtype=dtype), z=torch.zeros(n, dtype=dtype))


@pytest.mark.parametrize("bad", [
    dict(z=torch.zeros(5, dtype=torch.float64)),                        # dtype mix
    dict(Finv=torch.zeros(3, 5, 5, dtype=torch.float16),
         Atb=torch.zeros(3, 5, dtype=torch.float16),
         u=torch.zeros(3, 5, dtype=torch.float16),
         z=torch.zeros(5, dtype=torch.float16)),                         # half
    dict(Finv=torch.zeros(3, 5, 4)),                                     # not square
    dict(Atb=torch.zeros(3, 6)),                                         # shape
    dict(z=torch.zeros(4)),                                              # shape
    dict(u=torch.zeros(5, 3).T),                                         # not contiguous
    dict(Finv=torch.zeros(0, 5, 5), Atb=torch.zeros(0, 5),
         u=torch.zeros(0, 5)),                                           # no blocks
])
def test_cuda_argument_checks(bad):
    args = _good()
    lu._check_cuda_args(**args)          # the well-formed call passes
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        lu._check_cuda_args(**args)


def test_unsupported_device_raises():
    args = {k: v.to("meta") for k, v in _good().items()}
    with pytest.raises(ValueError):
        lu.fused_local_update(args["Finv"], args["Atb"], args["u"], args["z"], 1.0)


# -- the launch plan (pure Python: no card is asked) ---------------------------

SM_COUNT = 132
PLAN_SHAPES = [(200, 200), (40, 5000), (8, 130), (300, 130), (3, 131), (2, 4100), (1, 1),
               (5, 8), (5000, 8), (300, 16), (4, 1000), (2, 2048), (3, 6000), (1, 20000)]


def _ring_eligible(n, itemsize, aligned):
    return aligned and (n * itemsize) % 16 == 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("S,n", PLAN_SHAPES)
def test_plan_covers_every_row_once_and_fits(S, n, itemsize, aligned):
    plan = lu.local_update_plan(S, n, itemsize, aligned, SM_COUNT)
    assert plan.path in ("ring", "stream")
    items = lu.plan_items(plan, S, n)
    assert len(items) == plan.items
    assert 1 <= plan.grid <= plan.items
    covered = np.zeros((S, n), dtype=int)
    for s, row0, rows in items:
        assert 1 <= rows <= plan.rows
        covered[s, row0:row0 + rows] += 1
    assert (covered == 1).all()
    if not _ring_eligible(n, itemsize, aligned):
        assert plan.path == "stream"
    if plan.path == "stream":
        assert plan.grid == plan.items and plan.smem_bytes == 0
        return
    # the ring: every slab, right-hand side and barrier at a multiple of 16
    # bytes, every copy a multiple of 16 bytes, all within one block's limit
    assert plan.stages >= 2 and plan.lanes in (8, 32) and plan.rows <= n
    slabs, rhs, bars, total = lu.ring_layout(n, itemsize, plan.rows, plan.stages, plan.rhs_bufs)
    assert total == plan.smem_bytes <= lu.BLOCK_SMEM_LIMIT == 232448
    assert all(off % 16 == 0 for off in slabs + rhs + [bars])
    assert all((rows * n * itemsize) % 16 == 0 for _, _, rows in items)
    assert len(slabs) == plan.stages and len(rhs) == plan.rhs_bufs
    assert slabs[1] - slabs[0] == plan.rows * n * itemsize
    assert rhs[0] == plan.stages * plan.rows * n * itemsize and bars >= rhs[-1] + n * itemsize
    # a right-hand side buffer comes round again only after the items that
    # read it have left the ring
    tiles = -(-n // plan.rows)
    assert (plan.rhs_bufs - 1) * tiles >= plan.stages - 1
    # the blocks the grid asks for fit on the card at once
    per_sm = -(-plan.grid // SM_COUNT)
    assert per_sm * (plan.smem_bytes + lu.BLOCK_RESERVED_SMEM) <= lu.SM_SMEM_BYTES


@pytest.mark.parametrize("S,n,itemsize,path", [
    (200, 200, 4, "ring"), (200, 200, 8, "ring"), (40, 5000, 4, "ring"),
    (300, 136, 4, "ring"), (2, 4100, 4, "ring"), (2, 4100, 8, "ring"),
    (8, 130, 4, "stream"),      # 520-byte rows
    (300, 130, 4, "stream"),
    (300, 130, 8, "ring"),
    (8, 130, 8, "stream"),      # 40 items: fewer than two to a block
    (75, 200, 4, "stream"),     # 525 items against 2 x 264 blocks
    (76, 200, 4, "ring"),       # 532
    (3, 131, 4, "stream"), (3, 131, 8, "stream"), (300, 131, 8, "stream"),
    (1, 1, 4, "stream"),
    (5, 8, 4, "stream"),
    (3, 6000, 4, "stream"),     # two slabs of four rows do not fit
    (40, 5000, 8, "stream"),
])
def test_plan_path_by_shape(S, n, itemsize, path):
    assert lu.local_update_plan(S, n, itemsize, True, SM_COUNT).path == path
    assert lu.local_update_plan(S, n, itemsize, False, SM_COUNT).path == "stream"


@pytest.mark.parametrize("S,n,itemsize", [(5000, 8, 4), (700, 16, 8), (1, 20000, 4)])
def test_plan_small_and_long_rows(S, n, itemsize):
    """n below the rows of an item gives items of n rows; a row too long
    for the ring streams whatever the block count."""
    plan = lu.local_update_plan(S, n, itemsize, True, SM_COUNT)
    if n == 20000:
        assert plan.path == "stream"
        assert lu.local_update_plan(10 ** 5, n, itemsize, True, SM_COUNT).path == "stream"
    else:
        assert plan.path == "ring" and plan.rows == n and plan.items == S


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [8, 200, 1000, 5000])
def test_ring_sum_order_depends_on_n_and_type_alone(n, itemsize):
    """rows and lanes fix the order of the ring's sums: they must not move
    with the block count or the card."""
    plans = [lu.local_update_plan(S, n, itemsize, True, sms)
             for S in (1, 7, 200, 10 ** 5) for sms in (1, 108, 132)]
    rings = {(p.rows, p.lanes) for p in plans if p.path == "ring"}
    assert len(rings) == (0 if n == 5000 and itemsize == 8 else 1)


@pytest.mark.parametrize("S,n,sm_count", [(200, 200, 132), (2, 200, 1), (40, 5000, 4)])
def test_ring_blocks_split_the_items_evenly(S, n, sm_count):
    """The persistent grid's static split: block b takes a contiguous run;
    the runs tile the items and differ by at most one."""
    plan = lu.local_update_plan(S, n, 4, True, sm_count)
    assert plan.path == "ring"
    base, extra = divmod(plan.items, plan.grid)
    runs = [(b * base + min(b, extra), base + (b < extra)) for b in range(plan.grid)]
    assert runs[0][0] == 0 and sum(c for _, c in runs) == plan.items
    assert all(runs[b][0] + runs[b][1] == runs[b + 1][0] for b in range(plan.grid - 1))
    assert min(c for _, c in runs) >= 1 and max(c for _, c in runs) - min(c for _, c in runs) <= 1
