"""Port kernel K2 (sym_packed_matmul): the plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, the reduction plan and the
wrapper's checks.  The CUDA kernel itself is tested in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu.ops import pallas_kernels as pk
from epsilon_tpu_torch.ops.kernels import sym_packed as sp


def _packed(rng, n, tile, dtype, R=3):
    A = rng.randn(n, n)
    M = (A + A.T).astype(dtype)
    tiles, ii, jj, n_pad = pk.pack_sym_tiles(M, tile=tile)
    X = rng.randn(n_pad, R).astype(dtype)
    X[n:] = 0.0
    return M, tiles, ii, jj, n_pad, X


@pytest.mark.parametrize("R", [1, 2, 3, 8, 10, 20, 64, 80])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_matches_jax_kernel(rng, dtype, R):
    """The plain version against the Pallas kernel in interpret mode, at x's
    widths on each of the CUDA kernel's paths: one column, and several (a
    chunk of 2, 4 and 8, 64 in chunks, and the widths the library sends:
    mnist's 10 classes, qp's collapsed KKT's 20 and the lasso's 80)."""
    n, tile = 700, 256
    M, tiles, ii, jj, n_pad, X = _packed(rng, n, tile, dtype, R)
    want = np.asarray(pk.sym_packed_matmul(
        jnp.asarray(tiles), jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(X),
        interpret=True))
    plan = tuple(map(torch.as_tensor, sp.sym_packed_plan(ii, jj, n_pad // tile)))
    got = sp.sym_packed_matmul(torch.as_tensor(tiles), torch.as_tensor(ii),
                               torch.as_tensor(jj), torch.as_tensor(X), plan).numpy()
    assert got.dtype == dtype and got.shape == (n_pad, R)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    else:
        # the sums run in another order than the Pallas kernel's
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got[:n], M @ X[:n], rtol=1e-4 if dtype == np.float32 else 1e-9,
                               atol=1e-4 * np.abs(want).max())
    # padded tail rows stay zero
    np.testing.assert_array_equal(got[n:], 0.0)


def test_port_packer_matches_jax_packer(rng):
    M = rng.randn(300, 300)
    M = M + M.T
    for a, b in zip(sp.pack_sym_tiles(M, tile=128), pk.pack_sym_tiles(M, tile=128)):
        np.testing.assert_array_equal(a, b)


def test_plan_lists_every_contribution_once():
    _, ii, jj, n_pad = sp.pack_sym_tiles(np.eye(700), tile=128)
    B = n_pad // 128
    row_ptr, entries = sp.sym_packed_plan(ii, jj, B)
    assert row_ptr.dtype == np.int32 and entries.dtype == np.int32
    assert row_ptr[0] == 0 and row_ptr[-1] == entries.size
    want = {(int(i), 2 * k) for k, i in enumerate(ii)}
    want |= {(int(j), 2 * k + 1) for k, (i, j) in enumerate(zip(ii, jj)) if i != j}
    got = {(b, int(e)) for b in range(B) for e in entries[row_ptr[b]:row_ptr[b + 1]]}
    assert got == want and len(want) == entries.size
    # each row block sums B contributions, in increasing slot order
    assert np.all(np.diff(row_ptr) == B)
    for b in range(B):
        assert np.all(np.diff(entries[row_ptr[b]:row_ptr[b + 1]]) > 0)


@pytest.mark.parametrize("ii,jj,B", [([0, 1], [0, 2], 3), ([0, 3], [0, 0], 3),
                                     ([0, -1], [0, 0], 3)])
def test_plan_rejects_bad_coordinates(ii, jj, B):
    with pytest.raises(ValueError):
        sp.sym_packed_plan(np.asarray(ii), np.asarray(jj), B)


def _cuda_args(dtype=torch.float32, K=3, T=sp.SYM_TILE, n_pad=2 * sp.SYM_TILE, R=2):
    return dict(tiles=torch.zeros(K, T, T, dtype=dtype),
                ii=torch.tensor([0, 1, 1], dtype=torch.int32)[:K],
                jj=torch.tensor([0, 0, 1], dtype=torch.int32)[:K],
                x=torch.zeros(n_pad, R, dtype=dtype),
                row_ptr=torch.zeros(n_pad // T + 1, dtype=torch.int32),
                entries=torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(2 * sp.SYM_TILE, 2, dtype=torch.float64)),        # dtype mix
    dict(tiles=torch.zeros(3, 64, 64)),                                    # wrong tile
    dict(ii=torch.tensor([0, 1, 1], dtype=torch.int64)),                   # index dtype
    dict(x=torch.zeros(2 * sp.SYM_TILE + 1, 2)),                           # ragged rows
    dict(x=torch.zeros(2, 2 * sp.SYM_TILE).T),                             # not contiguous
    dict(row_ptr=torch.zeros(5, dtype=torch.int32)),                       # plan shape
    dict(tiles=torch.zeros(3, sp.SYM_TILE, sp.SYM_TILE, dtype=torch.float16),
         x=torch.zeros(2 * sp.SYM_TILE, 2, dtype=torch.float16)),          # half
])
def test_cuda_argument_checks(bad):
    args = _cuda_args()
    sp._check_cuda_args(**args)          # the well-formed call passes
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        sp._check_cuda_args(**args)


def test_unsupported_device_raises():
    t = torch.zeros(1, sp.SYM_TILE, sp.SYM_TILE, device="meta")
    i = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sp.sym_packed_matmul(t, i, i, torch.zeros(sp.SYM_TILE, 1, device="meta"),
                             (torch.zeros(2, dtype=torch.int32, device="meta"), i))
