"""Port ops/linop.py against the JAX package: device applies of every ported
operator (factor operators in all three solve modes) and the host algebra."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu import config as jconfig
from epsilon_tpu.ops import linop as jl
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ops import linop as tl
from epsilon_tpu_torch.ops.kernels import sym_packed as sp


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _solve_mode(monkeypatch, mode):
    """Select a factor-apply mode in both packages; "sym_packed" is the
    explicit inverse with the packed kernel forced on at n >= 64."""
    factor = "triangular" if mode == "triangular" else "inverse"
    monkeypatch.setattr(jconfig, "FACTOR_SOLVE_MODE", factor)
    monkeypatch.setattr(tconfig, "FACTOR_SOLVE_MODE", factor)
    monkeypatch.setenv("EPSILON_TPU_SYM_PACKED", "1" if mode == "sym_packed" else "0")
    monkeypatch.setattr(jconfig, "SYM_PACKED_MIN_DIM", 64)
    monkeypatch.setattr(tconfig, "SYM_PACKED_MIN_DIM", 64)


@pytest.mark.parametrize("mode", ["triangular", "inverse", "sym_packed"])
@pytest.mark.parametrize("kind", ["lu_symmetric", "cholesky"])
def test_factor_op_applies_match_jax(rng, monkeypatch, mode, kind):
    _check_factor_op(rng, monkeypatch, mode, kind, n=150)


@pytest.mark.parametrize("kind", ["lu_symmetric", "cholesky"])
def test_sym_packed_apply_without_padding_matches_jax(rng, monkeypatch, kind):
    # n a multiple of the tile: the apply passes x to the kernel unpadded
    _check_factor_op(rng, monkeypatch, "sym_packed", kind, n=2 * sp.SYM_TILE)


def _check_factor_op(rng, monkeypatch, mode, kind, n):
    _solve_mode(monkeypatch, mode)
    A = rng.randn(n, n)
    M = A @ A.T + n * np.eye(n)
    if kind == "lu_symmetric":
        jop, top = jl.LuFactorOp.symmetric(M), tl.LuFactorOp.symmetric(M)
    else:
        jop, top = jl.CholFactorOp(M), tl.CholFactorOp(M)
    x, X = rng.randn(n), rng.randn(n, 4)
    calls = []
    real = sp.sym_packed_matmul_reference
    monkeypatch.setattr(sp, "sym_packed_matmul_reference",
                        lambda *a: calls.append(1) or real(*a))
    for op_j, op_t in ((jop, top), (jop.T, top.T)):
        np.testing.assert_allclose(op_t.matvec(_t(x)).numpy(),
                                   np.asarray(op_j.matvec(jnp.asarray(x))),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(op_t.matmat(_t(X)).numpy(),
                                   np.asarray(op_j.matmat(jnp.asarray(X))),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(top.matvec(_t(x)).numpy(), np.linalg.solve(M, x),
                               rtol=1e-9, atol=1e-12)
    assert bool(calls) == (mode == "sym_packed")


def test_lu_factor_op_transposed_solve(rng, monkeypatch):
    _solve_mode(monkeypatch, "triangular")
    M = rng.randn(40, 40) + 40 * np.eye(40)
    top = tl.LuFactorOp(M)
    x = rng.randn(40)
    np.testing.assert_allclose(top.matvec(_t(x)).numpy(), np.linalg.solve(M, x), rtol=1e-10)
    np.testing.assert_allclose(top.T.matvec(_t(x)).numpy(), np.linalg.solve(M.T, x), rtol=1e-10)
    np.testing.assert_allclose(top.T.as_dense(), np.asarray(jl.LuFactorOp(M).T.as_dense()),
                               rtol=1e-12)


@pytest.mark.parametrize("make", [
    lambda rng, L: L.scalar(-2.5, 30),
    lambda rng, L: L.diagonal(rng.randn(30)),
    lambda rng, L: L.dense(rng.randn(20, 30)),
    lambda rng, L: L.dense(rng.randn(30, 20)).T,
])
def test_structured_applies_match_jax(make, rng):
    op_j = make(np.random.RandomState(3), jl)
    op_t = make(np.random.RandomState(3), tl)
    x, X = rng.randn(op_j.n), rng.randn(op_j.n, 3)
    np.testing.assert_allclose(op_t.matvec(_t(x)).numpy(),
                               np.asarray(op_j.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op_t.matmat(_t(X)).numpy(),
                               np.asarray(op_j.matmat(jnp.asarray(X))), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(op_t.as_dense(), op_j.as_dense())


def test_dense_transpose_shares_parent_tensor(rng):
    op = tl.dense(rng.randn(5, 7))
    assert op.T.T is op
    assert op.T._device_A().data_ptr() == op._device_A().data_ptr()


@pytest.mark.parametrize("case", ["scalar_dense", "diag_dense", "dense_dense",
                                  "dense_sparse", "sum_scalar_diag", "sum_dense"])
def test_host_algebra_matches_jax(case):
    def build(L):
        rng = np.random.RandomState(7)
        D = L.dense(rng.randn(12, 12))
        E = L.dense(rng.randn(12, 12))
        d = L.diagonal(rng.rand(12) + 1.0)
        s = L.scalar(3.0, 12)
        S = L.index_op(0, 12, 1, 12)
        return {"scalar_dense": lambda: s @ D, "diag_dense": lambda: d @ D,
                "dense_dense": lambda: D @ E, "dense_sparse": lambda: D @ S,
                "sum_scalar_diag": lambda: s + d, "sum_dense": lambda: D + s}[case]()
    got, want = build(tl), build(jl)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(got.as_dense(), want.as_dense(), rtol=1e-12)


def test_symmetric_inverse_is_symmetric_factor(rng):
    A = rng.randn(20, 20)
    inv = tl.dense(A @ A.T + np.eye(20)).inverse()
    assert isinstance(inv, tl.LuFactorOp) and inv._sym
    assert not tl.dense(A + 20 * np.eye(20)).inverse()._sym


def test_sparse_and_kron_applies_not_yet_ported():
    S = tl.index_op(0, 4, 1, 6)
    K = tl.KronOp(tl.dense(np.ones((2, 2))), tl.dense(np.ones((3, 3))))
    for op in (S, K):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            op.matvec(torch.zeros(op.n, dtype=torch.float64))
