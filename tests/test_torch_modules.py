"""Port modules against the JAX package on identical inputs: BlockCholesky,
the KKT prox operators (collapsed and factored), the NORM_1 vector prox and
its elementwise kernel, and the interop conversions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu import ir as jir
from epsilon_tpu.ops import block as jb
from epsilon_tpu.ops import cholesky as jc
from epsilon_tpu.ops import linop as jl
from epsilon_tpu.ops.prox import elementwise as jew
from epsilon_tpu.ops.prox import operator as jop
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch import ir as tir
from epsilon_tpu_torch.ops import block as tb
from epsilon_tpu_torch.ops import cholesky as tc
from epsilon_tpu_torch.ops import linop as tl
from epsilon_tpu_torch.ops.prox import elementwise as tew
from epsilon_tpu_torch.ops.prox import operator as top


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _jbv(d):
    return jb.BlockVector({k: jnp.asarray(v) for k, v in d.items()})


def _tbv(d):
    return tb.BlockVector({k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                           for k, v in d.items()})


def _assert_bv_close(got, want, rtol=1e-10, atol=1e-12):
    assert set(got.keys()) == set(want.keys())
    for k in want.keys():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)


def _kkt(L, rng_seed=0):
    """A quasi-definite 3-key KKT: dense H over x, -I slack, scalar metric."""
    rng = np.random.RandomState(rng_seed)
    H = rng.randn(9, 6)
    BM = (jb if L is jl else tb).BlockMatrix
    return BM({("h", "x"): L.dense(H), ("x", "h"): L.dense(H.T),
               ("x", "x"): L.scalar(2.0, 6), ("h", "h"): L.scalar(-1.0, 9),
               ("y", "x"): L.scalar(1.0, 6), ("x", "y"): L.scalar(1.0, 6),
               ("y", "y"): L.scalar(-1.0, 6)})


def test_block_cholesky_solve_matches_jax(rng):
    b = {"h": rng.randn(9), "x": rng.randn(6), "y": rng.randn(6)}
    want = jc.BlockCholesky(_kkt(jl)).factor().solve(_jbv(b))
    chol = tc.BlockCholesky(_kkt(tl)).factor()
    got = chol.solve(_tbv(b))
    _assert_bv_close(got, want)
    np.testing.assert_allclose(
        np.concatenate([got[k].numpy() for k in sorted(b)]),
        np.linalg.solve(_kkt(tl).as_dense(), np.concatenate([b[k] for k in sorted(b)])),
        rtol=1e-9, atol=1e-12)
    # solving for a subset of keys gives those blocks unchanged
    part = chol.solve(_tbv(b), keys=["x"])
    assert "x" in part
    np.testing.assert_array_equal(part["x"].numpy(), got["x"].numpy())


def test_block_cholesky_solve_mat_matches_jax(rng):
    B = {"h": rng.randn(9, 4), "x": rng.randn(6, 4)}
    want = jc.BlockCholesky(_kkt(jl)).factor().solve_mat(
        {k: jnp.asarray(v) for k, v in B.items()})
    got = tc.BlockCholesky(_kkt(tl)).factor().solve_mat(
        {k: torch.as_tensor(v) for k, v in B.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-10, atol=1e-12)


def _sum_square_setup(L, ir, BM, BV, m, n, rng):
    H = rng.randn(m, n)
    g = rng.randn(m)
    spec = ir.ProxFunctionSpec(kind=ir.ProxKind.SUM_SQUARE, alpha=0.5)
    arg = ir.AffineOperator(BM({(ir.arg_key(0), "x"): L.dense(H)}),
                            BV({ir.arg_key(0): g}))
    con = ir.AffineOperator(BM({("x", "x"): L.scalar(1.5, n)}), BV())
    return spec, arg, con


@pytest.mark.parametrize("collapse", [True, False])
def test_sum_square_prox_matches_jax(monkeypatch, collapse):
    if not collapse:
        monkeypatch.setattr(jop, "_COLLAPSE_MAX_ENTRIES", 0.0)
        monkeypatch.setattr(top, "_COLLAPSE_MAX_ENTRIES", 0.0)
    m, n = 30, 12
    jargs = _sum_square_setup(jl, jir, jb.BlockMatrix, jb.BlockVector, m, n,
                              np.random.RandomState(5))
    targs = _sum_square_setup(tl, tir, tb.BlockMatrix, tb.BlockVector, m, n,
                              np.random.RandomState(5))
    jp, tp = jop.create_prox_operator(*jargs), top.create_prox_operator(*targs)
    assert type(tp).__name__ == "SumSquareProxOperator"
    assert (tp._collapsed is not None) == (jp._collapsed is not None) == collapse
    v = {"x": np.random.RandomState(6).randn(n)}
    _assert_bv_close(tp.apply(_tbv(v)), jp.apply(_jbv(v)))


def test_zero_prox_matches_jax():
    rng = np.random.RandomState(8)
    n = 7
    d = rng.randn(n)

    def build(L, ir, BM, BV):
        H = BM({("c", "a"): L.scalar(1.0, n), ("c", "b"): L.scalar(-1.0, n)})
        A = BM({("a", "a"): L.scalar(2.0, n), ("b", "b"): L.scalar(1.0, n)})
        spec = ir.ProxFunctionSpec(kind=ir.ProxKind.ZERO)
        return spec, ir.AffineOperator(H, BV({"c": d})), ir.AffineOperator(A, BV())

    jp = jop.create_prox_operator(*build(jl, jir, jb.BlockMatrix, jb.BlockVector))
    tp = top.create_prox_operator(*build(tl, tir, tb.BlockMatrix, tb.BlockVector))
    assert type(tp).__name__ == "ZeroProxOperator"
    v = {"a": rng.randn(n), "b": rng.randn(n)}
    got = tp.apply(_tbv(v))
    _assert_bv_close(got, jp.apply(_jbv(v)))
    # the projection lands on a - b + d = 0
    np.testing.assert_allclose(got["a"].numpy() - got["b"].numpy() + d, 0.0, atol=1e-12)


@pytest.mark.parametrize("metric", ["scalar", "diagonal"])
def test_norm1_vector_prox_matches_jax(metric):
    rng = np.random.RandomState(9)
    n = 11
    w = rng.rand(n) + 0.5

    def build(L, ir, BM, BV):
        spec = ir.ProxFunctionSpec(kind=ir.ProxKind.NORM_1, alpha=0.7)
        arg = ir.AffineOperator(BM({(ir.arg_key(0), "x"): L.scalar(2.0, n)}),
                                BV({ir.arg_key(0): np.linspace(-1, 1, n)}))
        A = L.scalar(1.3, n) if metric == "scalar" else L.diagonal(w)
        return spec, arg, ir.AffineOperator(BM({("x", "x"): A}), BV())

    jp = jop.create_prox_operator(*build(jl, jir, jb.BlockMatrix, jb.BlockVector))
    tp = top.create_prox_operator(*build(tl, tir, tb.BlockMatrix, tb.BlockVector))
    assert tp.elementwise == jp.elementwise == (metric == "diagonal")
    v = {"x": 3 * rng.randn(n)}
    _assert_bv_close(tp.apply(_tbv(v)), jp.apply(_jbv(v)))


def test_scaled_zone_kernels_match_jax(rng):
    v = 2 * rng.randn(50)
    lam = rng.rand(50)
    for args in [(0.3,), (lam,), (lam, 1.0, 0.5, 0.1, 0.2)]:
        targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        np.testing.assert_allclose(
            tew.prox_scaled_zone(torch.as_tensor(v), *targs).numpy(),
            np.asarray(jew.prox_scaled_zone(jnp.asarray(v), *args)), rtol=1e-15, atol=0)
    np.testing.assert_allclose(float(tew.eval_scaled_zone(torch.as_tensor(v), 1.0, 0.5, 0.1, 0.2)),
                               float(jew.eval_scaled_zone(jnp.asarray(v), 1.0, 0.5, 0.1, 0.2)),
                               rtol=1e-14)
    np.testing.assert_array_equal(tew.prox_norm1(torch.as_tensor(v), 0.4).numpy(),
                                  np.asarray(jew.prox_norm1(jnp.asarray(v), 0.4)))


def test_unported_kernels_raise():
    spec = tir.ProxFunctionSpec(kind=tir.ProxKind.NORM_2)
    arg = tir.AffineOperator(tb.BlockMatrix({(tir.arg_key(0), "x"): tl.scalar(1.0, 3)}),
                             tb.BlockVector())
    con = tir.AffineOperator(tb.BlockMatrix({("x", "x"): tl.scalar(1.0, 3)}), tb.BlockVector())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        top.create_prox_operator(spec, arg, con)


def test_to_device_is_cached_and_refreshed():
    bv = tb.BlockVector({"a": np.arange(3.0)})
    first = bv.to_device()
    assert first is bv.to_device()
    assert isinstance(first["a"], torch.Tensor) and first["a"].dtype == torch.float64
    bv["a"] = np.ones(3)
    np.testing.assert_array_equal(bv.to_device()["a"].numpy(), np.ones(3))


def test_linop_from_numpy_keeps_structure(rng):
    D = rng.randn(4, 3)
    cases = [(jl.scalar(2.0, 3), tl.ScalarOp), (jl.diagonal(rng.rand(3)), tl.DiagonalOp),
             (jl.dense(D), tl.DenseOp), (jl.index_op(0, 3, 1, 5), tl.SparseOp),
             (jl.LuFactorOp.symmetric(np.eye(3) * 2), tl.DenseOp)]
    for op, cls in cases:
        got = interop.linop_from_numpy(op)
        assert isinstance(got, cls)
        np.testing.assert_array_equal(got.as_dense(), np.asarray(op.as_dense()))


def test_state_from_numpy():
    z, u = interop.state_from_numpy({"a": np.arange(3.0)}, {"a": -np.arange(3.0)})
    assert z["a"].dtype == torch.float64 and z["a"].device.type == "cpu"
    np.testing.assert_array_equal((z + u)["a"].numpy(), 0.0)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tconfig.set_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconfig.default_dtype()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.dense(np.eye(2))
    finally:
        tconfig.set_device("cpu")
