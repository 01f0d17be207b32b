"""CUDA-only tests of the port: the sym_packed (K2) and local_update (K1)
kernels against their plain PyTorch versions, the factor apply, a small
lasso and a small consensus lasso on the card.  They skip
without a CUDA device.  This file imports neither JAX nor the JAX package,
so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import epsilon_tpu_torch as et
from epsilon_tpu_torch import config
from epsilon_tpu_torch.ops import linop
from epsilon_tpu_torch.ops.kernels import local_update as lu
from epsilon_tpu_torch.ops.kernels import sym_packed as sp
from epsilon_tpu_torch.parallel import consensus_lasso_solver
from epsilon_tpu_torch.ops.prox import operator as prox_operator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config.set_device("cuda")
    yield torch.device("cuda")
    config.set_device("cpu")


@pytest.fixture
def rs():
    return np.random.RandomState(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [1, 3, 9, 300])
def test_kernel_matches_reference(cuda, rs, dtype, R):
    n = 700                                    # pads to 768: a ragged last block
    A = rs.randn(n, n)
    tiles, ii, jj, n_pad = sp.pack_sym_tiles(A + A.T)
    t = torch.as_tensor(tiles, dtype=dtype, device=cuda)
    i = torch.as_tensor(ii, device=cuda)
    j = torch.as_tensor(jj, device=cuda)
    X = rs.randn(n_pad, R)
    X[n:] = 0.0
    x = torch.as_tensor(X, dtype=dtype, device=cuda)
    plan = tuple(torch.as_tensor(a, device=cuda)
                 for a in sp.sym_packed_plan(ii, jj, n_pad // sp.SYM_TILE))
    before = sp.launches
    y = sp.sym_packed_matmul(t, i, j, x, plan)
    assert sp.launches == before + 1
    ref = sp.sym_packed_matmul_reference(t, i, j, x)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(y, sp.sym_packed_matmul(t, i, j, x, plan))
    assert torch.all(y[n:] == 0)


def test_kernel_rejects_mixed_devices(cuda):
    T = sp.SYM_TILE
    tiles = torch.zeros(1, T, T, device=cuda)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    plan = (torch.tensor([0, 1], dtype=torch.int32, device=cuda), idx)
    with pytest.raises(ValueError):
        sp.sym_packed_matmul(tiles.cpu(), idx, idx, torch.zeros(T, 1, device=cuda), plan)
    with pytest.raises(TypeError):
        sp.sym_packed_matmul(tiles, idx, idx,
                             torch.zeros(T, 1, dtype=torch.float64, device=cuda), plan)


def test_cuda_defaults(cuda):
    assert config.default_dtype() == torch.float32
    assert config.use_explicit_inverse()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("n", [300, 2 * sp.SYM_TILE])   # padded, and not
def test_symmetric_factor_applies_through_kernel(cuda, rs, monkeypatch, n):
    monkeypatch.setattr(config, "SYM_PACKED_MIN_DIM", 64)
    A = rs.randn(n, n)
    M = A @ A.T + n * np.eye(n)
    op = linop.LuFactorOp.symmetric(M)
    X = rs.randn(n, 4)
    before = sp.launches
    got_v = op.matvec(linop.to_tensor(X[:, 0])).cpu().numpy()
    got_m = op.matmat(linop.to_tensor(X)).cpu().numpy()
    assert sp.launches == before + 2
    np.testing.assert_allclose(got_v, np.linalg.solve(M, X[:, 0]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got_m, np.linalg.solve(M, X), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("path", ["default", "sym_packed"])
def test_lasso_on_card_matches_cpu_port(cuda, rs, monkeypatch, path):
    if path == "sym_packed":
        monkeypatch.setattr(config, "SYM_PACKED_MIN_DIM", 64)
        monkeypatch.setattr(prox_operator, "_COLLAPSE_MAX_ENTRIES", 0.0)
    m, n = 300, 150
    A = rs.randn(m, n) / np.sqrt(m)
    b = A @ (rs.randn(n) * (rs.rand(n) < 0.1)) + 0.01 * rs.randn(m)
    lam = 0.1 * np.abs(A.T @ b).max()

    def solve():
        x = et.Variable(n)
        prob = et.Problem(et.Minimize(
            0.5 * et.sum_squares(et._wrap(A) * x - b) + lam * et.norm1(x)))
        obj = prob.solve(rel_tol=1e-3, abs_tol=1e-6)
        return obj, np.asarray(x.value), prob

    before = sp.launches
    obj_gpu, x_gpu, prob = solve()
    launches = sp.launches - before
    assert prob.status == "optimal"
    if path == "sym_packed":
        assert launches >= prob.solver_status.num_iterations
    config.set_device("cpu")
    obj_cpu, x_cpu, _ = solve()
    np.testing.assert_allclose(obj_gpu, obj_cpu, rtol=1e-4)
    np.testing.assert_allclose(x_gpu, x_cpu, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,offset", [
    (8, 130, 0),      # f32 rows not 16-byte aligned: scalar loads
    (3, 131, 0),      # ragged in both types
    (5, 200, 0),      # the consensus row's n: vector loads
    (5, 200, 1),      # Finv pointer off 16-byte alignment: scalar loads
    (2, 4100, 0),     # several shared-memory chunks and a ragged tail
])
def test_local_update_matches_reference(cuda, dtype, S, n, offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    buf = torch.randn(S * n * n + offset, generator=gen, device=cuda, dtype=dtype)
    Finv = buf[offset:].view(S, n, n)
    Atb, u = (torch.randn(S, n, generator=gen, device=cuda, dtype=dtype) for _ in range(2))
    z = torch.randn(n, generator=gen, device=cuda, dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for rho in (1.0, 0.3):
        before = lu.launches
        x, xu = lu.fused_local_update(Finv, Atb, u, z, rho)
        assert lu.launches == before + 1
        x_ref, xu_ref = lu.local_update_reference(Finv, Atb, u, z, rho)
        for got, ref in ((x, x_ref), (xu, xu_ref)):
            assert got.dtype == dtype and got.shape == ref.shape
            assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
        x2, xu2 = lu.fused_local_update(Finv, Atb, u, z, rho)
        assert torch.equal(x, x2) and torch.equal(xu, xu2)


def test_local_update_rejects_bad_arguments(cuda):
    S, n = 2, 130
    Finv = torch.zeros(S, n, n, device=cuda)
    v = torch.zeros(S, n, device=cuda)
    z = torch.zeros(n, device=cuda)
    with pytest.raises(TypeError):
        lu.fused_local_update(Finv, v, v, z.double(), 1.0)
    with pytest.raises(TypeError):
        lu.fused_local_update(Finv.half(), v.half(), v.half(), z.half(), 1.0)
    with pytest.raises(ValueError):
        lu.fused_local_update(Finv, v, v, z.cpu(), 1.0)
    with pytest.raises(ValueError):
        lu.fused_local_update(Finv, torch.zeros(n, S, device=cuda).T, v, z, 1.0)


def test_consensus_lasso_on_card_through_kernel(cuda):
    S, m, n = 4, 200, 130
    rng = np.random.RandomState(0)
    A = (rng.randn(S, m, n) / np.sqrt(m)).astype(np.float32)
    x0 = rng.randn(n) * (rng.rand(n) < 0.2)
    b = (np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)).astype(np.float32)
    lam = 0.1 * float(np.abs(np.einsum("smn,sm->n", A, b)).max())
    kw = dict(rel_tol=1e-4, abs_tol=1e-7, max_iterations=2000)
    before = lu.launches
    res = consensus_lasso_solver(A, b, lam, **kw).solve()
    assert res.converged
    assert res.z.device.type == "cuda" and res.z.dtype == torch.float32
    assert lu.launches - before == res.iterations
    config.set_device("cpu")
    ref = consensus_lasso_solver(A, b, lam, **kw).solve()
    np.testing.assert_allclose(res.z.cpu().numpy(), ref.z.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("row,kwargs,rtol", [
    # an elementwise kernel (SUM_LOGISTIC prox, Newton with a fixed count)
    ("logreg_l1", dict(m=200, n=100, rho=0.2), 1e-4),
    # a matrix kernel (NEG_LOG_DET prox through torch.linalg.eigh)
    ("covsel", dict(m=40, n=30, lam=0.1), 1e-4),
    # TV-1D PDAS with its warm state threaded through the loop
    ("tv_1d", dict(n=2000), 1e-3),
])
def test_library_row_on_card_matches_cpu_port(cuda, row, kwargs, rtol):
    """A library row through Problem.solve on the card (f32) against the
    port on the CPU (f64).  The port in f32 on the CPU was 3.6e-8
    (logreg_l1), 1.0e-6 (covsel) and 3.2e-4 (tv_1d, whose f32 PDAS certifies
    at 3e-4) from its f64 objective at these sizes."""
    from epsilon_tpu_torch.problems import benchmark
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == row)
    inst = benchmark.ProblemInstance(row, inst.create, kwargs)
    prob = inst.create_problem()
    obj_gpu = prob.solve(rel_tol=1e-3)
    assert prob.status == "optimal"
    assert np.isfinite(obj_gpu)
    config.set_device("cpu")
    obj_cpu = inst.create_problem().solve(rel_tol=1e-3)
    np.testing.assert_allclose(obj_gpu, obj_cpu, rtol=rtol)
