"""CUDA-only tests of the port: the sym_packed (K2), local_update (K1) and
per-row loop (K3 lse_rows, K4 epi_sum_square, K5 epi_neg_log) kernels
against their plain PyTorch versions, K3 and K5 (whose loops stop when
their state repeats) against their full-count builds bitwise, the factor
apply, a small lasso, a small consensus lasso and the rows whose epigraphs
K3 and K4 carry on the card.  They skip
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


def _k1_inputs(cuda, dtype, S, n, offset=0):
    gen = torch.Generator(device=cuda).manual_seed(0)
    buf = torch.randn(S * n * n + offset, generator=gen, device=cuda, dtype=dtype)
    Finv = buf[offset:].view(S, n, n)
    Atb, u = (torch.randn(S, n, generator=gen, device=cuda, dtype=dtype) for _ in range(2))
    z = torch.randn(n, generator=gen, device=cuda, dtype=dtype)
    return Finv, Atb, u, z


def _k1_check(run, args, dtype):
    """``run(rho)`` against the plain version at two rho, one launch each,
    bitwise equal across two runs."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for rho in (1.0, 0.3):
        before = lu.launches
        x, xu = run(rho)
        assert lu.launches == before + 1
        x_ref, xu_ref = lu.local_update_reference(*args, rho)
        for got, ref in ((x, x_ref), (xu, xu_ref)):
            assert got.dtype == dtype and got.shape == ref.shape
            assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
        x2, xu2 = run(rho)
        torch.cuda.synchronize()
        assert torch.equal(x, x2) and torch.equal(xu, xu2)


@pytest.mark.parametrize("path", ["plan", "stream"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,offset,ring", [
    (8, 130, 0, False),     # f32 rows not 16-byte aligned: scalar loads
    (3, 131, 0, False),     # ragged in both types
    (5, 200, 0, False),     # the consensus row's n, too few items for the ring: vector loads
    (5, 200, 1, False),     # Finv pointer off 16-byte alignment: scalar loads
    (2, 4100, 0, True),     # long rows: the ring's smallest item; several rhs chunks when streamed
    (300, 200, 0, True),    # more items than persistent blocks, a last item of 8 rows
    (300, 200, 1, False),   # the same off alignment
    (64, 136, 0, False),    # fewer items than two to a block
])
def test_local_update_matches_reference(cuda, dtype, S, n, offset, ring, path):
    """The public call (whatever path the plan takes) and, through the
    private launcher, the streaming path at the same shape."""
    args = _k1_inputs(cuda, dtype, S, n, offset)
    plan = lu.plan_for(*args)
    assert plan.path == ("ring" if ring else "stream")
    if path == "plan":
        _k1_check(lambda rho: lu.fused_local_update(*args, rho), args, dtype)
        assert lu.last_plan == plan
    else:
        stream = lu.plan_for(*args, aligned=False)
        assert stream.path == "stream"
        _k1_check(lambda rho: lu._launch(stream, *args, rho), args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,rows,lanes,stages,grid", [
    (7, 8, 32, 8, 2, 7),        # n below the rows of an item (the public gate is n >= 128)
    (7, 8, 32, 8, 3, 2),        # the same, several items to a block
    (5, 200, 32, 8, 2, 3),      # a ring walked more than STAGES times; a last item of 8 rows
    (5, 200, 32, 8, 4, 35),     # one item to a block
    (9, 200, 16, 32, 3, 4),     # a warp to a row, two rows to a warp in turn
    (3, 1000, 4, 32, 2, 5),     # a warp to a row, s changes inside a block's run
    (40, 136, 64, 8, 2, 1),     # one block walks everything
])
def test_local_update_ring_plans(cuda, dtype, S, n, rows, lanes, stages, grid):
    """Ring plans the shape rule would not pick, through the private
    launcher."""
    args = _k1_inputs(cuda, dtype, S, n)
    plan = lu.ring_plan(S, n, args[0].element_size(), 132, rows, lanes, stages, 1)
    plan = plan._replace(grid=min(grid, plan.items))
    _k1_check(lambda rho: lu._launch(plan, *args, rho), args, dtype)
    assert lu.last_plan == plan


def test_local_update_rejects_bad_plans(cuda):
    args = _k1_inputs(cuda, torch.float32, 80, 200)
    good = lu.plan_for(*args)
    assert good.path == "ring"
    for bad in (good._replace(smem_bytes=good.smem_bytes + 16),    # not the layout's size
                good._replace(grid=good.items + 1),
                good._replace(grid=0),
                good._replace(stages=1),
                good._replace(lanes=16),
                good._replace(rhs_bufs=1),
                lu.ring_plan(80, 200, 4, 132, 200, 8, 2, 1),        # 320,000 bytes of slabs
                lu.plan_for(*args, aligned=False)._replace(grid=3)):
        with pytest.raises(RuntimeError):
            lu._launch(bad, *args, 1.0)
    off = _k1_inputs(cuda, torch.float32, 80, 200, offset=1)
    with pytest.raises(RuntimeError):                               # unaligned rows on the ring
        lu._launch(good, *off, 1.0)
    torch.cuda.synchronize()
    _k1_check(lambda rho: lu.fused_local_update(*args, rho), args, torch.float32)


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


def _small_lasso(rs, m=60, n=30):
    A = rs.randn(m, n) / np.sqrt(m)
    b = A @ (rs.randn(n) * (rs.rand(n) < 0.2)) + 0.01 * rs.randn(m)
    x = et.Variable(n)
    prob = et.Problem(et.Minimize(
        0.5 * et.sum_squares(et._wrap(A) * x - b) + 0.05 * et.norm1(x)))
    return A, b, x, prob


@pytest.mark.parametrize("params", [dict(adaptive_rho=True, rho=20.0),
                                    dict(over_relaxation=1.6),
                                    dict(solver="prox_admm", rho=4.0)])
def test_solver_modes_on_the_card_match_the_cpu(cuda, rs, params):
    """Each solver mode in f32 on the card against the port in f64 on the
    CPU: same status, solution within 1e-3."""
    _, _, x, prob = _small_lasso(rs)
    kw = dict(rel_tol=1e-4, abs_tol=1e-7, warm_start=True, **params)
    prob.solve(**kw)
    from epsilon_tpu_torch.frontend.solve import _PROBLEM_CACHE
    state = _PROBLEM_CACHE[prob][1]._warm_state
    assert state[0][next(iter(state[0].keys()))].device.type == "cuda"
    if params.get("adaptive_rho"):
        assert state[2].device.type == "cuda" and state[2].shape == ()
    got, status = x.value.copy(), prob.status
    config.set_device("cpu")
    _, _, x2, prob2 = _small_lasso(np.random.RandomState(0))
    prob2.solve(**kw)
    assert status == prob2.status == "optimal"
    np.testing.assert_allclose(got, x2.value, atol=1e-3)


def test_checkpoint_restores_onto_the_card(cuda, rs, tmp_path):
    from epsilon_tpu_torch.compiler import compiler
    from epsilon_tpu_torch.solvers import SolverParams, create_solver
    from epsilon_tpu_torch.utils import SolverCheckpointer
    _, _, _, prob = _small_lasso(rs)
    compiled = compiler.compile_problem(prob.expression_problem())
    kw = dict(rel_tol=1e-5, abs_tol=1e-8, rho=8.0)
    s1 = create_solver(compiled, SolverParams(max_iterations=20, **kw))
    s1.attach_checkpointer(SolverCheckpointer(str(tmp_path)))
    s1.solve()
    ck = SolverCheckpointer(str(tmp_path))
    restored, step = ck.restore(s1._init_state())
    assert step == 20 and all(v.device.type == "cuda" for v in restored[0].data.values())
    s2 = create_solver(compiled, SolverParams(**kw))
    s2.attach_checkpointer(ck)
    whole = create_solver(compiled, SolverParams(**kw))
    x2, xw = s2.solve(), whole.solve()
    assert s2.status.num_iterations == whole.status.num_iterations
    for k in xw.keys():
        assert float((x2[k] - xw[k]).abs().max()) <= 1e-5


def test_eval_prox_on_the_card(cuda, rs):
    v = rs.randn(1000)
    x = et.Variable(1000)
    et.eval_prox(et.norm1(x), {x: v}, lam=0.5)
    np.testing.assert_allclose(x.value.ravel(), np.sign(v) * np.maximum(np.abs(v) - 0.5, 0),
                               atol=1e-6)


# -- the per-row loop kernels (K3 lse_rows, K4 epi_sum_square, K5 epi_neg_log) --

def _row_inputs(kind, shape, seed, dtype, device):
    """``(v, p)``: v from a seed, p the per-row lam (log-uniform 1e-3..1e3)
    or s, about a third of the rows inactive, some bounds negative, row 0
    active; a quarter of K5's rows leave its domain."""
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(shape) * 2.0
    u = rng.uniform(-1.0, 1.0, shape[:-1])
    u.reshape(-1)[0] = -0.5
    if kind == "lse_prox":
        p = 10.0 ** (3.0 * u)
    elif kind == "lse_epi":
        m = v.max(axis=-1, keepdims=True)
        p = (m + np.log(np.exp(v - m).sum(axis=-1, keepdims=True)))[..., 0] + 3.0 * u - 1.0
    elif kind == "sum_square":
        p = (v * v).sum(axis=-1) * (1.25 * u + 0.25)
    else:
        v = np.abs(v) + 0.05
        v[rng.rand(*shape[:-1]) < 0.25, 0] *= -1.0
        p = -np.log(np.abs(v)).sum(axis=-1) + 3.0 * u - 1.0
    return (torch.as_tensor(v, dtype=dtype, device=device),
            torch.as_tensor(p, dtype=dtype, device=device))


def _row_kernels():
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, epi_sum_square, lse_rows
    from epsilon_tpu_torch.ops.prox import elementwise, newton_epi, registry, vector
    return {
        "lse_prox": (lse_rows, "prox_launches", vector.prox_log_sum_exp,
                     vector.prox_log_sum_exp_reference),
        "lse_epi": (lse_rows, "epi_launches", newton_epi.epi_log_sum_exp,
                    newton_epi.epi_log_sum_exp_reference),
        "sum_square": (epi_sum_square, "launches", registry._epi_sum_square,
                       registry._epi_sum_square_reference),
        "neg_log": (epi_neg_log, "launches", elementwise.epi_sum_neg_log,
                    elementwise.epi_sum_neg_log_reference),
    }


# Relative to max(1, max |plain result|): the kernels sum a row in another
# order than torch.sum, and their loops converge, so kernel and plain
# version differ by rounding times the conditioning of the root.
ROW_KERNEL_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,shape", [
    ("lse_prox", (10000, 10)), ("lse_prox", (64, 1)), ("lse_prox", (64, 31)),
    ("lse_prox", (64, 33)), ("lse_prox", (3, 8, 257)),
    ("lse_epi", (100, 20)), ("lse_epi", (16, 1)), ("lse_epi", (16, 31)),
    ("lse_epi", (16, 33)), ("lse_epi", (2, 4, 257)),
    ("sum_square", (200,)), ("sum_square", (8, 1)), ("sum_square", (8, 31)),
    ("sum_square", (8, 33)), ("sum_square", (2, 4, 257)),
    ("neg_log", (10,)), ("neg_log", (8, 1)), ("neg_log", (8, 31)),
    ("neg_log", (8, 33)), ("neg_log", (2, 4, 257)),
])
def test_row_kernel_matches_plain_version(cuda, kind, shape, dtype):
    """Each per-row loop kernel through its dispatch (one launch) against
    its plain version on the same CUDA tensors; bitwise repeatable."""
    module, counter, dispatch, plain = _row_kernels()[kind]
    v, p = _row_inputs(kind, shape, seed=sum(shape), dtype=dtype, device=cuda)
    if len(shape) == 1:
        p = p.reshape(())
    before = getattr(module, counter)
    got = dispatch(v, p)
    assert getattr(module, counter) == before + 1
    again, want = dispatch(v, p), plain(v, p)
    got, again, want = [o if isinstance(o, tuple) else (o,) for o in (got, again, want)]
    scale = max(1.0, max(w.abs().max().item() for w in want))
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape and a.dtype == w.dtype and a.device == w.device
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= ROW_KERNEL_RTOL[dtype] * scale


def test_row_kernel_scalar_forms(cuda):
    """lam as a host number, a 0-d CUDA tensor and a per-row tensor give
    the same rows as the plain version; a bound on another device raises."""
    from epsilon_tpu_torch.ops.kernels import lse_rows
    from epsilon_tpu_torch.ops.prox import vector
    v, lam = _row_inputs("lse_prox", (32, 12), 3, torch.float64, cuda)
    for p in (0.7, torch.tensor(0.7, dtype=torch.float64, device=cuda), lam,
              lam.to(torch.float32)):
        got = vector.prox_log_sum_exp(v, p)
        want = vector.prox_log_sum_exp_reference(v, p if not isinstance(p, torch.Tensor)
                                                 else p.to(v.dtype))
        assert (got - want).abs().max().item() <= 1e-10 * max(1.0, want.abs().max().item())
    with pytest.raises(ValueError):
        lse_rows.epi_rows(v, torch.zeros(32, dtype=torch.float64))


@pytest.mark.parametrize("row,kwargs", [
    ("max_softmax", dict(m=6, k=3, n=4)),       # the LOG_SUM_EXP epigraph per row
    ("oneclass_svm", dict(m=30, n=5)),          # the SUM_SQUARE epigraph
])
def test_loop_kernel_rows_on_card_match_cpu_port(cuda, monkeypatch, row, kwargs):
    """A row whose epigraph is a per-row loop kernel, at the small size of
    the CPU library tests, through Problem.solve on the card in f64 (the
    kernel launched) against the port on the CPU in f64: objective within
    1e-6 relative and the same iteration count, or one epoch of 50 apart
    (the kernels sum in another order, which can move the stopping test
    across an epoch's boundary)."""
    from epsilon_tpu_torch.ops.kernels import epi_sum_square, lse_rows
    from epsilon_tpu_torch.problems import benchmark
    monkeypatch.setattr(config, "default_dtype", lambda: torch.float64)
    monkeypatch.setattr(config, "default_np_dtype", lambda: np.dtype(np.float64))
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == row)
    inst = benchmark.ProblemInstance(row, inst.create, kwargs)
    before = lse_rows.epi_launches + epi_sum_square.launches
    prob = inst.create_problem()
    obj_gpu = prob.solve(rel_tol=1e-3)
    iters_gpu = prob.solver_status.num_iterations
    assert prob.status == "optimal"
    assert lse_rows.epi_launches + epi_sum_square.launches >= before + iters_gpu
    config.set_device("cpu")
    prob_cpu = inst.create_problem()
    obj_cpu = prob_cpu.solve(rel_tol=1e-3)
    assert prob_cpu.status == "optimal"
    assert abs(iters_gpu - prob_cpu.solver_status.num_iterations) <= 50
    np.testing.assert_allclose(obj_gpu, obj_cpu, rtol=1e-6)


# -- the exit: K3 and K5 against their full-count builds, bitwise ------------

def _exit_entries():
    """kind -> (the kernel entry, its full-count build, the C entry's name)."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, lse_rows
    return {"lse_prox": (lse_rows.prox_rows, lse_rows.prox_rows_full, "lse_prox_rows"),
            "lse_epi": (lse_rows.epi_rows, lse_rows.epi_rows_full, "lse_epi_rows"),
            "neg_log": (epi_neg_log.epi_rows, epi_neg_log.epi_rows_full, "epi_neg_log_rows")}


def _same_bits(a, b):
    ints = {4: torch.int32, 8: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])))


def _exit_check(kind, v, p):
    """The kernel, with and without its step counts, against its
    full-count build: bitwise equal outputs, counts within their loops'
    counts (``chip_smoke.steps_out_of_counts``)."""
    from chip_smoke import steps_out_of_counts
    entry, full_entry, name = _exit_entries()[kind]
    steps = torch.zeros(tuple(v.shape[:-1]) + (4,), dtype=torch.int32, device=v.device)
    full_steps = torch.zeros_like(steps)
    got = entry(v, p, steps=steps)
    plain_got = entry(v, p)
    want = full_entry(v, p, steps=full_steps)
    got, plain_got, want = [o if isinstance(o, tuple) else (o,) for o in (got, plain_got, want)]
    for a, b, c in zip(got, plain_got, want):
        assert _same_bits(a, c) and _same_bits(b, c)
    assert not steps_out_of_counts(name, steps.cpu().numpy(), full_steps.cpu().numpy(),
                                   v.shape[-1]).any()
    return steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,shape", [
    ("lse_prox", (10000, 10)), ("lse_prox", (64, 1)), ("lse_prox", (64, 31)),
    ("lse_prox", (64, 33)), ("lse_prox", (3, 8, 257)),
    ("lse_epi", (100, 20)), ("lse_epi", (16, 1)), ("lse_epi", (16, 31)),
    ("lse_epi", (16, 33)), ("lse_epi", (2, 4, 257)),
    ("neg_log", (10,)), ("neg_log", (8, 1)), ("neg_log", (8, 31)),
    ("neg_log", (8, 33)), ("neg_log", (2, 4, 257)),
])
def test_row_kernel_exit_matches_full_count(cuda, kind, shape, dtype):
    """K3 (a), K3 (b) and K5, whose loops stop when their state repeats,
    give their full-count builds' results bitwise, and count their steps
    within the loops' counts."""
    v, p = _row_inputs(kind, shape, seed=sum(shape), dtype=dtype, device=cuda)
    if len(shape) == 1:
        p = p.reshape(())
    steps = _exit_check(kind, v, p).reshape(-1, 4).long()
    active = steps[:, 1] > 0 if kind != "neg_log" else steps[:, 0] > 0
    if kind != "lse_prox":
        assert (steps[active, 0] < 24).any()     # the lam loop exits early somewhere
    if kind != "neg_log":
        # so do Lambert solves: fewer than 30 steps a solve on some chain
        proxes, per_lane = steps[:, 0] + 1, -(-v.shape[-1] // 32)
        assert steps[:, 2].sum() < 30 * per_lane * (steps[:, 1] + 2 * proxes)[active].sum()


def _band_inputs(kind, rows, n, seed, dtype, device):
    """LOG_SUM_EXP rows whose Lambert arguments at the solution lie in
    [-2.1, -0.5], where a solve can settle into a 3-cycle (see
    chip_smoke.band_inputs)."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(0.11, 0.40, (rows, n))
    lam = q.sum(axis=1)
    if kind == "lse_prox":
        v, p = q + np.log(q) + 1.0 - np.log(lam)[:, None], lam
    else:
        x = np.log(q / lam[:, None]) + rng.uniform(-2.0, 2.0, (rows, 1))
        m = x.max(axis=1)
        v, p = x + q, m + np.log(np.exp(x - m[:, None]).sum(axis=1)) - lam
    return (torch.as_tensor(v, dtype=dtype, device=device),
            torch.as_tensor(p, dtype=dtype, device=device))


def _special_inputs(kind, rows, n, seed, dtype, device):
    """Rows holding a NaN, +inf, -inf, 0, -0 and a negative value, and
    rows whose bound is NaN, +inf, -inf or 0."""
    v, p = (a.numpy() for a in _row_inputs(kind, (rows, n), seed, torch.float64, "cpu"))
    values = (np.nan, np.inf, -np.inf, 0.0, -0.0, -1.5)
    for r, value in enumerate(values):
        v[r, r % n] = value
    for r, value in enumerate((np.nan, np.inf, -np.inf, 0.0)):
        p[len(values) + r] = value
    return (torch.as_tensor(v, dtype=dtype, device=device),
            torch.as_tensor(p, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [10, 20, 33, 257])
@pytest.mark.parametrize("kind,inputs", [("lse_prox", "band"), ("lse_epi", "band"),
                                         ("lse_prox", "special"), ("lse_epi", "special"),
                                         ("neg_log", "special")])
def test_row_kernel_exit_on_hard_rows(cuda, kind, inputs, n, dtype):
    """The same on the 3-cycle band of the Lambert solve and on rows with
    non-finite and non-positive values and bounds."""
    make = _band_inputs if inputs == "band" else _special_inputs
    v, p = make(kind, 16, n, n, dtype, cuda)
    _exit_check(kind, v, p)


class _Names:
    """A kernel library that records the entries looked up on it."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        self.names.append(name)
        return getattr(self.lib, name)


def test_dispatch_never_reaches_a_full_count_entry(cuda, monkeypatch):
    """The prox modules' dispatch launches the kernels that exit, never a
    full-count build."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, lse_rows
    from epsilon_tpu_torch.ops.prox import elementwise, newton_epi, vector
    libs = {mod: _Names(mod._library()) for mod in (lse_rows, epi_neg_log)}
    for mod, names in libs.items():
        monkeypatch.setattr(mod, "_LIB", names)
    for dtype in (torch.float32, torch.float64):
        v, lam = _row_inputs("lse_prox", (16, 12), 1, dtype, cuda)
        vector.prox_log_sum_exp(v, lam)
        v, s = _row_inputs("lse_epi", (16, 12), 2, dtype, cuda)
        newton_epi.epi_log_sum_exp(v, s)
        v, s = _row_inputs("neg_log", (8, 10), 3, dtype, cuda)
        elementwise.epi_sum_neg_log(v, s)
    names = [n for names in libs.values() for n in names.names]
    assert len(names) == 6 and not any("full" in n for n in names)
