"""CUDA-only tests of the port: the sym_packed (K2), local_update (K1) and
per-row loop (K3 lse_rows, K4 epi_sum_square, K5 epi_neg_log) kernels
against their plain PyTorch versions, K3-K5 (whose loops stop when their
state repeats) against their full-count builds bitwise, K3's half-warp
prox against the same kernel one row a warp bitwise, the factor
apply, a small lasso, a small consensus lasso and the rows whose epigraphs
K3 and K4 carry on the card; K6 (the SUM_LOGISTIC prox), K8 (the EXP
epigraph), K9 (the SUM_KL_DIV prox), K10 (SUM_INV_POS) and K11 (SUM_EXP and
SUM_NEG_ENTR) against their full-count builds bitwise and their plain
versions, the KL epigraph on the card, K7 (the TV-1D PDAS in one
cooperative launch) against the plain PDAS and the exact oracle and, at
every tile depth, against the levels build it replaced bitwise, its PCR
solve against the plain one bitwise, each launching one kernel and no host
sync, and the rows they carry.  They skip
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
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 8, 9, 10, 14, 16, 20, 64, 80, 300])
def test_kernel_matches_reference(cuda, rs, dtype, R):
    """K2 at one column and on the multi-column path (every chunk width,
    a last chunk of 4 or 2 after wider ones, an odd R's column of zeros,
    many chunks, the library's widths 10, 20 and 80) against its plain
    version, bitwise repeatable, counted once a call under its width."""
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
    before, before_r = sp.launches, sp.launches_by_width.get(R, 0)
    y = sp.sym_packed_matmul(t, i, j, x, plan)
    assert sp.launches == before + 1 and sp.launches_by_width[R] == before_r + 1
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


# -- the exit: K3-K5 against their full-count builds, bitwise ----------------

def _exit_entries():
    """kind -> (the kernel entry, its full-count build, the C entry's name)."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, epi_sum_square, lse_rows
    return {"lse_prox": (lse_rows.prox_rows, lse_rows.prox_rows_full, "lse_prox_rows"),
            "lse_epi": (lse_rows.epi_rows, lse_rows.epi_rows_full, "lse_epi_rows"),
            "sum_square": (epi_sum_square.epi_rows, epi_sum_square.epi_rows_full,
                           "epi_sum_square_rows"),
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
    ("sum_square", (200,)), ("sum_square", (64, 200)), ("sum_square", (8, 1)),
    ("sum_square", (64, 1)), ("sum_square", (8, 31)), ("sum_square", (64, 31)),
    ("sum_square", (8, 33)), ("sum_square", (64, 33)), ("sum_square", (2, 4, 257)),
    ("sum_square", (64, 257)),
    ("neg_log", (10,)), ("neg_log", (8, 1)), ("neg_log", (8, 31)),
    ("neg_log", (8, 33)), ("neg_log", (2, 4, 257)),
])
def test_row_kernel_exit_matches_full_count(cuda, kind, shape, dtype):
    """K3 (a), K3 (b), K4 and K5, whose loops stop when their state
    repeats, give their full-count builds' results bitwise, and count their
    steps within the loops' counts."""
    v, p = _row_inputs(kind, shape, seed=sum(shape), dtype=dtype, device=cuda)
    if len(shape) == 1:
        p = p.reshape(())
    steps = _exit_check(kind, v, p).reshape(-1, 4).long()
    active = steps[:, 1] > 0 if kind != "neg_log" else steps[:, 0] > 0
    if kind == "sum_square":
        # the widening's start already brackets the root: it repeats at step 1
        assert active.any() and (steps[active, 1] == 1).all()
        if steps.shape[0] >= 64:
            assert (steps[active, 0] < 25).any()     # the Newton exits early somewhere
    elif kind != "lse_prox":
        assert (steps[active, 0] < 24).any()     # the lam loop exits early somewhere
    if kind.startswith("lse"):
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
                                         ("sum_square", "special"), ("neg_log", "special")])
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
    full-count build nor the prox one row a warp."""
    from epsilon_tpu_torch.ops.kernels import epi_neg_log, epi_sum_square, lse_rows
    from epsilon_tpu_torch.ops.prox import elementwise, newton_epi, registry, vector
    libs = {mod: _Names(mod._library()) for mod in (lse_rows, epi_neg_log, epi_sum_square)}
    for mod, names in libs.items():
        monkeypatch.setattr(mod, "_LIB", names)
    for dtype in (torch.float32, torch.float64):
        v, lam = _row_inputs("lse_prox", (16, 12), 1, dtype, cuda)
        vector.prox_log_sum_exp(v, lam)
        v, s = _row_inputs("lse_epi", (16, 12), 2, dtype, cuda)
        newton_epi.epi_log_sum_exp(v, s)
        v, s = _row_inputs("neg_log", (8, 10), 3, dtype, cuda)
        elementwise.epi_sum_neg_log(v, s)
        v, s = _row_inputs("sum_square", (8, 200), 4, dtype, cuda)
        registry._epi_sum_square(v, s)
    names = [n for names in libs.values() for n in names.names]
    assert len(names) == 8 and not any("full" in n or "wide" in n for n in names)


# -- K3's prox two rows a warp against one row a warp, bitwise ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inputs,shape", [
    ("seeded", (63, 1)), ("seeded", (63, 7)), ("seeded", (63, 8)), ("seeded", (63, 9)),
    ("seeded", (63, 10)), ("seeded", (63, 15)), ("seeded", (63, 16)),
    ("seeded", (10000, 10)), ("seeded", (1, 10)), ("seeded", (3, 5, 16)),
    ("band", (63, 10)), ("special", (63, 10)), ("special", (64, 16)),
])
def test_half_warp_prox_matches_one_row_a_warp(cuda, inputs, shape, dtype):
    """K3's prox takes rows of up to 16 two to a warp; its results and step
    counts equal, bitwise, those of the same kernel one row a warp
    (``prox_rows_wide``) and of its full-count build, on odd row counts
    (the last half-warp idle) too.  The layouts' butterflies differ only
    in adding identities, which a partial sum begun at +0 never turns into
    another zero's sign."""
    from epsilon_tpu_torch.ops.kernels import lse_rows
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    if inputs == "seeded":
        v, lam = _row_inputs("lse_prox", shape, sum(shape), dtype, cuda)
    else:
        make = _band_inputs if inputs == "band" else _special_inputs
        v, lam = make("lse_prox", rows, n, n, dtype, cuda)
    steps = _exit_check("lse_prox", v, lam)
    wide_steps = torch.zeros_like(steps)
    wide = lse_rows.prox_rows_wide(v, lam, steps=wide_steps)
    assert _same_bits(lse_rows.prox_rows(v, lam), wide)
    assert torch.equal(steps, wide_steps)


def test_half_warp_prox_occupancy(cuda):
    """The occupancy calculator answers for both layouts at mnist's width,
    and rows of 17 take one row a warp in both."""
    from epsilon_tpu_torch.ops.kernels import lse_rows
    for dtype in (torch.float32, torch.float64):
        half, wide = (lse_rows.resident_warps(dtype, 10, w) for w in (False, True))
        assert 0 < half and 0 < wide
        assert lse_rows.resident_warps(dtype, 17) == lse_rows.resident_warps(dtype, 17, True)


def test_launch_floor_runs(cuda):
    """The empty kernel that phase 7a times as the launch floor launches
    and leaves the per-row kernels' launch counters alone."""
    from chip_smoke import launch_floor, row_kernels
    counters = [(k["module"], k["counter"]) for k in row_kernels().values()]
    before = [getattr(mod, counter) for mod, counter in counters]
    launch_floor(torch.empty(1, device=cuda))
    torch.cuda.synchronize()
    assert [getattr(mod, counter) for mod, counter in counters] == before


# -- K6: the SUM_LOGISTIC prox, one thread an element ------------------------

def _logistic_inputs(n, seed, dtype, device, lam_kind):
    """v uniform over +-60; lam log-uniform over 1e-6..1e6 as a number, a
    0-d CUDA tensor or one value an element."""
    rng = np.random.RandomState(seed)
    v = torch.as_tensor(rng.uniform(-60.0, 60.0, n), dtype=dtype, device=device)
    lam = 10.0 ** rng.uniform(-6.0, 6.0, n)
    if lam_kind == "number":
        return v, float(lam[0])
    if lam_kind == "0-d":
        return v, torch.tensor(lam[0], dtype=dtype, device=device)
    return v, torch.as_tensor(lam, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam_kind", ["number", "0-d", "element"])
@pytest.mark.parametrize("n", [1, 255, 257, 1500, 100_000])
def test_sum_logistic_kernel_matches_full_count_and_plain(cuda, n, lam_kind, dtype):
    """K6 through its dispatch (one launch) equals its full-count build
    bitwise (the exit returns the full count's state) and a second run; its
    steps lie in 1..40; and it equals the plain version on the same CUDA
    tensors bitwise (the same operations in the same order, the card's
    exp as torch's)."""
    from epsilon_tpu_torch.ops.kernels import sum_logistic
    from epsilon_tpu_torch.ops.prox import elementwise
    v, lam = _logistic_inputs(n, n, dtype, cuda, lam_kind)
    before = sum_logistic.launches
    x = elementwise.prox_sum_logistic(v, lam)
    assert sum_logistic.launches == before + 1
    steps = torch.zeros(n, dtype=torch.int32, device=cuda)
    full_steps = torch.zeros_like(steps)
    assert _same_bits(x, sum_logistic.prox(v, lam, steps=steps))
    assert _same_bits(x, sum_logistic.prox_full(v, lam, steps=full_steps))
    assert bool(((steps >= 1) & (steps <= sum_logistic.STEPS)).all())
    assert bool((full_steps == sum_logistic.STEPS).all())
    want = elementwise.prox_sum_logistic_reference(v, lam)
    assert torch.isfinite(x).all() and _same_bits(x, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sum_logistic_kernel_exit_on_special_values(cuda, dtype):
    """Every pair of v in {NaN, +-inf, 0, -0, +-1e30, +-1e-30, 1, -7.5} and
    lam in {NaN, inf, 0, -0, -1, 1e-30, 1, 1e30}: the exit's result equals
    the full-count build's bits, and the plain version's values (NaN in the
    same places; ``chip_smoke.same_values``)."""
    from chip_smoke import same_values
    from epsilon_tpu_torch.ops.kernels import sum_logistic
    from epsilon_tpu_torch.ops.prox import elementwise
    vs = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30, 1e-30, -1e-30, 1.0, -7.5]
    lams = [np.nan, np.inf, 0.0, -0.0, -1.0, 1e-30, 1.0, 1e30]
    v, lam = (torch.as_tensor(a.ravel(), dtype=dtype, device=cuda)
              for a in np.meshgrid(np.array(vs), np.array(lams), indexing="ij"))
    x = sum_logistic.prox(v, lam)
    assert _same_bits(x, sum_logistic.prox_full(v, lam))
    assert same_values(x, elementwise.prox_sum_logistic_reference(v, lam))


def test_sum_logistic_kernel_broadcasts_lam(cuda):
    """lam broadcasting against a batch of v (a row of lam, a column) and a
    one-element CPU tensor give the plain version's shape and values; lam on
    another card's device or of another shape raises."""
    from epsilon_tpu_torch.ops.kernels import sum_logistic
    from epsilon_tpu_torch.ops.prox import elementwise
    rng = np.random.RandomState(5)
    v = torch.as_tensor(rng.uniform(-5, 5, (3, 40)), dtype=torch.float64, device=cuda)
    for lam in (torch.as_tensor(rng.uniform(0.1, 3, 40), dtype=torch.float64, device=cuda),
                torch.as_tensor(rng.uniform(0.1, 3, (3, 1)), dtype=torch.float64, device=cuda),
                torch.tensor([0.7], dtype=torch.float64), 2.0):
        got = elementwise.prox_sum_logistic(v, lam)
        want = elementwise.prox_sum_logistic_reference(
            v, lam.to(cuda) if isinstance(lam, torch.Tensor) else lam)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-10 * max(1.0, want.abs().max().item())
    with pytest.raises(ValueError):
        sum_logistic.prox(v, torch.ones(7, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        sum_logistic.prox(v, torch.ones(40, dtype=torch.float64))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1500, 4224, 4225, 100_000])
def test_one_thread_an_element_launches_spread_over_the_sms(cuda, n):
    """K6's and K8's blocks: 32 x ceil(n / (32 x SMs)) threads, at least 32
    and at most 256 (``row_loops.cuh`` element_threads): logreg_l1's 1,500
    elements take one-warp blocks."""
    from epsilon_tpu_torch.ops.kernels import sum_logistic
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = min(256, max(32, 32 * -(-n // (32 * sms))))
    assert sum_logistic.threads(n) == want
    if n == 1500 and sms >= 47:
        assert want == 32


# -- K8: the EXP epigraph, one thread an element -----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s_kind", ["element", "number", "0-d"])
@pytest.mark.parametrize("n", [1, 255, 257, 2000, 20_000, 100_000])
def test_epi_exp_kernel_matches_full_count_and_plain(cuda, n, s_kind, dtype):
    """K8 through its dispatch (one launch) equals its full-count build and
    the plain version bitwise, x and t, with its widening steps in 1..40
    and its Newton steps in 4..25 (``chip_smoke.k8_check``), on chip_smoke's
    phase 7a inputs (active and inactive elements, s <= 0); at max_softmax's
    2,000 elements it passes the f64 numpy test of the projection."""
    from chip_smoke import K8_KKT_RTOL, k8_check, k8_inputs, k8_kkt
    from epsilon_tpu_torch.ops.kernels import epi_exp
    from epsilon_tpu_torch.ops.prox import elementwise
    v, s = k8_inputs(n, dtype, n, cuda, "number" if s_kind == "0-d" else s_kind)
    if s_kind == "0-d":
        s = torch.tensor(s, dtype=dtype, device=cuda)
    before = epi_exp.launches
    x, t = elementwise.epi_exp(v, s)
    assert epi_exp.launches == before + 1
    (x2, t2), _ = k8_check(epi_exp, elementwise.epi_exp_reference, v, s, f"{n} {s_kind}")
    assert _same_bits(x, x2) and _same_bits(t, t2)
    if n == 2000:
        assert k8_kkt(v, s, x, t) <= K8_KKT_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epi_exp_kernel_on_special_values(cuda, dtype):
    """Every pair of v and s in {NaN, +-inf, 0, -0, +-1e30, 1, -1, 50}: the
    full-count build's bits, the plain version's values (NaN in the same
    places)."""
    from chip_smoke import k8_check, k8_special
    from epsilon_tpu_torch.ops.kernels import epi_exp
    from epsilon_tpu_torch.ops.prox import elementwise
    v, s = k8_special(dtype, cuda)
    k8_check(epi_exp, elementwise.epi_exp_reference, v, s, "special", special=True)


def test_epi_exp_kernel_broadcasts_s(cuda):
    """A stacked row's (rows, d) with s of the same shape, s broadcast along
    the rows, a one-element CPU tensor and a number give the plain
    version's shapes and bits; s on the CPU of another shape, or of a shape
    that does not broadcast, raises."""
    from epsilon_tpu_torch.ops.kernels import epi_exp
    from epsilon_tpu_torch.ops.prox import elementwise
    rng = np.random.RandomState(5)
    v = torch.as_tensor(rng.uniform(-5, 5, (3, 40)), dtype=torch.float64, device=cuda)
    for s in (torch.as_tensor(rng.uniform(-5, 50, (3, 40)), dtype=torch.float64, device=cuda),
              torch.as_tensor(rng.uniform(-5, 50, 40), dtype=torch.float64, device=cuda),
              torch.tensor([0.7], dtype=torch.float64), 2.0):
        got = elementwise.epi_exp(v, s)
        want = elementwise.epi_exp_reference(
            v, s.to(cuda) if isinstance(s, torch.Tensor) else s)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        epi_exp.epi(v, torch.ones(7, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        epi_exp.epi(v, torch.ones(40, dtype=torch.float64))


def test_k8_dispatch_never_reaches_the_full_count_entry(cuda, monkeypatch):
    """The EXP epigraph's dispatch launches the kernel that exits, never its
    full-count build."""
    from chip_smoke import k8_inputs
    from epsilon_tpu_torch.ops.kernels import epi_exp
    from epsilon_tpu_torch.ops.prox import elementwise
    names = _Names(epi_exp._library())
    monkeypatch.setattr(epi_exp, "_LIB", names)
    for dtype in (torch.float32, torch.float64):
        elementwise.epi_exp(*k8_inputs(64, dtype, 1, cuda))
    assert names.names == ["epi_exp_f32", "epi_exp_f64"]


def test_k8_max_softmax_without_epigraph_on_card_matches_cpu_port(cuda, monkeypatch):
    """max_softmax under ``use_epigraph=False`` (its conic form holds EXP
    epigraphs) at the CPU library tests' size (``torch_library_rows.SMALL``),
    on the card in f64 with K8 launched, against the port on the CPU in
    f64: iterations within one epoch of 50 and the objective within 1e-6
    relative, as the K6 and K7 rows are held (the rest of the loop sums in
    the card's order)."""
    from epsilon_tpu_torch.ops.kernels import epi_exp
    from epsilon_tpu_torch.problems import benchmark
    monkeypatch.setattr(config, "default_dtype", lambda: torch.float64)
    monkeypatch.setattr(config, "default_np_dtype", lambda: np.dtype(np.float64))
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == "max_softmax")
    inst = benchmark.ProblemInstance("max_softmax", inst.create, dict(m=6, k=3, n=4))
    before = epi_exp.launches
    prob = inst.create_problem()
    obj_gpu = prob.solve(use_epigraph=False, rel_tol=1e-3, max_iterations=400)
    iters_gpu = prob.solver_status.num_iterations
    assert epi_exp.launches >= before + iters_gpu
    config.set_device("cpu")
    prob_cpu = inst.create_problem()
    obj_cpu = prob_cpu.solve(use_epigraph=False, rel_tol=1e-3, max_iterations=400)
    assert prob_cpu.status == prob.status
    assert abs(iters_gpu - prob_cpu.solver_status.num_iterations) <= 50
    np.testing.assert_allclose(obj_gpu, obj_cpu, rtol=1e-6)


# -- K7: the TV-1D PDAS in one cooperative launch ----------------------------

# K7 against the plain PDAS on the card, max |x - x_ref| / max(1, max |v|)
# (z relative to max(1, lam)): the two differ only in the order of their
# sums.  Against the exact oracle, the same at the default tolerance; at an
# inner tolerance plus the PDAS certificate of the returned dual (||x - x*||
# <= sqrt(2 gap), the gap of z evaluated in f64): at a loose inner
# tolerance the PDAS stops that far from x*.  At the default PDAS tolerance the f32 gap test
# reads rounding noise (and below 3e-4 the f32 gap floors above its
# threshold, so the stop then rests on the full step's change of J, a sum
# at the rounding scale), so the rounds may differ by one there; at the
# inner tolerances the solver sets (config.prox_inner_tol_for: at least
# 3e-4 in f32, 1e-7 in f64) they are the same.
K7_RTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
K7_INNER_TOLS = {torch.float32: [1e-3, 3e-4], torch.float64: [1e-4, 1e-6]}


def _tv_signal(n, seed):
    rng = np.random.RandomState(seed)
    return np.cumsum((rng.rand(n) < 0.05) * 3 * rng.randn(n)) + 0.3 * rng.randn(n)


def _pdas_check(v, lam, tol, z0, slack):
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    before = tv1d_pdas.launches
    x, gap, it, z = tv1d.prox_tv1d_pdas(v, lam, tol=tol, z0=z0, return_dual=True)
    assert tv1d_pdas.launches == before + 1
    assert it.shape == () and it.dtype == torch.int32 and it.device == v.device
    assert gap.shape == () and gap.dtype == v.dtype
    x2, gap2, it2, z2 = tv1d.prox_tv1d_pdas(v, lam, tol=tol, z0=z0, return_dual=True)
    assert _same_bits(x, x2) and _same_bits(z, z2) and _same_bits(gap, gap2) and it == it2
    xr, _, itr, zr = tv1d.prox_tv1d_pdas_reference(v, lam, tol=tol, z0=z0, return_dual=True)
    assert abs(int(it) - itr) <= slack
    scale = max(1.0, v.abs().max().item())
    rtol = K7_RTOL[v.dtype]
    assert torch.isfinite(x).all()
    assert (x - xr).abs().max().item() <= rtol * scale
    assert (z - zr).abs().max().item() <= rtol * max(1.0, abs(float(lam)))
    exact = tv1d.tv1d_exact_numpy(v.double().cpu().numpy(), float(lam))
    _, gap64 = tv1d.tv1d_gap(v.double().cpu(), float(lam), z.double().cpu())
    reach = rtol * scale + (0.0 if tol is None else np.sqrt(2.0 * max(float(gap64), 0.0)))
    assert np.abs(x.double().cpu().numpy() - exact).max() <= reach
    return z


# Rows of K7's PCR at the tile build's edges at its main-path tile (T = 511
# rows, K = 8 levels, halo H = 255): T - 1, T, T + 1, T + H, 2^K +- 1, and a
# row past the whole-row window (2^K); the lengths n = m + 1 of the PDAS.
K7_TILE_ROWS = (255, 256, 257, 510, 511, 512, 766, 4097, 10_000)


def _pcr_systems(m, dtype, dev):
    rng = np.random.RandomState(m)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    free = rng.rand(m) < 0.7
    a = t(np.where(free, -1.0, 0.0))
    return ((t(-rng.rand(m)), t(2.5 + rng.rand(m)), t(-rng.rand(m)), t(rng.randn(m))),
            (a, t(np.where(free, 2.0, 1.0)), a, t(rng.randn(m))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 2, 3, 16, 17, 1023, 1025, 9999, 99_999] + list(K7_TILE_ROWS))
def test_tv1d_pcr_is_the_plain_pcr_bitwise(cuda, m, dtype):
    """One PCR solve by K7's PCR code (the tile build's: its first levels
    in shared memory, the rest in device memory) equals
    ``pcr_tridiag_solve`` on the card bitwise, on a diagonally dominant
    random system and on one as a PDAS round builds it (pinned rows, c =
    a)."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    for system in _pcr_systems(m, dtype, cuda):
        assert _same_bits(tv1d_pdas.pcr(*system), tv1d.pcr_tridiag_solve(*system))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [3, 511, 2049, 99_999, 999_999])
def test_tv1d_pcr_every_tile_depth_bitwise(cuda, m, dtype):
    """The tile build's PCR at every depth K = 1..11 that fits the shared
    memory budget (whole-row windows where K reaches the steps; several
    tiles a block at m = 999,999) equals ``pcr_tridiag_solve`` bitwise."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    systems = _pcr_systems(m, dtype, cuda)
    want = [tv1d.pcr_tridiag_solve(*system) for system in systems]
    ran = 0
    for levels in range(1, tv1d_pdas.MAX_TILE_LEVELS + 1):
        try:
            tv1d_pdas.tile_plan(m, tv1d_pdas.grid("pcr", m, systems[0][0]),
                                systems[0][0].element_size(), levels)
        except ValueError:
            continue
        for system, w in zip(systems, want):
            assert _same_bits(tv1d_pdas.pcr(*system, levels=levels), w)
        ran += 1
    assert ran >= 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [257, 511, 4097, 99_999, 999_999, 1_499_999])
def test_tv1d_pcr_residue_stage_bitwise(cuda, m, dtype):
    """K7's PCR on the rule's plan, with the residue stage everywhere here
    (at K = 9 in f64 from 999,999 rows), and on the plan without it
    equals ``pcr_tridiag_solve`` bitwise."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    systems = _pcr_systems(m, dtype, cuda)
    plan = tv1d_pdas.tile_plan(m, tv1d_pdas.grid("pcr", m, systems[0][0]),
                               systems[0][0].element_size())
    assert plan.residue
    for system in systems:
        want = tv1d.pcr_tridiag_solve(*system)
        assert _same_bits(tv1d_pdas.pcr(*system), want)
        assert _same_bits(tv1d_pdas.pcr(*system, residue=False), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 3, 17, 1023, 1025, 4097, 100_000])
def test_tv1d_pdas_matches_plain_and_oracle(cuda, n, dtype):
    """K7 through its dispatch (one launch, the rounds a 0-d int32 CUDA
    tensor) cold, warm from its own dual on a perturbed signal, and with
    lam a 0-d CUDA tensor, at the default tolerance: bitwise repeatable,
    within K7_RTOL of the plain PDAS on the card and of the exact oracle,
    the rounds within one of the plain version's."""
    lam = 0.5 * np.sqrt(n) if n > 3 else 0.3
    v = torch.as_tensor(_tv_signal(n, n), dtype=dtype, device=cuda)
    z = _pdas_check(v, lam, None, None, 1)
    v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(1).randn(n), dtype=dtype, device=cuda)
    _pdas_check(v2, lam, None, z, 1)
    _pdas_check(v2, torch.tensor(lam, dtype=dtype, device=cuda), None, z, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [17, 1025, 100_000])
def test_tv1d_pdas_rounds_at_inner_tolerances(cuda, n, dtype):
    """At the inner tolerances the solver sets, K7 takes the plain
    version's rounds, cold and warm."""
    lam = 0.5 * np.sqrt(n)
    v = torch.as_tensor(_tv_signal(n, 2 * n), dtype=dtype, device=cuda)
    v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(3).randn(n), dtype=dtype, device=cuda)
    for tol in K7_INNER_TOLS[dtype]:
        z = _pdas_check(v, lam, tol, None, 0)
        _pdas_check(v2, lam, tol, z, 0)


def _levels_check(v, lam, tol, z0, plan=None):
    """The tile build (the dispatch's, or at a sweep's depth) against the
    levels build it replaced: the same x, z, gap and rounds, bitwise; one
    counted launch of the tile build, none for the levels build; the grid
    syncs each build counted on the device as ``tv1d_pdas``'s formulas
    count them for its rounds."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    n = v.shape[0]
    tol_ = tv1d.pdas_default_tol(v.dtype) if tol is None else tol
    counter = tv1d_pdas.sync_counter(v.device)
    before = tv1d_pdas.launches
    counter.zero_()
    if plan is None:
        x, gap, it, z = tv1d.prox_tv1d_pdas(v, lam, tol=tol, z0=z0, return_dual=True)
        plan = tv1d_pdas.tile_plan(n - 1, tv1d_pdas.grid("pdas", n, v), v.element_size())
    else:
        x, z, gap, it = tv1d_pdas._launch_pdas(tv1d_pdas._pdas_args("tv1d_pdas", v, lam, z0),
                                               tol_, 40, "tiles", plan)
    assert tv1d_pdas.launches == before + 1
    assert int(counter) == tv1d_pdas.grid_syncs(int(it), tv1d_pdas.syncs_per_round(plan))
    counter.zero_()
    xl, zl, gapl, itl = tv1d_pdas.pdas_levels(v, lam, tol_, z0=z0)
    assert tv1d_pdas.launches == before + 1
    assert int(counter) == tv1d_pdas.grid_syncs(int(itl),
                                                tv1d_pdas.levels_syncs_per_round(plan.steps))
    assert _same_bits(x, xl) and _same_bits(z, zl) and _same_bits(gap, gapl)
    assert int(it) == int(itl)
    return z


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", sorted({2, 3, 17, 1023, 1025, 4097, 10_000, 100_000}
                                     | {m + 1 for m in K7_TILE_ROWS}))
def test_tv1d_tiles_equal_the_levels_build_bitwise(cuda, n, dtype):
    """K7's tile build through the dispatch equals the levels build it
    replaced bitwise (x, z, gap, rounds): cold, warm from its own dual on a
    perturbed signal and with lam a 0-d CUDA tensor, at the default and at
    the inner tolerances."""
    lam = 0.5 * np.sqrt(n) if n > 3 else 0.3
    v = torch.as_tensor(_tv_signal(n, n), dtype=dtype, device=cuda)
    v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(1).randn(n), dtype=dtype, device=cuda)
    for tol in [None] + K7_INNER_TOLS[dtype]:
        z = _levels_check(v, lam, tol, None)
        _levels_check(v2, lam, tol, z)
        _levels_check(v2, torch.tensor(lam, dtype=dtype, device=cuda), tol, z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [10_000, 100_000, 1_000_000])
def test_tv1d_tiles_every_depth_bitwise(cuda, n, dtype):
    """The tile build at every depth K = 1..11 that fits (several tiles a
    block at n = 1,000,000), with the residue stage where it fits and with
    levels in device memory, equals the levels build bitwise, warm at an
    inner tolerance, and runs the syncs its plan counts."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    lam, tol = float(np.sqrt(n)), K7_INNER_TOLS[dtype][-1]
    v = torch.as_tensor(_tv_signal(n, 5), dtype=dtype, device=cuda)
    z = _levels_check(v, lam, tol, None)
    v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(6).randn(n), dtype=dtype, device=cuda)
    ran = 0
    g = tv1d_pdas.grid("pdas", n, v)
    for levels in range(1, tv1d_pdas.MAX_TILE_LEVELS + 1):
        for residue in (True, False):
            try:
                plan = tv1d_pdas.tile_plan(n - 1, g, v.element_size(), levels, residue)
            except ValueError:
                continue
            _levels_check(v2, lam, tol, z, plan)
            ran += 1
    assert ran >= 12


@pytest.mark.parametrize("n,dtype", [(100_000, torch.float32), (1_000_000, torch.float32),
                                     (1_500_001, torch.float32), (1_000_000, torch.float64)])
def test_tv1d_residue_stage_equals_the_levels_build_bitwise(cuda, n, dtype):
    """The dispatched plan has the residue stage at n = 100,000 (f32, K =
    7, classes of 782 rows), 1,000,000 (f32, K = 8, 3,907 rows; f64, K = 9,
    1,954 rows) and 1,500,001 (f32, K = 8, 5,860 rows, a level short of the
    last at a stride of 2,048), and the build equals the levels build
    bitwise (x, z, gap, rounds) cold and warm at the default and the inner
    tolerances, with 4 grid syncs a round and 2 a call."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    lam = float(np.sqrt(n))
    v = torch.as_tensor(_tv_signal(n, 7), dtype=dtype, device=cuda)
    plan = tv1d_pdas.plan_for(v)
    assert plan.residue and tv1d_pdas.syncs_per_round(plan) == 4
    v2 = v + 0.05 * torch.as_tensor(np.random.RandomState(8).randn(n), dtype=dtype, device=cuda)
    for tol in [None] + K7_INNER_TOLS[dtype]:
        z = _levels_check(v, lam, tol, None)
        _levels_check(v2, lam, tol, z)


def test_tv1d_tile_build_runs_the_levels_builds_grid(cuda):
    """The tile build runs the levels build's grid (the blocks of
    512 the levels build keeps resident, two an SM in f32 and one in f64,
    or the row's, whichever is fewer), so both sum in one order, and keeps
    it resident itself; the PCR entry solves m rows on the grid of a row of
    m + 1; the source's shared memory budget is the wrapper's."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    assert tv1d_pdas._library().tv1d_pdas_smem_budget() == tv1d_pdas.SMEM_BUDGET
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dtype, per_sm in ((torch.float32, 2), (torch.float64, 1)):
        v = torch.empty(1, dtype=dtype, device=cuda)
        for n in (10_000, 100_000, 1_000_000):
            want = min(per_sm * sms, -(-n // 512))
            assert tv1d_pdas.grid("pdas", n, v) == tv1d_pdas.grid("pdas_levels", n, v) == want
            assert tv1d_pdas.grid("pcr", n - 1, v) == want


def test_k7_dispatch_never_reaches_the_levels_entry(cuda, monkeypatch):
    """The TV-1D dispatch launches the tile build, never the levels build."""
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    from epsilon_tpu_torch.ops.prox import tv1d
    names = _Names(tv1d_pdas._library())
    monkeypatch.setattr(tv1d_pdas, "_LIB", names)
    for dtype in (torch.float32, torch.float64):
        tv1d.prox_tv1d_pdas(torch.as_tensor(_tv_signal(300, 4), dtype=dtype, device=cuda), 2.0)
    assert [n for n in names.names if "grid" not in n] == ["tv1d_pdas_f32", "tv1d_pdas_f64"]


def test_tv1d_pdas_round_cap_and_warm_projection(cuda):
    """A cap of one or two rounds stops there, as the plain version does;
    a warm dual from a larger lam is clamped into the box."""
    from epsilon_tpu_torch.ops.prox import tv1d
    v = torch.as_tensor(50 * _tv_signal(3000, 6), dtype=torch.float64, device=cuda)
    for cap in (1, 2):
        x, _, it = tv1d.prox_tv1d_pdas(v, 2.0, tol=1e-12, max_iters=cap)
        xr, _, itr = tv1d.prox_tv1d_pdas_reference(v, 2.0, tol=1e-12, max_iters=cap)
        assert int(it) == itr == cap
        assert (x - xr).abs().max().item() <= 1e-9 * v.abs().max().item()
    _, _, _, z = tv1d.prox_tv1d_pdas(v, 5.0, return_dual=True)
    x, _, _ = tv1d.prox_tv1d_pdas(v, 0.5, z0=z)
    exact = tv1d.tv1d_exact_numpy(v.cpu().numpy(), 0.5)
    assert np.abs(x.cpu().numpy() - exact).max() <= 1e-9 * v.abs().max().item()


def _host_calls(prof):
    from torch.autograd import DeviceType
    return sorted(e.key for e in prof.key_averages() if e.device_type == DeviceType.CPU
                  and e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                "cudaMemcpyAsync", "cudaMemcpy"))


def test_k6_k7_each_one_kernel_and_no_host_sync(cuda):
    """On a CUDA tensor, K6, K7, K8, K9, K10 and K11's dispatch each launch
    one kernel and neither synchronizes with the host nor copies to it (K8
    with s one an element and a 0-d tensor on the card; K9 with u and v the
    halves of one packed tensor's rows, read where they lie, and lam one a
    row; K10 and K11 with lam a 0-d tensor on the card): the profiled call
    shows no
    host-blocking CUDA call beyond those of an empty profiled window (the
    profiler's own and the synchronize that closes each window), and
    PyTorch's sync debug mode raises on none of its operations.  The one
    test of the file that starts the profiler: a profiled window opened
    after an earlier test's windows and the K7 tests recorded no device
    events on the card, and a window that closed right after its launch
    recorded none in one run of two (K8's, after K6's had passed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import element_loop_inputs, k8_inputs
    from epsilon_tpu_torch.ops.prox import elementwise, tv1d
    v = torch.as_tensor(_tv_signal(100_000, 7), dtype=torch.float32, device=cuda)
    lam = torch.tensor(316.0, device=cuda)
    _, _, _, z = tv1d.prox_tv1d_pdas(v, lam, return_dual=True)
    u = torch.as_tensor(np.random.RandomState(8).uniform(-9, 9, 1500), dtype=torch.float32,
                        device=cuda)
    w, s = k8_inputs(2000, torch.float32, 3, cuda)
    kl, kl_lam = element_loop_inputs("sum_kl_div_prox", 10_000, torch.float32, 4, cuda, "packed")
    (y,), y_lam = element_loop_inputs("sum_inv_pos_prox", 10_000, torch.float32, 5, cuda, "0-d")
    # every kernel's first call in this process (which loads its library)
    # outside the profiled windows, as K7's above
    elementwise.prox_sum_logistic(u, lam)
    elementwise.epi_exp(w, s)
    elementwise.prox_sum_kl_div(*kl, kl_lam)
    elementwise.prox_sum_inv_pos(y, y_lam)
    elementwise.prox_sum_exp(y, y_lam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
    baseline = _host_calls(prof)
    for call, name in ((lambda: tv1d.prox_tv1d_pdas(v, lam, tol=1e-3, z0=z), "pdas_tiles"),
                       (lambda: elementwise.prox_sum_logistic(u, lam), "prox_logistic"),
                       (lambda: elementwise.epi_exp(w, s), "epi_exp"),
                       (lambda: elementwise.epi_exp(w, s[0]), "epi_exp"),
                       (lambda: elementwise.prox_sum_kl_div(*kl, kl_lam), "prox_kl_div"),
                       (lambda: elementwise.prox_sum_inv_pos(y, y_lam), "prox_inv_pos"),
                       (lambda: elementwise.prox_sum_exp(y, y_lam), "prox_w_log_w"),
                       (lambda: elementwise.prox_sum_neg_entr(y, y_lam), "prox_w_log_w")):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            # the window closes on finished device work (the empty window
            # above closes the same way)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0].key and kernels[0].count == 1, \
            (name, [(e.key, e.count) for e in kernels])
        assert _host_calls(prof) == baseline, (name, _host_calls(prof), baseline)


@pytest.mark.parametrize("row,kwargs,kernel", [
    ("tv_1d", dict(n=400), "tv1d_pdas"),
    ("fused_lasso", dict(m=40, ni=2, k=50), "tv1d_pdas"),
    ("logreg_l1", dict(m=60, n=30), "sum_logistic"),
])
def test_k6_k7_rows_on_card_match_cpu_port(cuda, monkeypatch, row, kwargs, kernel):
    """A row whose prox is K6 or K7, at the small size of the CPU library
    tests, through Problem.solve on the card in f64 (the kernel launched)
    against the port on the CPU in f64: objective within 1e-6 relative and
    the same iteration count, or one epoch of 50 apart (the kernels sum in
    another order)."""
    import importlib
    from epsilon_tpu_torch.problems import benchmark
    module = importlib.import_module(f"epsilon_tpu_torch.ops.kernels.{kernel}")
    monkeypatch.setattr(config, "default_dtype", lambda: torch.float64)
    monkeypatch.setattr(config, "default_np_dtype", lambda: np.dtype(np.float64))
    inst = next(p for p in benchmark.PROBLEMS_REFERENCE() if p.name == row)
    inst = benchmark.ProblemInstance(row, inst.create, kwargs)
    before = module.launches
    prob = inst.create_problem()
    obj_gpu = prob.solve(rel_tol=1e-3)
    iters_gpu = prob.solver_status.num_iterations
    assert prob.status == "optimal"
    assert module.launches >= before + iters_gpu
    config.set_device("cpu")
    prob_cpu = inst.create_problem()
    obj_cpu = prob_cpu.solve(rel_tol=1e-3)
    assert prob_cpu.status == "optimal"
    assert abs(iters_gpu - prob_cpu.solver_status.num_iterations) <= 50
    np.testing.assert_allclose(obj_gpu, obj_cpu, rtol=1e-6)


def test_k6_dispatch_never_reaches_the_full_count_entry(cuda, monkeypatch):
    """The SUM_LOGISTIC dispatch launches the kernel that exits, never its
    full-count build."""
    from epsilon_tpu_torch.ops.kernels import sum_logistic
    from epsilon_tpu_torch.ops.prox import elementwise
    names = _Names(sum_logistic._library())
    monkeypatch.setattr(sum_logistic, "_LIB", names)
    for dtype in (torch.float32, torch.float64):
        v, lam = _logistic_inputs(64, 1, dtype, cuda, "element")
        elementwise.prox_sum_logistic(v, lam)
    assert names.names == ["sum_logistic_prox_f32", "sum_logistic_prox_f64"]


def test_grid_sync_floor_runs(cuda):
    """The empty cooperative kernel that phase 7a times for K7's grid-sync
    cost launches at K7's grid and leaves every launch counter alone."""
    from chip_smoke import counted_kernels, grid_sync_ms
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    counters = list(counted_kernels().values())
    before = [getattr(mod, counter) for mod, counter in counters]
    v = torch.empty(100_000, device=cuda)
    ms = grid_sync_ms(v, tv1d_pdas.grid("pdas", 100_000, v), tv1d_pdas.threads(), 10)
    assert ms > 0
    assert [getattr(mod, counter) for mod, counter in counters] == before


# -- K9-K11: the SUM_KL_DIV, SUM_INV_POS, SUM_EXP and SUM_NEG_ENTR proxes -------

_ELEMENT_LOOP_ENTRIES = [("sum_kl_div_prox", "sum_kl_div"), ("sum_inv_pos_prox", "sum_inv_pos"),
                         ("w_log_w_prox", "sum_exp"), ("w_log_w_prox", "sum_neg_entr")]
_ELEMENT_LOOP_DISPATCH = {"sum_kl_div": "prox_sum_kl_div", "sum_inv_pos": "prox_sum_inv_pos",
                          "sum_exp": "prox_sum_exp", "sum_neg_entr": "prox_sum_neg_entr"}


def _element_loop_module(name):
    import importlib
    return importlib.import_module("epsilon_tpu_torch.ops.kernels."
                                   + {"sum_kl_div_prox": "sum_kl_div",
                                      "sum_inv_pos_prox": "sum_inv_pos",
                                      "w_log_w_prox": "w_log_w"}[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [256, 20_000])
@pytest.mark.parametrize("name,entry,lam_kind", [
    (name, entry, lam_kind) for name, entry in _ELEMENT_LOOP_ENTRIES
    for lam_kind in ("number", "0-d", "element", "row")
    + (("packed",) if name == "sum_kl_div_prox" else ())])
def test_element_loop_kernel_matches_full_count_and_plain(cuda, name, entry, lam_kind, n, dtype):
    """K9, K10 and K11 (both entries) through their dispatch (one launch)
    equal their full-count builds and their plain versions bitwise, with
    their steps within the loops' counts (``chip_smoke.element_loop_check``),
    on chip_smoke's phase 7a inputs: lam a number, a 0-d tensor on the
    card, one an element and one a row, and for K9 u and v the halves of one
    packed tensor's rows (read where they lie)."""
    from chip_smoke import element_loop_check, element_loop_inputs, element_loops
    from epsilon_tpu_torch.ops.prox import elementwise
    module = _element_loop_module(name)
    ops, lam = element_loop_inputs(name, n, dtype, n, cuda, lam_kind)
    before = module.launches
    got = getattr(elementwise, _ELEMENT_LOOP_DISPATCH[entry])(*ops, lam)
    assert module.launches == before + 1
    out, _ = element_loop_check(name, entry, element_loops()[name], ops, lam,
                                f"{n} {lam_kind} {dtype}")
    # the check's two kernel calls count, its full-count call does not
    assert module.launches == before + 3
    got = got if isinstance(got, tuple) else (got,)
    assert all(_same_bits(a, b) for a, b in zip(got, out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,entry", _ELEMENT_LOOP_ENTRIES)
def test_element_loop_kernel_on_special_values(cuda, name, entry, dtype):
    """Every pair (K9: triple) of the special values of
    ``chip_smoke.element_loop_special`` (NaN, +-inf, 0, -0, +-1e30, lam <=
    0, and for K9 u and v below eps^2, the pass-through): the full-count
    build's bits, the plain version's values (NaN in the same places)."""
    from chip_smoke import element_loop_check, element_loop_special, element_loops
    ops, lam = element_loop_special(name, dtype, cuda)
    element_loop_check(name, entry, element_loops()[name], ops, lam, "special", special=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sum_inv_pos_cube_root_is_the_plain_versions(cuda, dtype):
    """K10's cube root (``row_loops.cuh`` torch_cbrt: torch's sign and pow
    with the exponent in the element type, run alone by ``launch_floor.cu``
    cube_root) gives the bits of the plain version's ``sign(x) |x| **
    (1/3)`` on the card, over 1e-30..1e30 of both signs and the special
    values; no K10 launch is counted."""
    from chip_smoke import cube_root
    from epsilon_tpu_torch.ops.kernels import sum_inv_pos
    from epsilon_tpu_torch.ops.prox import elementwise
    a = torch.as_tensor(10.0 ** np.random.RandomState(3).uniform(-30, 30, 100_000), dtype=dtype,
                        device=cuda)
    special = torch.tensor([np.nan, np.inf, 0.0, -0.0, 1.0, 8.0, 27.0], dtype=dtype, device=cuda)
    a = torch.cat([a, -a, special, -special])
    before = sum_inv_pos.launches
    got, want = cube_root(a), elementwise._cbrt(a)
    assert bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
    assert sum_inv_pos.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,entry", _ELEMENT_LOOP_ENTRIES)
def test_element_loop_chains_run_the_steps_given(cuda, name, entry, dtype):
    """K9's-K11's measured chains (``launch_floor.cu``, lam by value): each
    warp given the full counts, packed one int a warp
    (``chip_smoke.warp_steps``), gives the bits of every element running
    the counts passed; K11's chain, whose steps are its kernel's without an
    exit, gives the full-count build's bits for either entry; no kernel
    launch is counted."""
    from chip_smoke import element_chain, element_loop_inputs, element_loops, warp_steps
    e = element_loops()[name]
    counts = e["counts"]
    n = 1000
    ops, lam = element_loop_inputs(name, n, dtype, 0, cuda, "number")
    module = _element_loop_module(name)
    before = module.launches
    steps = torch.tensor(counts, dtype=torch.int32, device=cuda).expand(
        (n,) + ((len(counts),) if len(counts) > 1 else ())).contiguous()
    warps = warp_steps(steps, n)
    assert warps.shape == ((n + 31) // 32,)
    xs = [torch.empty_like(ops[-1]) for _ in range(2)]
    for x, each in zip(xs, (None, warps)):
        element_chain(name, entry, ops, lam, each, counts, x)()
    torch.cuda.synchronize()
    assert _same_bits(xs[0], xs[1])
    if name == "w_log_w_prox":
        assert _same_bits(xs[0], e["entries"][entry][1](*ops, lam))
    assert module.launches == before


def test_element_loop_kernels_broadcast_and_reject(cuda):
    """lam broadcast per row, a one-element CPU tensor and a number give
    the plain versions' shapes and bits; K9's u broadcast along v's rows is
    read where it lies; lam of a shape that does not broadcast, lam on the
    CPU of another shape, u and v of different dtypes raise."""
    from epsilon_tpu_torch.ops.kernels import sum_kl_div, w_log_w
    from epsilon_tpu_torch.ops.prox import elementwise
    rng = np.random.RandomState(6)
    f64 = lambda *shape: torch.as_tensor(rng.uniform(0.1, 5.0, shape), dtype=torch.float64,
                                         device=cuda)
    u, v = f64(3, 40), f64(3, 40)
    for lam in (f64(3, 1), f64(40), torch.tensor([0.7], dtype=torch.float64), 2.0):
        want_lam = lam.to(cuda) if isinstance(lam, torch.Tensor) else lam
        for a, b in zip(elementwise.prox_sum_kl_div(u, v, lam),
                        elementwise.prox_sum_kl_div_reference(u, v, want_lam)):
            assert _same_bits(a, b)
        assert _same_bits(elementwise.prox_sum_exp(v, lam),
                          elementwise.prox_sum_exp_reference(v, want_lam))
    row = f64(40)
    for a, b in zip(elementwise.prox_sum_kl_div(row, v, 0.3),
                    elementwise.prox_sum_kl_div_reference(torch.broadcast_to(row, v.shape), v, 0.3)):
        assert _same_bits(a, b)
    with pytest.raises(ValueError):
        sum_kl_div.prox(u, v, f64(7))
    with pytest.raises(ValueError):
        w_log_w.prox_exp(v, torch.ones(40, dtype=torch.float64))
    with pytest.raises(ValueError):
        sum_kl_div.prox(u, v.float(), 1.0)


def test_element_loop_dispatch_never_reaches_a_full_count_entry(cuda, monkeypatch):
    """The four proxes' dispatch launches the kernels that exit, never
    their full-count builds."""
    from chip_smoke import element_loop_inputs
    from epsilon_tpu_torch.ops.kernels import sum_inv_pos, sum_kl_div, w_log_w
    from epsilon_tpu_torch.ops.prox import elementwise
    names = {}
    for module in (sum_kl_div, sum_inv_pos, w_log_w):
        names[module.__name__] = _Names(module._library())
        monkeypatch.setattr(module, "_LIB", names[module.__name__])
    for dtype in (torch.float32, torch.float64):
        elementwise.prox_sum_kl_div(*element_loop_inputs("sum_kl_div_prox", 64, dtype, 1, cuda)[0],
                                    0.5)
        v = element_loop_inputs("sum_inv_pos_prox", 64, dtype, 1, cuda)[0][0]
        elementwise.prox_sum_inv_pos(v, 0.5)
        elementwise.prox_sum_exp(v, 0.5)
        elementwise.prox_sum_neg_entr(v, 0.5)
    assert [n for lib in names.values() for n in lib.names] == [
        "sum_kl_div_prox_f32", "sum_kl_div_prox_f64", "sum_inv_pos_prox_f32",
        "sum_inv_pos_prox_f64", "w_log_w_exp_f32", "w_log_w_neg_entr_f32", "w_log_w_exp_f64",
        "w_log_w_neg_entr_f64"]


def test_kl_epigraph_on_the_card_launches_k9_each_outer_step(cuda):
    """The SUM_KL_DIV epigraph (``newton_epi.epi_sum_kl_div``: 24 implicit
    Newton steps on lam, each with one KL prox, and one prox after them) on
    the card in f64, a batch of rows whose u and v are views of one packed
    tensor, launches K9 25 times and agrees with the same call on the CPU
    within 1e-9 relative (x, y and t; the row sums run in another order)."""
    from epsilon_tpu_torch.ops.kernels import sum_kl_div
    from epsilon_tpu_torch.ops.prox import newton_epi
    rng = np.random.RandomState(7)
    u, w = 1.0 + rng.rand(6, 50), 0.5 + rng.rand(6, 50)
    s = 0.1 * rng.rand(6)
    before = sum_kl_div.launches
    got = newton_epi.epi_sum_kl_div(*(torch.as_tensor(a, device=cuda) for a in (u, w, s)))
    assert sum_kl_div.launches == before + 25
    want = newton_epi.epi_sum_kl_div(*(torch.as_tensor(a) for a in (u, w, s)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-9, atol=1e-12)
    assert not np.allclose(got[0].cpu().numpy(), u)       # the rows are active
