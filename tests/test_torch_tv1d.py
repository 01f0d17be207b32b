"""The port's TV-1D prox (PDAS on the dual box QP, the registry path)
against the JAX package and against the exact taut-string oracle
``tv1d_exact_numpy``: cold and warm starts, the round count, the dual, the
gap certificate, the tridiagonal PCR solve, the registry entries and the
warm kernel state threaded through the two-block ADMM loop.

Tolerances (f64 on the CPU): against the JAX package rtol 1e-9, atol 1e-10
and the same PDAS round count wherever the gap test does not read rounding
noise (see the cold test; only the rounding of sums differs); against the exact
oracle atol 1e-7, the certificate's reach at the default PDAS tolerance
(||x - x*|| <= tol * max(1, ||v||), tol 1e-9, on signals of norm <= 100)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu import config as jconfig
from epsilon_tpu.compiler import compiler as jcompiler
from epsilon_tpu.ir import ProxKind as JKind
from epsilon_tpu.ops.prox import registry as jreg
from epsilon_tpu.ops.prox import tv1d as jtv
from epsilon_tpu.problems import fused_lasso as jfused
from epsilon_tpu.problems import tv_1d as jtv_row
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.ir import ProxKind as TKind
from epsilon_tpu_torch.ops.prox import registry as treg
from epsilon_tpu_torch.ops.prox import tv1d as ttv
from epsilon_tpu_torch.problems import fused_lasso as tfused
from epsilon_tpu_torch.problems import tv_1d as ttv_row
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate

RTOL, ATOL = 1e-9, 1e-10
ORACLE_ATOL = 1e-7


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")
    yield
    tconfig.set_prox_inner_tol(None)
    jconfig.set_prox_inner_tol(None)


def _signal(n, seed):
    rng = np.random.RandomState(seed)
    return np.cumsum((rng.rand(n) < 0.05) * 3 * rng.randn(n)) + 0.3 * rng.randn(n)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("tol", [None, 1e-6])
@pytest.mark.parametrize("n,lam", [(2, 0.3), (17, 0.5), (200, 1.0), (513, 0.05), (1000, 4.0)])
def test_pdas_cold_matches_jax_and_oracle(n, lam, tol):
    """At the default tolerance the gap threshold (0.5 (1e-9 max(1, ||v||))^2)
    lies under the rounding of the gap's sum, which XLA fuses with FMAs:
    the last round's test there reads rounding noise, so the round count is
    held equal at an inner tolerance the solver sets (1e-6, the f64 floor
    of ``prox_inner_tol_for`` is 1e-7) and the points at both."""
    v = _signal(n, n)
    xt, gt, it_t, zt = ttv.prox_tv1d_pdas(torch.as_tensor(v), lam, tol=tol, return_dual=True)
    xj, gj, it_j, zj = jtv.prox_tv1d_pdas(jnp.asarray(v), lam, tol=tol, return_dual=True)
    if tol is not None:
        assert it_t == int(it_j)
    _close(xt, xj)
    _close(zt, zj)
    _close(float(gt), float(gj), 1e-6, 1e-12)
    if tol is None:
        _close(xt, ttv.tv1d_exact_numpy(v, lam), 0, ORACLE_ATOL)


def test_pdas_warm_matches_jax_and_takes_fewer_rounds():
    v = _signal(2000, 3)
    _, _, _, z = jtv.prox_tv1d_pdas(jnp.asarray(v), 1.0, return_dual=True)
    v2 = v + 0.01 * np.random.RandomState(4).randn(2000)
    _, _, it_cold = ttv.prox_tv1d_pdas(torch.as_tensor(v2), 1.0)
    xt, _, it_t, zt = ttv.prox_tv1d_pdas(torch.as_tensor(v2), 1.0,
                                         z0=torch.as_tensor(np.array(z)), return_dual=True)
    xj, _, it_j, zj = jtv.prox_tv1d_pdas(jnp.asarray(v2), 1.0, z0=z, return_dual=True)
    assert it_t == int(it_j) < it_cold
    _close(xt, xj)
    _close(zt, zj)
    _close(xt, ttv.tv1d_exact_numpy(v2, 1.0), 0, ORACLE_ATOL)


def test_pdas_warm_dual_from_a_larger_lam_is_projected():
    v = _signal(500, 5)
    _, _, _, z = ttv.prox_tv1d_pdas(torch.as_tensor(v), 5.0, return_dual=True)
    xt, _, it_t = ttv.prox_tv1d_pdas(torch.as_tensor(v), 0.5, z0=z)
    xj, _, it_j = jtv.prox_tv1d_pdas(jnp.asarray(v), 0.5, z0=jnp.asarray(z.numpy()))
    assert it_t == int(it_j)
    _close(xt, xj)


@pytest.mark.parametrize("tol,max_iters", [(1e-3, 40), (1e-12, 40), (None, 2)])
def test_pdas_tolerance_and_round_cap_match_jax(tol, max_iters):
    v = 50 * _signal(3000, 6)
    xt, gt, it_t = ttv.prox_tv1d_pdas(torch.as_tensor(v), 2.0, tol=tol, max_iters=max_iters)
    xj, gj, it_j = jtv.prox_tv1d_pdas(jnp.asarray(v), 2.0, tol=tol, max_iters=max_iters)
    assert it_t == int(it_j) <= max_iters
    _close(xt, xj)
    if tol is not None:
        assert float(gt) <= float(ttv.tv_gap_tol(torch.as_tensor(v), tol)) or it_t == max_iters


def test_pcr_tridiag_solve_matches_jax_and_scipy():
    import scipy.linalg
    rng = np.random.RandomState(7)
    n = 37
    a, c = -rng.rand(n), -rng.rand(n)
    b = 2.5 + rng.rand(n)
    d = rng.randn(n)
    got = ttv.pcr_tridiag_solve(*(torch.as_tensor(t) for t in (a, b, c, d))).numpy()
    _close(got, jtv.pcr_tridiag_solve(*(jnp.asarray(t) for t in (a, b, c, d))))
    ab = np.zeros((3, n))
    ab[0, 1:], ab[1], ab[2, :-1] = c[:-1], b, a[1:]
    np.testing.assert_allclose(got, scipy.linalg.solve_banded((1, 1), ab, d), rtol=1e-12)


def test_gap_eval_and_exact_oracle_match_jax():
    v = _signal(300, 8)
    z = np.clip(np.random.RandomState(9).randn(299), -0.7, 0.7)
    xt, gt = ttv.tv1d_gap(torch.as_tensor(v), 0.7, torch.as_tensor(z))
    xj, gj = jtv.tv1d_gap(jnp.asarray(v), 0.7, jnp.asarray(z))
    _close(xt, xj)
    _close(float(gt), float(gj), 1e-12, 1e-12)
    _close(float(ttv.eval_tv1d(torch.as_tensor(v))), float(jtv.eval_tv1d(jnp.asarray(v))), 1e-13)
    np.testing.assert_array_equal(ttv.tv1d_exact_numpy(v, 0.7), jtv.tv1d_exact_numpy(v, 0.7))


@pytest.mark.parametrize("inner_tol", [None, 1e-4])
def test_registry_entries_match_jax(inner_tol):
    tconfig.set_prox_inner_tol(inner_tol)
    jconfig.set_prox_inner_tol(inner_tol)
    te, je = treg.KERNELS[TKind.TOTAL_VARIATION_1D], jreg.KERNELS[JKind.TOTAL_VARIATION_1D]
    v = _signal(400, 10)
    _close(te.prox(torch.as_tensor(v), 0.8), je.prox(jnp.asarray(v), 0.8))
    z0t = te.state_init(400, torch.float64)
    z0j = je.state_init(400, jnp.float64)
    assert z0t.shape == z0j.shape == (399,)
    xt, zt = te.stateful_prox(torch.as_tensor(v), 0.8, z0t)
    xj, zj = je.stateful_prox(jnp.asarray(v), 0.8, z0j)
    _close(xt, xj)
    _close(zt, zj)
    xt2, _ = te.stateful_prox(torch.as_tensor(v + 0.01), 0.8, zt)
    xj2, _ = je.stateful_prox(jnp.asarray(v + 0.01), 0.8, zj)
    _close(xt2, xj2)


@pytest.mark.parametrize("row", ["tv_1d", "fused_lasso"])
def test_warm_kernel_state_through_admm_matches_jax(row):
    """The two-block loop threads the PDAS duals in both packages; resumed
    from the JAX solver's state after 20 iterations (its kernel state
    carried across with interop), both reach the same iterates."""
    make = {"tv_1d": lambda m: m.create(300),
            "fused_lasso": lambda m: m.create(40, 3, 20)}[row]
    jmod, tmod = (jtv_row, ttv_row) if row == "tv_1d" else (jfused, tfused)
    np.random.seed(0)
    jprob = jcompiler.compile_problem(make(jmod).expression_problem())
    settings = dict(rel_tol=1e-4, abs_tol=1e-7, warm_start=True)
    js = jcreate(jprob, JParams(**settings, max_iterations=20))
    js.solve()
    z, u, ks = js._warm_state
    assert sum(k is not None for k in ks) == 1
    ts = tcreate(interop.prox_problem_from_numpy(jprob), TParams(**settings, max_iterations=5000))
    assert ts._kstate0 is not None and len(ts._kstate0) == len(ks)
    ts._warm_state = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in z.items()}, {k: np.asarray(v) for k, v in u.items()},
        [None if k is None else np.asarray(k) for k in ks])
    js.params = JParams(**settings, max_iterations=5000)
    xj, xt = js.solve(), ts.solve()
    assert ts.status.num_iterations == js.status.num_iterations
    for k in xj.keys():
        _close(xt[k], xj[k], 0, 1e-8)
    for kt, kj in zip(ts._warm_state[2], js._warm_state[2]):
        if kj is not None:
            _close(kt, kj, 0, 1e-8)
    # and through Problem.solve, where the port keeps the state across a
    # warm-started re-solve
    np.random.seed(0)
    pt = make(tmod)
    np.random.seed(0)
    pj = make(jmod)
    for _ in range(2):
        obj_t, obj_j = pt.solve(**settings), pj.solve(**settings)
        assert pt.solver_status.num_iterations == pj.solver_status.num_iterations
        _close(obj_t, obj_j, 1e-9, 0)


# -- the variants off the registry path ----------------------------------------
# Against the JAX functions atol 1e-8 (f64; the FFT and the framed matmul
# differ in the rounding of their sums, amplified over the iterations);
# against the exact oracle at each variant's own reach.  These loops are
# thousands of small operations: one intra-op thread, so that several test
# processes side by side do not fight over the cores.

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rho", [0.3, 1.0, 25.0])
@pytest.mark.parametrize("n", [5, 64, 301])
def test_neumann_laplacian_solve_matches_jax_and_dense(n, rho):
    r = np.random.RandomState(n).randn(n)
    x = ttv.neumann_laplacian_solve(torch.tensor(r), rho).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jtv.neumann_laplacian_solve(jnp.asarray(r), rho)), atol=1e-12)
    D = np.diff(np.eye(n), axis=0)
    np.testing.assert_allclose(x, np.linalg.solve(np.eye(n) + rho * D.T @ D, r),
                               atol=1e-10)
    # a batch of signals, rho a 0-d tensor
    R = np.random.RandomState(1).randn(3, n)
    X = ttv.neumann_laplacian_solve(torch.tensor(R), torch.tensor(rho, dtype=torch.float64))
    np.testing.assert_allclose(X[1].numpy(), ttv.neumann_laplacian_solve(
        torch.tensor(R[1]), rho).numpy(), atol=1e-13)


@pytest.mark.parametrize("rho", [0.0, 0.5, 20.0, 200.0])
@pytest.mark.parametrize("n,taps,block", [(700, 256, 256), (512, 64, 128), (90, 16, 32)])
def test_neumann_laplacian_solve_conv_matches_jax(n, taps, block, rho):
    r = np.random.RandomState(n).randn(2, n)
    got = ttv.neumann_laplacian_solve_conv(torch.tensor(r), rho, taps=taps, block=block)
    want = jtv.neumann_laplacian_solve_conv(jnp.asarray(r), rho, taps=taps, block=block)
    assert got.shape == (2, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    if taps == 256 and rho <= 20.0:
        # the kernel's tail q^taps is below 1e-8: the exact solve
        np.testing.assert_allclose(
            got.numpy(), ttv.neumann_laplacian_solve(torch.tensor(r), rho).numpy(), atol=1e-8)


def test_soft_threshold_matches_jax():
    x = np.random.RandomState(0).randn(50)
    np.testing.assert_allclose(ttv._soft(torch.tensor(x), 0.4).numpy(),
                               np.asarray(jtv._soft(jnp.asarray(x), 0.4)), atol=0)


@pytest.mark.parametrize("n,lam,iters,rho", [(40, 0.5, 150, 1.0), (200, 2.0, 400, 1.0),
                                             (120, 0.8, 300, 3.0)])
def test_prox_tv1d_douglas_rachford_matches_jax(n, lam, iters, rho, one_thread):
    v = _signal(n, 3)
    x = ttv.prox_tv1d(torch.tensor(v), lam, iters=iters, rho=rho).numpy()
    np.testing.assert_allclose(
        x, np.asarray(jtv.prox_tv1d(jnp.asarray(v), lam, iters=iters, rho=rho)), atol=1e-8)
    # a fixed count, not a converged solve
    np.testing.assert_allclose(x, ttv.tv1d_exact_numpy(v, lam), atol=2e-2)


@pytest.mark.parametrize("n,lam,tol", [(30, 0.8, None), (300, 2.0, 1e-7), (600, 1.5, 1e-7),
                                       (1100, 6.0, 1e-6)])
def test_prox_tv1d_certified_matches_jax_and_oracle(n, lam, tol, one_thread):
    """Short signals take the FFT solve, n >= 512 the framed matmul with rho
    clamped at 200; the same epochs as the JAX loop, and the certificate
    holds against the exact solution."""
    v = _signal(n, 4)
    x, gap, iters = ttv.prox_tv1d_certified(torch.tensor(v), lam, tol=tol)
    xj, gapj, itersj = jtv.prox_tv1d_certified(jnp.asarray(v), lam, tol=tol)
    assert iters == int(itersj) and iters < 3000
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8)
    exact = ttv.tv1d_exact_numpy(v, lam)
    assert np.sum((x.numpy() - exact) ** 2) <= 2.0 * float(gap) + 1e-12
    reach = (tol or 1e-7) * max(1.0, np.linalg.norm(v))
    assert float(gap) <= 0.5 * reach ** 2
    np.testing.assert_allclose(x.numpy(), exact, atol=reach)


def test_prox_tv1d_certified_respects_the_iteration_cap_and_warm_start(one_thread):
    v = _signal(400, 5)
    x, gap, iters = ttv.prox_tv1d_certified(torch.tensor(v), 3.0, tol=1e-9, max_iters=64)
    xj, gapj, itersj = jtv.prox_tv1d_certified(jnp.asarray(v), 3.0, tol=1e-9, max_iters=64)
    assert iters == int(itersj) == 64
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8)
    np.testing.assert_allclose(float(gap), float(gapj), rtol=1e-6)
    w0, u0 = np.diff(ttv.tv1d_exact_numpy(v, 3.0)), np.zeros(399)
    xw, _, iw = ttv.prox_tv1d_certified(torch.tensor(v), 3.0, tol=1e-6,
                                        w0=torch.tensor(w0), u0=torch.tensor(u0))
    xwj, _, iwj = jtv.prox_tv1d_certified(jnp.asarray(v), 3.0, tol=1e-6,
                                          w0=jnp.asarray(w0), u0=jnp.asarray(u0))
    assert iw == int(iwj)
    np.testing.assert_allclose(xw.numpy(), np.asarray(xwj), atol=1e-8)


@pytest.mark.parametrize("n,coarse_n", [(900, 256), (1301, 256), (200, 2048)])
def test_prox_tv1d_multiscale_matches_jax_and_oracle(n, coarse_n, one_thread):
    """Two levels of decimation (odd lengths edge-padded for the warm start
    only), and the short-signal case that goes straight to the certified
    solve."""
    v, lam, tol = _signal(n, 6), 2.5, 1e-6
    x, gap, iters = ttv.prox_tv1d_multiscale(torch.tensor(v), lam, tol=tol,
                                             coarse_n=coarse_n)
    xj, gapj, itersj = jtv.prox_tv1d_multiscale(jnp.asarray(v), lam, tol=tol,
                                                coarse_n=coarse_n)
    assert iters == int(itersj)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-8)
    exact = ttv.tv1d_exact_numpy(v, lam)
    assert np.sum((x.numpy() - exact) ** 2) <= 2.0 * float(gap) + 1e-12
    np.testing.assert_allclose(x.numpy(), exact, atol=max(
        tol * max(1.0, np.linalg.norm(v)), np.sqrt(2.0 * float(gap))))


def test_pdas_takes_lam_as_a_tensor():
    """The adaptive solver hands lam/rho over as a 0-d tensor; the kernel
    gives the number's result without reading it back."""
    v = torch.tensor(_signal(120, 8))
    lam = torch.tensor(1.7, dtype=torch.float64)
    xa, ga, ia, za = ttv.prox_tv1d_pdas(v, lam, return_dual=True)
    xb, gb, ib, zb = ttv.prox_tv1d_pdas(v, 1.7, return_dual=True)
    assert ia == ib and torch.equal(xa, xb) and torch.equal(za, zb)
    xw, _, _, _ = ttv.prox_tv1d_pdas(v, lam / 2, z0=za, return_dual=True)
    np.testing.assert_allclose(xw.numpy(), ttv.tv1d_exact_numpy(v.numpy(), 0.85), atol=ORACLE_ATOL)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("n,lam", [(2, 0.3), (3, 0.4), (1025, 1.0), (4097, 2.0)])
def test_pdas_reference_matches_jax_at_the_inner_tolerance(n, lam, start):
    """The plain PDAS (``prox_tv1d_pdas_reference``, which the CUDA kernel
    K7 is held to on the card) against the JAX package at an inner
    tolerance the solver sets: the same rounds, x and the dual within
    RTOL/ATOL; warm from the JAX package's own dual of a nearby signal, lam a
    0-d tensor."""
    v = _signal(n, 11 * n)
    z0 = None
    if start == "warm":
        _, _, _, zj0 = jtv.prox_tv1d_pdas(jnp.asarray(v), lam, return_dual=True)
        v = v + 0.01 * np.random.RandomState(n).randn(n)
        z0 = np.array(zj0)
    xt, _, it_t, zt = ttv.prox_tv1d_pdas_reference(
        torch.as_tensor(v), torch.tensor(lam, dtype=torch.float64), tol=1e-6,
        z0=None if z0 is None else torch.as_tensor(z0), return_dual=True)
    xj, _, it_j, zj = jtv.prox_tv1d_pdas(jnp.asarray(v), lam, tol=1e-6,
                                         z0=None if z0 is None else jnp.asarray(z0),
                                         return_dual=True)
    assert isinstance(it_t, int) and it_t == int(it_j)
    _close(xt, xj)
    _close(zt, zj)
