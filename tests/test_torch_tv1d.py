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
