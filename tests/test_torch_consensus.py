"""The port's consensus path (``epsilon_tpu_torch.parallel``) against the
JAX package's (``epsilon_tpu.parallel``) on the same data, one counterpart
for each test of test_consensus.py, in the triangular and the
explicit-inverse factor modes.

Tolerances (both sides in f64 on the CPU; they differ only in the order of
floating-point sums): the same iteration count, z atol 1e-8, the per-epoch
residual series rtol 1e-6 with atol 1e-12 (near convergence the dual
residual is a difference of nearly equal z's, where rounding at 1e-16 is a
large share of it).  The forced K1 path runs in f32 on both sides
(the Pallas kernel takes f32 only): z atol 1e-5, series rtol 1e-2."""

import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epsilon_tpu import config as jconfig
from epsilon_tpu.ops import pallas_kernels as pk
from epsilon_tpu.parallel import ConsensusADMM as JConsensusADMM
from epsilon_tpu.parallel import consensus_lasso_solver as jsolver
from epsilon_tpu.problems import scaling_bench as jscaling
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch.ops.kernels import local_update as lu
from epsilon_tpu_torch.parallel import ConsensusADMM, block_mesh
from epsilon_tpu_torch.parallel import consensus_lasso_solver as tsolver
from epsilon_tpu_torch.problems import scaling_bench as tscaling

Z_ATOL = 1e-8
SERIES_RTOL = 1e-6
SERIES_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


@pytest.fixture(params=["triangular", "inverse"])
def mode(request, monkeypatch):
    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "FACTOR_SOLVE_MODE", request.param)
    return request.param


def _make_lasso_blocks(S, m, n, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(S, m, n)
    x0 = rng.randn(n) * (rng.rand(n) < 0.3)
    b = np.einsum("smn,n->sm", A, x0) + 0.05 * rng.randn(S, m)
    return A, b


def _full_objective(A, b, lam, x):
    r = np.einsum("smn,n->sm", A, x) - b
    return 0.5 * np.sum(r * r) + lam * np.sum(np.abs(x))


def _oracle(A, b, lam):
    from sklearn.linear_model import Lasso
    S, m, n = A.shape
    model = Lasso(alpha=lam / (S * m), fit_intercept=False, tol=1e-12,
                  max_iter=200000)
    model.fit(A.reshape(S * m, n), b.reshape(S * m))
    return model.coef_


def assert_matches(rt, rj, z_atol=Z_ATOL, series_rtol=SERIES_RTOL):
    assert rt.iterations == rj.iterations
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=0, atol=z_atol)
    assert rt.series.shape == np.asarray(rj.series).shape
    np.testing.assert_allclose(rt.series, rj.series, rtol=series_rtol, atol=SERIES_ATOL)


def both(A, b, lam, **kw):
    return tsolver(A, b, lam, **kw).solve(), jsolver(A, b, lam, **kw).solve()


def test_consensus_lasso_single_device(mode):
    S, m, n = 8, 20, 10
    A, b = _make_lasso_blocks(S, m, n)
    lam = 1.0
    rt, rj = both(A, b, lam, rho=1.0, rel_tol=1e-6, abs_tol=1e-9, max_iterations=20000)
    assert rt.converged
    assert_matches(rt, rj)
    x = rt.z.numpy()
    assert _full_objective(A, b, lam, x) <= \
        _full_objective(A, b, lam, _oracle(A, b, lam)) * (1 + 1e-4) + 1e-6


def test_consensus_generic_ridge():
    """Smooth local terms only (g = 0); the port's local_prox is batched
    over the blocks, the JAX package's is vmapped."""
    S, m, n = 4, 10, 5
    rng = np.random.RandomState(2)
    A = rng.randn(S, m, n)
    b = rng.randn(S, m)
    rho = 1.0
    AtA = np.einsum("smi,smj->sij", A, A)
    Atb = np.einsum("smi,sm->si", A, b)
    L = np.linalg.cholesky(AtA + rho * np.eye(n))
    kw = dict(rho=rho, rel_tol=1e-8, abs_tol=1e-11, max_iterations=20000)

    def t_local_prox(v, d):
        return torch.cholesky_solve((d["Atb"] + rho * v).unsqueeze(-1), d["L"]).squeeze(-1)

    def j_local_prox(v, d):
        import jax.scipy.linalg as jsla
        y = jsla.solve_triangular(d["L"], d["Atb"] + rho * v, lower=True)
        return jsla.solve_triangular(d["L"].T, y, lower=False)

    rt = ConsensusADMM(t_local_prox, lambda v: v,
                       {"L": torch.as_tensor(L), "Atb": torch.as_tensor(Atb)},
                       S, n, **kw).solve()
    rj = JConsensusADMM(j_local_prox, lambda v: v,
                        {"L": jnp.asarray(L), "Atb": jnp.asarray(Atb)}, S, n, **kw).solve()
    assert_matches(rt, rj)
    x_o = np.linalg.lstsq(A.reshape(S * m, n), b.reshape(S * m), rcond=None)[0]
    np.testing.assert_allclose(rt.z.numpy(), x_o, atol=1e-5)


def test_adaptive_rho_converges_faster():
    """Badly scaled blocks: residual-balancing rho (eigh factor cache)
    needs no more iterations than a poorly chosen fixed rho, and matches the
    JAX package."""
    S, m, n = 4, 30, 8
    rng = np.random.RandomState(7)
    A = rng.randn(S, m, n)
    A[0] *= 30.0
    x0 = rng.randn(n) * (rng.rand(n) < 0.5)
    b = np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)
    lam = 1.0
    kw = dict(rho=0.01, rel_tol=1e-6, abs_tol=1e-9, max_iterations=50000)
    res_fixed = tsolver(A, b, lam, **kw).solve()
    rt, rj = both(A, b, lam, adaptive_rho=True, **kw)
    assert rt.converged
    assert rt.iterations <= res_fixed.iterations
    assert_matches(rt, rj)
    assert _full_objective(A, b, lam, rt.z.numpy()) <= \
        _full_objective(A, b, lam, _oracle(A, b, lam)) * (1 + 1e-3) + 1e-6


def test_consensus_over_relaxation(mode):
    S, m, n = 4, 20, 6
    A, b = _make_lasso_blocks(S, m, n, seed=9)
    lam = 0.4
    kw = dict(rel_tol=1e-7, abs_tol=1e-10, max_iterations=30000)
    res_p = tsolver(A, b, lam, **kw).solve()
    rt, rj = both(A, b, lam, over_relaxation=1.7, **kw)
    assert rt.converged
    assert rt.iterations <= res_p.iterations
    assert_matches(rt, rj)
    assert _full_objective(A, b, lam, rt.z.numpy()) <= \
        _full_objective(A, b, lam, _oracle(A, b, lam)) * (1 + 1e-3) + 1e-6


def test_consensus_epoch_tail_dual_residual(mode):
    """s_norm is the final sweep's rho*sqrt(S)*||z - z_prev||, so checking
    every 10 iterations overshoots checking every iteration by less than an
    epoch; the iteration counts equal the JAX package's at both E."""
    S, m, n = 8, 20, 10
    A, b = _make_lasso_blocks(S, m, n, seed=3)
    it_counts = {}
    for E in (1, 10):
        rt, rj = both(A, b, 0.5, rho=1.0, rel_tol=1e-6, abs_tol=1e-9,
                      max_iterations=30000, epoch_iterations=E)
        assert rt.converged
        assert_matches(rt, rj)
        it_counts[E] = rt.iterations
    assert it_counts[10] <= it_counts[1] + 10


def test_consensus_residual_series(mode):
    S, m, n = 8, 15, 6
    A, b = _make_lasso_blocks(S, m, n, seed=2)
    rt, rj = both(A, b, 0.5, rel_tol=1e-5, abs_tol=1e-8, max_iterations=20000,
                  epoch_iterations=10)
    assert rt.converged
    assert rt.series.shape == (rt.iterations // 10, 2)
    np.testing.assert_allclose(rt.series[-1], [rt.r_norm, rt.s_norm], rtol=1e-12)
    assert rt.series[-1, 0] < rt.series[0, 0] * 1e-2
    assert_matches(rt, rj)


def test_max_iterations_rounds_to_epochs():
    A, b = _make_lasso_blocks(4, 10, 5, seed=4)
    rt, rj = both(A, b, 0.5, rel_tol=1e-12, abs_tol=1e-15, max_iterations=25,
                  epoch_iterations=10)
    assert not rt.converged
    assert rt.iterations == 20
    assert_matches(rt, rj)


def test_forced_kernel_path_matches_pallas(monkeypatch):
    """use_pallas=True in explicit-inverse mode at n >= 128: the port goes
    through fused_local_update every iteration, the JAX package through its
    Pallas kernel in interpret mode.  Both in f32: the Pallas kernel takes
    f32 only, so JAX runs with x64 off and the port with f32 tensors."""
    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "FACTOR_SOLVE_MODE", "inverse")
    monkeypatch.setattr(tconfig, "default_dtype", lambda: torch.float32)
    monkeypatch.setattr(pk, "fused_local_update",
                        partial(pk.fused_local_update, interpret=True))
    calls = []
    real = lu.fused_local_update
    monkeypatch.setattr(lu, "fused_local_update",
                        lambda *a: calls.append(1) or real(*a))
    S, m, n = 4, 200, 130
    rng = np.random.RandomState(0)
    A = (rng.randn(S, m, n) / np.sqrt(m)).astype(np.float32)
    x0 = rng.randn(n) * (rng.rand(n) < 0.2)
    b = (np.einsum("smn,n->sm", A, x0) + 0.01 * rng.randn(S, m)).astype(np.float32)
    lam = 0.1 * float(np.abs(np.einsum("smn,sm->n", A, b)).max())
    kw = dict(use_pallas=True, rel_tol=1e-4, abs_tol=1e-6, max_iterations=2000)
    rt = tsolver(A, b, lam, **kw).solve()
    assert rt.z.dtype == torch.float32
    assert len(calls) == rt.iterations
    jax.config.update("jax_enable_x64", False)
    try:
        rj = jsolver(A, b, lam, **kw).solve()
        assert np.asarray(rj.z).dtype == np.float32
    finally:
        jax.config.update("jax_enable_x64", True)
    assert rt.converged
    assert_matches(rt, rj, z_atol=1e-5, series_rtol=1e-2)


@pytest.mark.parametrize("use_pallas,n", [("auto", 130), (True, 127), (False, 130)])
def test_kernel_gate(monkeypatch, use_pallas, n):
    """On the CPU "auto" leaves the kernel off, as the JAX package does on
    its CPU backend; below n = 128 or with False it is off everywhere."""
    monkeypatch.setattr(tconfig, "FACTOR_SOLVE_MODE", "inverse")
    A, b = _make_lasso_blocks(2, 4, n)
    assert tsolver(A, b, 1.0, use_pallas=use_pallas).local_update is None


def test_warm_start_from_jax_state(mode):
    """Both packages resume from the JAX solver's state after 20
    iterations, carried across with interop.consensus_state_from_numpy."""
    S, m, n = 8, 20, 10
    A, b = _make_lasso_blocks(S, m, n, seed=5)
    kw = dict(rho=1.0, rel_tol=1e-6, abs_tol=1e-9)
    early = jsolver(A, b, 1.0, max_iterations=20, **kw)
    early.solve()
    state = [np.asarray(a) for a in early._last_state]
    js = jsolver(A, b, 1.0, max_iterations=20000, **kw)
    ts = tsolver(A, b, 1.0, max_iterations=20000, **kw)
    rj = js.solve(state=tuple(jnp.asarray(a) for a in state))
    rt = ts.solve(state=interop.consensus_state_from_numpy(*state))
    assert rt.converged
    assert_matches(rt, rj)
    cold = ts.solve()
    assert cold.iterations > rt.iterations
    for got, want in zip(ts._last_state[:3], js._last_state[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-8)


def test_data_blocks_checked():
    with pytest.raises(ValueError):
        ConsensusADMM(lambda v, d: v, lambda v: v, {"L": torch.zeros(3, 2, 2)}, 4, 2)


def test_block_mesh_needs_initialised_distributed():
    with pytest.raises(RuntimeError, match="not initialised"):
        block_mesh()


def test_make_blocks_matches_jax():
    for a, b in zip(tscaling.make_blocks(4, 12, 6), jscaling.make_blocks(4, 12, 6)):
        np.testing.assert_array_equal(a, b)


def test_run_scaling_one_device():
    (row,) = tscaling.run_scaling(S=4, m=20, n=10, iters=20)
    assert row["devices"] == 1 and row["efficiency"] == 1.0
    assert row["iters_per_sec"] > 0


def test_parallel_imports_no_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import epsilon_tpu_torch.parallel, epsilon_tpu_torch.problems.scaling_bench, "
            "epsilon_tpu_torch.interop; "
            "assert not any(k == 'epsilon_tpu' or k.startswith('epsilon_tpu.') "
            "for k in sys.modules)")
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


def test_entry_step_matches_jax_entry(mode):
    """``epsilon_tpu_torch.parallel.entry()`` against ``__graft_entry__.entry()``
    (one consensus epoch, S=4, m=32, n=16, seed 0), in both solve modes.
    The JAX package keeps the float32 data's factors in float32 where the
    port forms them in the solver dtype (float64 here), so the two entries'
    data agree to float32 rounding (rtol 1e-5); the two step functions run
    on the SAME data and initial state agree to rtol 1e-10, and leave rho
    where it was."""
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from epsilon_tpu_torch.parallel import entry
    jfn, (jdata, jstate0) = graft.entry()
    tfn, (data, state) = entry()
    assert set(data) == set(jdata) == ({"L", "Atb"} if mode == "triangular"
                                       else {"Finv", "Atb"})
    for k, v in data.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jdata[k]), rtol=1e-5, atol=1e-6)
    tstate = tfn(data, state)
    jstate = jfn({k: jnp.asarray(v.numpy()) for k, v in data.items()}, jstate0)
    for got, want in zip(tstate[:3], jstate[:3]):
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
    assert float(tstate[3]) == float(jstate[3]) == 1.0
