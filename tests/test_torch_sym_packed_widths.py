"""Which operators send several columns of x (R >= 2) to K2
(``sym_packed``), and on which problems.  On the CPU with the packed path
taken in both packages (the explicit-inverse solve mode and
``SYM_PACKED_MIN_DIM`` lowered in both; the JAX package also needs
``EPSILON_TPU_SYM_PACKED=1``, as ``tests/test_pallas_kernels.py`` forces
its kernel), the widths that
reach each package's ``_sym_packed_apply`` are recorded and the port's
solve (K2's plain version) is held to the JAX package's (the Pallas kernel
in interpret mode):

* the lasso with its KKT collapsed (``_CollapsedKKT``): at set-up the basis
  solve (``BlockCholesky.solve_mat``) sends R = the input dimension through
  the pivot's ``LuFactorOp.matmat``, and the offset solve R = 1;
* the lasso with the collapse off: R = 1 every iteration (the main path on
  the card, 16384 x 8192);
* ``qp``: a collapsed KKT whose 20-dimensional pivot passes the lowered
  gate, R = 20 at set-up;
* ``mnist``: a Kronecker operator whose factor passes it (``KronOp.matvec``
  through ``matmat`` of the factor), R = k = 4 every iteration.
"""

import numpy as np
import pytest
import torch

import epsilon_tpu as ej
import epsilon_tpu_torch as et
from epsilon_tpu import config as jconfig
from epsilon_tpu.ops import linop as jlinop
from epsilon_tpu.ops.prox import operator as jop
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.ops import linop as tlinop
from epsilon_tpu_torch.ops.prox import operator as top

import torch_library_rows as rows

MIN_DIM = 16


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU, one intra-op thread: the solves are long loops of small
    tensor operations, which ran some 100 times slower beside the other
    test workers with eight threads each."""
    tconfig.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def widths(monkeypatch):
    """Take the packed path in both packages; returns the lists of x's
    widths that reach the port's and the JAX package's packed apply (the
    JAX package's once a trace)."""
    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "FACTOR_SOLVE_MODE", "inverse")
        monkeypatch.setattr(cfg, "SYM_PACKED_MIN_DIM", MIN_DIM)
    monkeypatch.setenv("EPSILON_TPU_SYM_PACKED", "1")   # the JAX package's
    seen = {"port": [], "jax": []}
    for key, mod in (("port", tlinop), ("jax", jlinop)):
        real = mod._sym_packed_apply
        monkeypatch.setattr(mod, "_sym_packed_apply",
                            lambda op, X, real=real, key=key:
                            seen[key].append(int(X.shape[1])) or real(op, X))
    return seen


def _lasso(ep, A, b, lam):
    x = ep.Variable(A.shape[1])
    return x, ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + lam * ep.norm1(x)))


def _lasso_case(collapse, monkeypatch):
    """The slice's lasso (bench.py's generator) at 96 x 80 in both
    packages: the same iterations, x within 1e-8, the objective within
    1e-9."""
    if not collapse:
        monkeypatch.setattr(jop, "_COLLAPSE_MAX_ENTRIES", 0.0)
        monkeypatch.setattr(top, "_COLLAPSE_MAX_ENTRIES", 0.0)
    rng = np.random.RandomState(0)
    A = rng.randn(96, 80) / np.sqrt(96)
    x0 = rng.randn(80) * (rng.rand(80) < 0.1)
    b = A @ x0 + 0.01 * rng.randn(96)
    lam = 0.1 * np.abs(A.T @ b).max()
    (xj, pj), (xt, pt) = _lasso(ej, A, b, lam), _lasso(et, A, b, lam)
    settings = dict(rel_tol=1e-3, abs_tol=1e-6, rho=1.0)
    obj_j, obj_t = pj.solve(**settings), pt.solve(**settings)
    assert pt.status == pj.status == "optimal"
    assert pt.solver_status.num_iterations == pj.solver_status.num_iterations
    np.testing.assert_allclose(xt.value, xj.value, rtol=0, atol=1e-8)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-9)
    return pt.solver_status.num_iterations


@pytest.mark.parametrize("case,wide", [("lasso_collapsed", {80}), ("lasso_factored", set()),
                                       ("qp", {20}), ("mnist", {4})])
def test_widths_that_reach_k2(case, wide, widths, monkeypatch):
    """Each case's widths above 1 in both packages, and the port's solve
    held to the JAX package's; the every-iteration paths (the factored
    lasso at R = 1, mnist's Kronecker factor at R = 4) send their width at
    least once an iteration."""
    if case.startswith("lasso"):
        iters = _lasso_case(case == "lasso_collapsed", monkeypatch)
    else:
        rows.check_row(case, monkeypatch)
        iters = None
    port, jax_ = widths["port"], widths["jax"]
    assert {R for R in port if R > 1} == wide
    assert {R for R in jax_ if R > 1} == wide
    assert set(port) == set(jax_)
    if case == "lasso_factored":
        assert port.count(1) >= iters
    if case == "mnist":
        assert port.count(4) >= rows.MAX_ITERATIONS["mnist"]
