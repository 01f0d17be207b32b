"""The port's min-fill elimination order against the JAX package's native
(C++) ``min_fill_order``: exact equality of the order on seeded random block
systems, and of the pivot sequence of the block-Cholesky factor of a
library row's KKT system (``chebyshev``, many keys) built in both
packages."""

import numpy as np
import pytest

from epsilon_tpu import native as jnative
from epsilon_tpu.compiler import compiler as jcompiler
from epsilon_tpu.problems import benchmark as jbench
from epsilon_tpu.solvers import SolverParams as JParams
from epsilon_tpu.solvers import create_solver as jcreate
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch import interop
from epsilon_tpu_torch import native as tnative
from epsilon_tpu_torch.solvers import SolverParams as TParams
from epsilon_tpu_torch.solvers import create_solver as tcreate


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


def _system(seed, n):
    """A symmetric block pattern with per-block nonzero costs; about one
    key in six has no diagonal block."""
    rng = np.random.RandomState(seed)
    dims = rng.randint(1, 400, size=n).astype(np.int64)
    pattern = rng.rand(n, n) < 0.3
    pattern = pattern | pattern.T
    np.fill_diagonal(pattern, rng.rand(n) > 0.15)
    full = np.outer(dims, dims)
    nnz = np.where(pattern, np.maximum(1, (full * rng.rand(n, n)).astype(np.int64)), 0)
    nnz = np.maximum(nnz, nnz.T)
    return nnz.astype(np.int64), dims


@pytest.mark.parametrize("seed", range(12))
def test_order_matches_native_library(seed):
    assert jnative.available(), "the JAX package's native library is part of its tree"
    n = 3 + 3 * seed
    nnz, dims = _system(seed, n)
    want = jnative.min_fill_order(nnz.copy(), dims.copy())
    got = tnative.min_fill_order(nnz, dims)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


def test_order_of_a_chain_and_an_empty_pivot():
    # an arrow: the hub eliminated last; key 1 has no diagonal block
    nnz = np.array([[50, 0, 5, 5], [0, 0, 5, 0], [5, 5, 9, 0], [5, 0, 0, 9]], dtype=np.int64)
    dims = np.array([10, 4, 3, 3], dtype=np.int64)
    np.testing.assert_array_equal(tnative.min_fill_order(nnz, dims),
                                  jnative.min_fill_order(nnz, dims))


def test_chebyshev_kkt_pivots_match_jax():
    inst = next(p for p in jbench.PROBLEMS_REFERENCE() if p.name == "chebyshev")
    prob = jbench.ProblemInstance("chebyshev", inst.create, dict(m=10, n=20)).create_problem()
    jprob = jcompiler.compile_problem(prob.expression_problem())
    js = jcreate(jprob, JParams())
    ts = tcreate(interop.prox_problem_from_numpy(jprob), TParams())
    jpiv = [step[0] for step in js.constr_prox.chol._steps]
    tpiv = [step[0] for step in ts.constr_prox.chol._steps]
    assert len(jpiv) >= 10
    assert tpiv == jpiv
