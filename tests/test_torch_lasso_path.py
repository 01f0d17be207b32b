"""The upstream lasso on a lambda path through ``Problem.solve``, lam a
Parameter and each step a warm re-solve on the cached solver, against a
plain reference (``tests/lasso_reference.py``, the feature-sign search);
the benchmark's own reference (``portbench/reference/lasso.py``, FISTA)
against it; and the spans and counters of the host factorization and of
the re-solve's fold and compare (``epsilon_tpu_torch/utils/timing.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import epsilon_tpu_torch as et
import lasso_reference as ref
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.utils import timing
from portbench.problems import lasso as bench_lasso
from portbench.reference import lasso as bench_ref

SIZES = [(60, 200), (150, 500)]
# rel_tol 1e-5, abs_tol 1e-9: the loop stops with x some 1e-4 of the
# path's densest answer away from x* (3.1e-4 the worst seen, 150 x 500)
SOLVE = dict(warm_start=True, rel_tol=1e-5, abs_tol=1e-9)
X_TOL = 2e-3            # ||x - x*|| / ||x*(lambda_min)||: 6x the worst seen
OBJ_TOL = 1e-7          # (F(x) - F*) / F*: F is flat at x*, 8.8e-9 the worst seen


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.reset_counters()
    yield
    timing.reset_counters()
    torch.set_num_threads(prev)


def _data(m, n, seed=3):
    """The upstream generator's recipe (as the benchmark keeps it): A of
    unit-norm columns, x0 sparse, b = A x0 + 0.05 noise."""
    return bench_lasso.regression(m, n, np.random.default_rng(seed),
                                  np.random.default_rng(seed + 1), max(0.01, 2.0 / n), 0.05)


def _path(A, b, count=10):
    return ref.lam_max(A, b) * np.exp(np.linspace(0.0, np.log(0.01), count))


def _problem(A, b, lam):
    """The upstream statement, lam a 1 x 1 Parameter."""
    x = et.Variable(A.shape[1])
    p = et.Parameter(1, 1, value=np.array([[lam]]))
    prob = et.Problem(et.Minimize(et.sum_squares(A * x - b) + p * et.norm1(x)))
    return prob, x, p


@pytest.mark.parametrize("m,n", SIZES)
def test_warm_path_agrees_with_the_reference(m, n):
    A, b = _data(m, n)
    lams = _path(A, b)
    want = ref.lasso_path(A, b, lams)
    scale = np.linalg.norm(want[-1].x)
    prob, x, p = _problem(A, b, lams[0])
    for k, (lam, sol) in enumerate(zip(lams, want)):
        p.value = np.array([[lam]])
        prob.solve(**SOLVE)
        assert prob.status == "optimal"
        got = np.asarray(x.value).ravel()
        assert np.linalg.norm(got - sol.x) / scale <= X_TOL, k
        assert (ref.objective(A, b, lam, got) - sol.primal) / sol.primal <= OBJ_TOL, k
    # the path went from x* = 0 to a dense answer
    assert not want[0].x.any() and np.count_nonzero(want[-1].x) >= 10


@pytest.mark.parametrize("m,n", SIZES)
@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_above_lambda_max_the_answer_is_zero(m, n, factor):
    A, b = _data(m, n)
    lam = factor * ref.lam_max(A, b)
    sol = ref.lasso_fss(A, b, lam)
    assert not sol.x.any() and sol.primal == pytest.approx(float(b @ b))
    prob, x, _ = _problem(A, b, lam)
    prob.solve(**SOLVE)
    # the soft threshold of the norm-1 prox returns exact zeros
    assert np.abs(np.asarray(x.value)).max() <= 1e-12
    # just under lambda_max one coordinate leaves zero
    below = ref.lasso_fss(A, b, 0.99 * ref.lam_max(A, b))
    assert np.count_nonzero(below.x) == 1


@pytest.mark.parametrize("m,n", SIZES)
def test_reference_certifies_its_answers(m, n):
    A, b = _data(m, n)
    for lam, sol in zip(_path(A, b), ref.lasso_path(A, b, _path(A, b))):
        assert sol.primal - sol.dual <= 1e-11 * sol.primal
        assert sol.dual <= sol.primal + 1e-12 * sol.primal
        # KKT: A^T nu = lam sign(x) on the support, |A^T nu| <= lam off it
        g = A.T @ sol.nu
        on = sol.x != 0
        assert np.allclose(g[on], lam * np.sign(sol.x[on]), rtol=0, atol=1e-9 * lam)
        assert np.abs(g[~on]).max(initial=0.0) <= lam * (1 + 1e-9)
        # and moving off the answer only raises F
        rng = np.random.default_rng(0)
        for _ in range(3):
            d = rng.standard_normal(A.shape[1]) * 1e-4
            assert ref.objective(A, b, lam, sol.x + d) >= sol.primal


@pytest.mark.parametrize("m,n", SIZES)
def test_the_benchmark_reference_agrees(m, n):
    A, b = _data(m, n, seed=11)
    lam = 0.05 * ref.lam_max(A, b)
    want = ref.lasso_fss(A, b, lam)
    got = bench_ref.lasso(torch.tensor(A), torch.tensor(b), lam)
    assert got.primal - got.dual <= 1e-10 * got.primal
    assert np.linalg.norm(got.x.numpy() - want.x) <= 1e-8 * np.linalg.norm(want.x)
    assert got.primal == pytest.approx(want.primal, rel=1e-10)


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("epsilon.")]


def _within(spans, outer, name):
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


def test_factor_span_and_rebuild_counters():
    m, n = 60, 200
    A, b = _data(m, n)
    lams = _path(A, b, 4)
    prob, _, p = _problem(A, b, lams[0])
    counts = []

    def cold_then_warm():
        prob.solve(**SOLVE)
        counts.append(timing.counters())
        for lam in lams[1:]:
            p.value = np.array([[lam]])
            prob.solve(**SOLVE)
            counts.append(timing.counters())

    spans = _spans(cold_then_warm)
    solves = sorted((s for s in spans if s[0] == "epsilon.solve"), key=lambda s: s[1])
    assert len(solves) == len(lams)
    # the cold build factors its two KKT systems (the sum of squares' and
    # the constraint's projection) inside the set-up; a warm step none
    setup = _within(spans, solves[0], "epsilon.solver_setup")
    assert len(setup) == 1 and len(_within(spans, setup[0], "epsilon.factor")) == 2
    assert all(not _within(spans, s, "epsilon.factor") for s in solves[1:])
    # each solve folds A again; each warm step compares it and rebuilds
    # the one term whose lam changed
    a_bytes = A.size * tconfig.default_np_dtype().itemsize
    folded = [c["compile.folded_bytes"] for c in counts]
    assert folded[0] >= a_bytes
    assert all(later - before >= a_bytes for before, later in zip(folded, folded[1:]))
    assert "update.compared_bytes" not in counts[0] and "update.rebuilt_terms" not in counts[0]
    for before, later in zip(counts[1:], counts[2:]):
        assert later["update.compared_bytes"] - before["update.compared_bytes"] >= a_bytes
        assert later["update.rebuilt_terms"] - before["update.rebuilt_terms"] == 1
    assert counts[1]["update.rebuilt_terms"] == 1 and counts[1]["update.compared_bytes"] >= a_bytes


def test_factor_span_argument_is_the_largest_pivot():
    A, b = _data(60, 200)
    prob, _, _ = _problem(A, b, 0.1)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        prob.solve(**SOLVE)
    args = [e.concrete_inputs for e in prof.events() if e.name == "epsilon.factor"]
    assert sorted(a[0] for a in args) == [200, 200]


def test_nothing_is_counted_without_a_profiler():
    A, b = _data(60, 200)
    lams = _path(A, b, 3)
    prob, _, p = _problem(A, b, lams[0])
    prob.solve(**SOLVE)
    for lam in lams[1:]:
        p.value = np.array([[lam]])
        prob.solve(**SOLVE)
    assert timing.counters() == {}
