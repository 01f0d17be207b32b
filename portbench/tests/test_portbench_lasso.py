"""The lasso configuration's parts: its family's data and lambda grid, its
reference and precision control, and the readers of the program's
factorization span and of its fold and compare counters."""

import itertools

import numpy as np
import pytest
import torch

from portbench import spec, trace
from portbench.harness import Run
from portbench.kinds._common import Request
from portbench.problems import lasso as fam
from portbench.reference import lasso as ref

BIG_SEED = 2**31 + 4321
CFG = {"m": 30, "n": 80, "structure_seed": 0, "noise_seed": 1, "x0_density": 0.05,
       "sigma": 0.05, "reference": {"gap_tol": 1e-10, "max_iterations": 20000,
                                    "control_max_iterations": 3000}}
MIX = {"count": 100, "min_ratio": 0.01}


def _rng(seed):
    return np.random.default_rng(seed)


def test_family_repeats_from_its_seeds_and_the_seed_keeps_the_work():
    a = fam.generate(CFG, MIX, _rng(BIG_SEED))
    b = fam.generate(CFG, MIX, _rng(BIG_SEED))
    for key in a:
        assert np.array_equal(a[key], b[key])
    assert a["A"].shape == (30, 80) and np.allclose(np.linalg.norm(a["A"], axis=0), 1.0)
    others = [fam.generate(CFG, MIX, _rng(BIG_SEED + k)) for k in range(1, 6)]
    assert any(not np.array_equal(a["A"], o["A"]) for o in others)
    base = np.sort(a["A"], axis=1)
    for o in others:
        # one A with its columns permuted, the same b and the same path
        assert np.array_equal(np.sort(o["A"], axis=1), base)
        assert np.array_equal(o["b"], a["b"]) and np.allclose(o["lams"], a["lams"])
    # b = A x0 + sigma times the noise generator's normals
    A1, b1 = fam.regression(50, 300, _rng(0), _rng(1), 0.02, 0.05)
    A0, b0 = fam.regression(50, 300, _rng(0), _rng(1), 0.02, 0.0)
    assert np.array_equal(A1, A0) and np.linalg.norm(b0) > 0
    assert np.allclose(b1 - b0, 0.05 * _rng(1).standard_normal(50))


def test_lambda_grid_is_glmnets():
    data = fam.generate(CFG, MIX, _rng(BIG_SEED))
    lams = data["lams"]
    # nlambda 100, lambda.min.ratio 0.01, log-spaced from lambda_max down
    assert len(lams) == 100
    assert lams[0] == pytest.approx(2.0 * np.abs(data["A"].T @ data["b"]).max())
    assert lams[-1] == pytest.approx(0.01 * lams[0])
    assert np.allclose(lams[1:] / lams[:-1], 0.01 ** (1 / 99))
    inst = fam.instances(CFG, MIX, data)
    assert len(inst) == 100 and inst[7]["lam"].shape == (1, 1) and inst[7]["lam"][0, 0] == lams[7]


def _lasso_by_enumeration(A, b, lam):
    """The lasso's answer on a tiny instance: the one signed support whose
    stationarity solution keeps its signs and whose zeros satisfy
    |2 A_j^T (b - A x)| <= lam."""
    n = A.shape[1]
    for signs in itertools.product((-1.0, 0.0, 1.0), repeat=n):
        s = np.array(signs)
        S = np.flatnonzero(s)
        x = np.zeros(n)
        if S.size:
            AS = A[:, S]
            if np.linalg.matrix_rank(AS) < S.size:
                continue
            x[S] = np.linalg.solve(AS.T @ AS, AS.T @ b - 0.5 * lam * s[S])
            if np.any(np.sign(x[S]) != s[S]):
                continue
        g = 2.0 * A.T @ (b - A @ x)
        if np.all(np.abs(g[s == 0]) <= lam * (1 + 1e-12)):
            return x
    raise AssertionError("no signed support is optimal")


@pytest.mark.parametrize("scale", [1.2, 0.6, 0.2, 0.02])
def test_reference_is_exact_on_a_2x3_instance(scale):
    A = np.array([[1.0, 0.3, -0.5], [0.2, -1.1, 0.7]])
    b = np.array([0.9, -0.4])
    lam = scale * fam.lambda_max(A, b)
    want = _lasso_by_enumeration(A, b, lam)
    got = ref.lasso(torch.tensor(A), torch.tensor(b), lam)
    assert np.allclose(got.x.numpy(), want, atol=1e-12)
    assert got.primal - got.dual <= 1e-10 * got.primal
    r = A @ want - b
    assert got.primal == pytest.approx(r @ r + lam * np.abs(want).sum(), rel=1e-12)


def test_bf16_control_departs_from_the_reference():
    cfg = dict(CFG, m=60, n=200, x0_density=0.02)
    data = fam.generate(cfg, MIX, _rng(BIG_SEED))
    values = fam.instances(cfg, MIX, data)
    chosen = [values[50], values[99]]
    exact = fam.references(cfg, data, chosen, device="cpu")
    low = fam.references(cfg, data, chosen, control=True, device="cpu")
    # the scale is the float64 answer's at the path's last lambda
    assert data["scale"] == pytest.approx(np.linalg.norm(exact[1]))
    for v, e, lo in zip(chosen, exact, low):
        same = fam.compare(cfg, data, v, e, e)
        assert same == {"rel_err": 0.0, "obj_gap": 0.0}
        off = fam.compare(cfg, data, v, lo, e)
        assert off["rel_err"] > 1e-4 and off["obj_gap"] > 1e-7
    bad = fam.compare(cfg, data, chosen[0], np.full(200, np.nan), exact[0])
    assert bad == {"rel_err": np.inf, "obj_gap": np.inf}


E = trace.Event


def _run(host, counts=None, monkeypatch=None, with_trace=True):
    traced = [Request(i, 0, 0.0, iterations=20) for i in range(4)]
    if counts is not None:
        from epsilon_tpu_torch.utils import timing
        monkeypatch.setattr(timing, "counters", lambda: counts)
    return Run(cell=None, requests=list(traced), traced=traced,
               trace=trace.Trace((0.0, 1e6), [], list(host)) if with_trace else None)


# one cold build (a set-up with two factorizations), then three warm steps
HOST = [E("epsilon.solve", 0, 4000), E("epsilon.solver_setup", 100, 3000),
        E("epsilon.factor", 200, 1700), E("epsilon.factor", 1800, 1900),
        E("epsilon.solve", 5000, 6000), E("epsilon.update_problem", 5100, 5200),
        E("epsilon.solve", 7000, 8000), E("epsilon.update_problem", 7100, 7200),
        E("epsilon.solve", 9000, 9900), E("epsilon.update_problem", 9100, 9200)]


def test_factor_ms_reads_the_spans_per_set_up():
    read = spec.metric_reader("factor_ms")
    assert read(_run(HOST)) == pytest.approx(1.6)
    # two set-ups share the four factorizations' time
    assert read(_run(HOST + [E("epsilon.solver_setup", 10000, 10500),
                             E("epsilon.factor", 10100, 10300)])) == pytest.approx(0.9)


def test_counter_readers(monkeypatch):
    counts = {"compile.folded_bytes": 120_000_000, "update.compared_bytes": 90_000_000,
              "update.rebuilt_terms": 3}
    run = _run(HOST, counts, monkeypatch)
    # 4 profiled requests fold 120 MB; 3 re-solves compare 90 MB
    assert spec.metric_reader("folded_mb_per_solve")(run) == pytest.approx(30.0)
    assert spec.metric_reader("compared_mb_per_solve")(run) == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["factor_ms", "folded_mb_per_solve", "compared_mb_per_solve"])
def test_nothing_read_without_the_program_span_or_counter(name, monkeypatch):
    read = spec.metric_reader(name)
    # a program from before these: its other spans and counters only
    host = [e for e in HOST if e.name != "epsilon.factor"]
    assert read(_run(host, {"tv1d.calls": 4}, monkeypatch) if name != "factor_ms"
                else _run(host)) is None
    assert read(_run(HOST, {"tv1d.calls": 4}, monkeypatch, with_trace=False)) is None
    if name != "factor_ms":
        from epsilon_tpu_torch.utils import timing
        monkeypatch.delattr(timing, "counters")
        assert read(_run(HOST)) is None
