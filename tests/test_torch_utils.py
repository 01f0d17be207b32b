"""The port's utilities and host-only modules against the JAX package's:
checkpoint resume for both solvers with the fingerprint and shape refusals,
the serialization round trip read back by both packages, tree/list formats,
errors, graphs, the profiler trace, and the cvxpy bridge on
``tests/cvxpy_mini.py`` and the frozen fixture corpus (compiled problems
equal to rtol 1e-12, objectives to rtol 1e-9)."""

import logging
import os

import numpy as np
import pytest
import torch

import cvxpy_mini

cvxpy_mini.install()
import cvxpy as cp  # noqa: E402  (real cvxpy if installed, else the mini)

import epsilon_tpu as ej  # noqa: E402
import epsilon_tpu_torch as et  # noqa: E402
from epsilon_tpu.compiler import compiler as jcompiler  # noqa: E402
from epsilon_tpu.frontend import cvxpy_bridge as jbridge  # noqa: E402
from epsilon_tpu.frontend import list_format as jlist  # noqa: E402
from epsilon_tpu.frontend import tree_format as jtree  # noqa: E402
from epsilon_tpu.solvers import SolverParams as JParams  # noqa: E402
from epsilon_tpu.solvers import create_solver as jcreate  # noqa: E402
from epsilon_tpu.utils import SolverCheckpointer as JCheckpointer  # noqa: E402
from epsilon_tpu.utils import serialization as jser  # noqa: E402
from epsilon_tpu_torch import config as tconfig  # noqa: E402
from epsilon_tpu_torch import interop  # noqa: E402
from epsilon_tpu_torch.compiler import compiler as tcompiler  # noqa: E402
from epsilon_tpu_torch.error import (EpsilonError, ExpressionError,  # noqa: E402
                                     LinearMapError, ProblemError, SolveError)
from epsilon_tpu_torch.frontend import cvxpy_bridge as tbridge  # noqa: E402
from epsilon_tpu_torch.frontend import expression_vis  # noqa: E402
from epsilon_tpu_torch.frontend import list_format as tlist  # noqa: E402
from epsilon_tpu_torch.frontend import tree_format as ttree  # noqa: E402
from epsilon_tpu_torch.ops.block import BlockVector  # noqa: E402
from epsilon_tpu_torch.solvers import SolverParams as TParams  # noqa: E402
from epsilon_tpu_torch.solvers import create_solver as tcreate  # noqa: E402
from epsilon_tpu_torch.utils import SolverCheckpointer, profile_trace  # noqa: E402
from epsilon_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from epsilon_tpu_torch.utils import serialization as tser  # noqa: E402

import torch_solver_cases as cases  # noqa: E402
from test_cvxpy_bridge import CONSTANT_ATOMS  # noqa: E402
from test_cvxpy_fixtures import FIXTURES, load_fixture  # noqa: E402

TIGHT = dict(rel_tol=1e-6, abs_tol=1e-8, epoch_iterations=10)


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")


# -- checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("solver, adaptive", [
    ("prox_admm_two_block", False), ("prox_admm_two_block", True),
    ("prox_admm", False)], ids=["two_block", "two_block_adaptive", "n_block"])
def test_resume_host_drive_matches_jax(tmp_path, solver, adaptive):
    """A solve cut at 60 iterations (saves every 2 epochs), then a fresh
    solver that resumes: the same saved step, total count, series and
    solution as the JAX package, and the total equals an uninterrupted
    solve's."""
    jprob, tprob = cases.pair("lasso", seed=3)
    kw = dict(TIGHT, drive="host", solver=solver, adaptive_rho=adaptive)
    out = {}
    for name, create, params, ckpt_cls, prob in (
            ("jax", jcreate, JParams, JCheckpointer, jprob),
            ("port", tcreate, TParams, SolverCheckpointer, tprob)):
        d = str(tmp_path / name)
        ck1 = ckpt_cls(d, every_epochs=2)
        s1 = create(prob, params(max_iterations=60, **kw))
        s1.attach_checkpointer(ck1)
        s1.solve()
        assert s1.status.num_iterations == 60
        saved = ck1.latest_step()
        ck1.close()
        ck2 = ckpt_cls(d, every_epochs=2)
        s2 = create(prob, params(max_iterations=5000, **kw))
        s2.attach_checkpointer(ck2)
        x = s2.solve()
        ck2.close()
        out[name] = (saved, s2, x)
    assert out["port"][0] == out["jax"][0] == 60
    cases.assert_same_solve(out["jax"][1], out["port"][1], out["jax"][2], out["port"][2])
    whole = tcreate(tprob, TParams(max_iterations=5000, **kw))
    xw = whole.solve()
    ts = out["port"][1]
    assert ts.status.num_iterations == whole.status.num_iterations
    assert len(ts.status.series) == (ts.status.num_iterations - 60) // 10
    for k in xw.keys():
        np.testing.assert_allclose(out["port"][2][k].numpy(), xw[k].numpy(), atol=1e-12)


def test_resume_device_drive(tmp_path):
    """Device drive: resume at the start, one save at the end, and the
    restored iterations debited from the budget."""
    _, tprob = cases.pair("lasso", seed=4)
    ck = SolverCheckpointer(str(tmp_path / "ck"), every_epochs=1)
    s1 = tcreate(tprob, TParams(max_iterations=50, **TIGHT))
    s1.attach_checkpointer(ck)
    s1.solve()
    assert ck.latest_step() == s1.status.num_iterations == 50
    assert os.listdir(ck.directory) == ["step_50.pt"]
    s2 = tcreate(tprob, TParams(max_iterations=70, **TIGHT))
    s2.attach_checkpointer(ck)
    s2.solve()
    assert s2.status.num_iterations == 70 and len(s2.status.series) == 2
    s3 = tcreate(tprob, TParams(max_iterations=5000, **TIGHT))
    s3.attach_checkpointer(ck)
    s3.solve()
    whole = tcreate(tprob, TParams(max_iterations=5000, **TIGHT))
    whole.solve()
    assert s3.status.state.value == "optimal"
    assert s3.status.num_iterations == whole.status.num_iterations
    assert ck.latest_step() == s3.status.num_iterations


def test_checkpoint_keeps_newest_and_counts_epochs(tmp_path):
    ck = SolverCheckpointer(str(tmp_path / "ck"), every_epochs=3, keep=2)
    state = (BlockVector({"x": torch.zeros(3)}), BlockVector({"x": torch.ones(3)}))
    assert ck.latest_step() is None and ck.restore(state) == (None, 0)
    saves = [ck.maybe_save(10 * (i + 1), state) for i in range(12)]
    assert saves == [False, False, True] * 4
    assert sorted(os.listdir(ck.directory)) == ["step_120.pt", "step_90.pt"]
    restored, step = ck.restore(state)
    assert step == 120 and torch.equal(restored[1]["x"], torch.ones(3))
    assert not [f for f in os.listdir(ck.directory) if f.endswith(".tmp")]


def test_checkpoint_state_round_trip_with_rho_and_kernel_state(tmp_path):
    state = (BlockVector({"b": torch.arange(3.0), "a": torch.ones(2)}),
             BlockVector({"b": torch.zeros(3), "a": -torch.ones(2)}),
             torch.tensor(2.5, dtype=torch.float64),
             (None, torch.arange(4.0)))
    ck = SolverCheckpointer(str(tmp_path / "ck"))
    ck.save(30, state)
    like = (BlockVector({"b": torch.zeros(3), "a": torch.zeros(2)}),
            BlockVector({"b": torch.zeros(3), "a": torch.zeros(2)}),
            torch.tensor(0.0, dtype=torch.float64), (None, torch.zeros(4)))
    got, step = ck.restore(like)
    assert step == 30 and float(got[2]) == 2.5 and got[3][0] is None
    assert list(got[0].keys()) == ["b", "a"]
    assert torch.equal(got[0]["b"], torch.arange(3.0))
    assert torch.equal(got[1]["a"], -torch.ones(2))
    assert torch.equal(got[3][1], torch.arange(4.0))


def test_shape_mismatch_starts_fresh(tmp_path, caplog):
    """A checkpoint of another problem shape is ignored, with a warning."""
    _, p1 = cases.pair("lasso", seed=3)
    _, p2 = cases.pair("lasso", seed=5, m=20, n=8)
    ck = SolverCheckpointer(str(tmp_path / "ck"), every_epochs=1)
    s1 = tcreate(p1, TParams(max_iterations=20, drive="host", **TIGHT))
    s1.attach_checkpointer(ck)
    s1.solve()
    s2 = tcreate(p2, TParams(max_iterations=5000, drive="host", **TIGHT))
    s2.attach_checkpointer(SolverCheckpointer(str(tmp_path / "ck"), every_epochs=1000))
    with caplog.at_level(logging.WARNING, logger="epsilon_tpu_torch"):
        x = s2.solve()
    assert "starting from iteration 0" in caplog.text
    fresh = tcreate(p2, TParams(max_iterations=5000, drive="host", **TIGHT))
    xf = fresh.solve()
    assert s2.status.num_iterations == fresh.status.num_iterations
    np.testing.assert_allclose(x["x"].numpy(), xf["x"].numpy(), atol=1e-12)


def test_fingerprint_refuses_other_problem_with_equal_shapes(tmp_path, caplog):
    """Equal shapes and dtypes under other key names: refused."""
    a = (BlockVector({"x": torch.zeros(4)}), BlockVector({"x": torch.zeros(4)}))
    b = (BlockVector({"w": torch.zeros(4)}), BlockVector({"w": torch.zeros(4)}))
    assert tckpt._state_fingerprint(a) != tckpt._state_fingerprint(b)
    assert tckpt._state_fingerprint(a) == tckpt._state_fingerprint(
        (BlockVector({"x": torch.ones(4)}), BlockVector({"x": torch.ones(4)})))
    ck = SolverCheckpointer(str(tmp_path / "ck"))
    ck.save(10, a)
    with caplog.at_level(logging.WARNING, logger="epsilon_tpu_torch"):
        assert ck.restore(b) == (None, 0)
    assert "fingerprint mismatch" in caplog.text
    # an adaptive state against a fixed-rho one: another structure
    c = a + (torch.tensor(1.0),)
    assert ck.restore(c) == (None, 0)
    # an unreadable file: refused with a warning, not raised
    with open(os.path.join(ck.directory, "step_20.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    assert ck.restore(a) == (None, 0)


# -- serialization -----------------------------------------------------------

def _compiled_lasso(ep, compiler):
    rng = np.random.RandomState(0)
    A, b = rng.randn(12, 6), rng.randn(12)
    x = ep.Variable(6)
    prob = ep.Problem(ep.Minimize(
        0.5 * ep.sum_squares(ep._wrap(A) * x - b) + 0.3 * ep.norm1(x)))
    return compiler.compile_problem(prob.expression_problem())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serialization_round_trip_read_by_both(tmp_path, writer):
    """Either package writes; both read the file back and solve it to the
    solution of the problem in memory."""
    params = dict(rel_tol=1e-6, abs_tol=1e-9)
    path = str(tmp_path / "lasso")
    if writer == "jax":
        p = _compiled_lasso(ej, jcompiler)
        jser.write_problem(p, path)
        x_mem = {k: np.asarray(v) for k, v in jcreate(p, JParams(**params)).solve().items()}
    else:
        p = _compiled_lasso(et, tcompiler)
        tser.write_problem(p, path)
        x_mem = {k: v.numpy() for k, v in tcreate(p, TParams(**params)).solve().items()}
    pt, pj = tser.read_problem(path), jser.read_problem(path)
    cases.assert_problems_equal(pt, pj)
    cases.assert_problems_equal(pt, p)
    xt = tcreate(pt, TParams(**params)).solve()
    xj = jcreate(pj, JParams(**params)).solve()
    for k, v in x_mem.items():
        np.testing.assert_allclose(xt[k].numpy(), v, atol=1e-8)
        np.testing.assert_allclose(np.asarray(xj[k]), v, atol=1e-8)


def test_serialization_keeps_every_operator_kind(tmp_path):
    import scipy.sparse as sp
    from epsilon_tpu_torch.ir import (AffineOperator, Cone, ConeConstraint,
                                      ProxFunctionSpec, ProxKind, ProxProblem,
                                      ProxTerm, arg_key)
    from epsilon_tpu_torch.ops import linop
    from epsilon_tpu_torch.ops.block import BlockMatrix
    rng = np.random.RandomState(1)
    S = sp.random(200, 300, density=0.001, random_state=1, format="csr")
    ops = {"s": linop.scalar(2.0, 4), "d": linop.diagonal(rng.rand(4)),
           "k": linop.KronOp(linop.dense(rng.randn(2, 2)), linop.identity(2)),
           "sp": linop.sparse(S), "de": linop.dense(rng.randn(4, 4))}
    terms = [ProxTerm(ProxFunctionSpec(
        kind=ProxKind.SUM_QUANTILE, alpha=1.5, arg_sizes=[(4, 1)],
        scaled_zone_params=dict(alpha=np.full(4, 0.7), beta=np.full(4, 0.3), C=0.0, M=0.0)),
        AffineOperator(BlockMatrix({(arg_key(0), "x"): ops["d"]}),
                       BlockVector({arg_key(0): rng.randn(4)})))]
    cons = [ConeConstraint(Cone.ZERO, AffineOperator(
        BlockMatrix({("r", n): op for n, op in ops.items()}), BlockVector()))]
    p = ProxProblem(terms=terms, constraints=cons,
                    var_dims={"x": 4, "s": 4, "d": 4, "k": 4, "sp": 300, "de": 4},
                    var_shapes={"x": (4, 1)})
    path = str(tmp_path / "all")
    tser.write_problem(p, path)
    q = tser.read_problem(path)
    cases.assert_problems_equal(q, p)
    kinds = {n: type(op).__name__ for (_, n), op in q.constraints[0].op.A.blocks.items()}
    assert kinds == dict(s="ScalarOp", d="DiagonalOp", k="KronOp", sp="SparseOp",
                         de="DenseOp")
    assert q.var_shapes == {"x": (4, 1)}


# -- formats, errors, graphs, timing ------------------------------------------

def _expr(ep):
    rng = np.random.RandomState(2)
    x = ep.Variable(4, name="var:x")
    return ep.sum_squares(ep._wrap(rng.randn(3, 4)) * x - rng.randn(3)) + ep.norm1(x)


def test_tree_and_list_formats_match_jax():
    et_, ej_ = _expr(et), _expr(ej)
    txt = ttree.format_expr(et_)
    assert txt == jtree.format_expr(ej_)
    assert "add" in txt and "norm_p" in txt and "variable" in txt
    assert ttree.list_format(et_) == jtree.list_format(ej_)
    assert tlist.expression(et_) == jlist.expression(ej_)
    pt = et.Problem(et.Minimize(et_), []).expression_problem()
    pj = ej.Problem(ej.Minimize(ej_), []).expression_problem()
    assert tlist.format_problem(pt) == jlist.format_problem(pj)


def test_errors_pretty_print():
    x = et.Variable(3)
    err = ExpressionError("bad expr", et.norm1(x))
    assert "bad expr" in str(err) and "norm_p" in str(err)
    for cls in (ProblemError, ExpressionError, LinearMapError, SolveError):
        assert issubclass(cls, EpsilonError)
    assert "oops" in str(ProblemError("oops"))
    compiled = _compiled_lasso(et, tcompiler)
    assert "norm_1" in str(ProblemError("with problem", compiled)).lower()


def test_expression_vis_dot(tmp_path):
    from epsilon_tpu.frontend import expression_vis as jvis
    dot = expression_vis.to_dot(_expr(et))
    assert dot == jvis.to_dot(_expr(ej))
    assert dot.startswith("digraph") and "norm_p" in dot
    p = tmp_path / "e.dot"
    expression_vis.write_dot(_expr(et), str(p))
    assert p.read_text() == dot


def test_benchmark_graphs(tmp_path):
    pytest.importorskip("matplotlib")
    from epsilon_tpu_torch.problems import benchmark_graph
    results = [dict(name="lasso", time=1.0, objective=2.0),
               dict(name="qp", time=0.5, objective=1.0)]
    p1 = benchmark_graph.plot_results(results, str(tmp_path / "bars.png"))
    p2 = benchmark_graph.plot_scaling([10, 100], [0.1, 0.5], str(tmp_path / "scale.png"))
    assert os.path.exists(p1) and os.path.exists(p2)


def test_timing_helpers_and_profile_trace(tmp_path):
    _, tprob = cases.pair("lasso")
    with profile_trace(str(tmp_path / "trace")) as prof:
        tcreate(tprob, TParams(max_iterations=10)).solve()
    import json
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the port's own spans are in the trace too
    assert any(e.get("name") == "epsilon.admm_loop" for e in events)
    assert len(prof.key_averages()) > 0


# -- cvxpy bridge --------------------------------------------------------------

def test_bridge_is_available():
    assert tbridge.cvxpy_available()


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p)[:-5] for p in FIXTURES])
def test_fixture_compiles_and_solves_like_jax(path):
    """The frozen cvxpy-AST corpus through both bridges: equal compiled
    problems, then equal objectives and written-back values."""
    (prob_j, _, _), (prob_t, spec, _) = load_fixture(path), load_fixture(path)
    nat_j, _ = jbridge.convert_problem(prob_j)
    nat_t, _ = tbridge.convert_problem(prob_t)
    cases.assert_problems_equal(tcompiler.compile_problem(nat_t),
                                jcompiler.compile_problem(nat_j))
    kw = dict(rel_tol=1e-5, abs_tol=1e-8, max_iterations=20000)
    obj_j, obj_t = jbridge.solve(prob_j, **kw), tbridge.solve(prob_t, **kw)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-9, atol=1e-12)
    for vj, vt in zip(prob_j.variables(), prob_t.variables()):
        np.testing.assert_allclose(np.asarray(vt.value), np.asarray(vj.value), atol=1e-8)


def test_bridge_lasso_maximize_and_parameter():
    rng = np.random.RandomState(0)
    A, b = rng.randn(20, 10), rng.randn(20)
    x = cp.Variable(10)
    prob = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b) + 0.5 * cp.norm1(x)))
    obj = tbridge.solve(prob, rel_tol=1e-6, abs_tol=1e-9, max_iterations=5000)
    xv = np.asarray(x.value).ravel()
    np.testing.assert_allclose(
        obj, 0.5 * np.sum((A @ xv - b) ** 2) + 0.5 * np.abs(xv).sum(), rtol=1e-3, atol=1e-4)
    c = np.array([1.0, -2.0, 3.0])
    y = cp.Variable(3)
    pmax = cp.Problem(cp.Maximize(-cp.sum_squares(y - c)), [cp.Sum(y) == 0.0])
    got = tbridge.solve(pmax, rel_tol=1e-7, abs_tol=1e-9)
    want = c - c.mean()
    np.testing.assert_allclose(np.asarray(y.value).ravel(), want, atol=1e-4)
    np.testing.assert_allclose(got, -np.sum((want - c) ** 2), atol=1e-4)
    p = cp.Parameter((2,))
    p.value = np.array([1.0, 2.0])
    z = cp.Variable(2)
    tbridge.solve(cp.Problem(cp.Minimize(cp.sum_squares(z - p))), rel_tol=1e-7, abs_tol=1e-9)
    np.testing.assert_allclose(np.asarray(z.value).ravel(), [1.0, 2.0], atol=1e-4)


@pytest.mark.parametrize("name,make", CONSTANT_ATOMS, ids=[n for n, _ in CONSTANT_ATOMS])
def test_constant_atom_through_bridge(name, make):
    """Every supported atom at constants through bridge, compiler and
    solver: the frontend's own numeric value at 1e-2, as the JAX package's
    test holds it."""
    expr = make()
    expected = float(np.sum(np.asarray(expr.value)))
    if np.ndim(expr.value) > 0 and np.size(expr.value) > 1:
        expr = cp.Sum(expr)
    obj = tbridge.solve(cp.Problem(cp.Minimize(expr)), rel_tol=1e-6, abs_tol=1e-9,
                        max_iterations=4000)
    np.testing.assert_allclose(obj, expected, rtol=1e-2, atol=1e-2)
