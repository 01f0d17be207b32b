"""The port's spans and counters (``epsilon_tpu_torch/utils/timing.py``):
their names and nesting in a ``torch.profiler`` trace, their cost with no
profiler (no range is opened, nothing is counted), and the per-part
``SolverStatus.timing`` that the same spans fill."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import epsilon_tpu_torch as et
from epsilon_tpu_torch import config as tconfig
from epsilon_tpu_torch.utils import timing

ROOT_PARTS = {"epsilon.compile", "epsilon.update_problem", "epsilon.solver_setup",
              "epsilon.admm_loop", "epsilon.write_back"}
TWO_BLOCK_LOOP = {"epsilon.x_update", "epsilon.z_update", "epsilon.residuals",
                  "epsilon.prox.sum_square", "epsilon.prox.total_variation_1d"}
N_BLOCK_LOOP = {"epsilon.residuals", "epsilon.prox.sum_square",
                "epsilon.prox.total_variation_1d"}


@pytest.fixture(autouse=True)
def _cpu():
    tconfig.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.reset_counters()
    yield
    timing.reset_counters()
    torch.set_num_threads(prev)


def _tv_problem(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = et.Variable(n)
    b = et.Parameter(n, 1, value=rng.standard_normal(n))
    prob = et.Problem(et.Minimize(0.5 * et.sum_squares(x - b) + 2.0 * et.tv(x)))
    return prob, b, rng


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end, i)
            for i, e in enumerate(prof.events()) if e.name.startswith("epsilon.")]


def _enclosing(spans):
    """Each span's innermost enclosing span (None at the top), by a sweep
    in order of start."""
    out, stack = {}, []
    for s in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] < s[2]:
            stack.pop()
        out[s] = stack[-1] if stack else None
        stack.append(s)
    return out


def _parent(enclosing, child, names):
    """The innermost span among ``names`` that holds ``child``."""
    p = enclosing[child]
    while p is not None and p[0] not in names:
        p = enclosing[p]
    return p[0] if p is not None else None


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


@pytest.mark.parametrize("solver,loop_spans", [("prox_admm_two_block", TWO_BLOCK_LOOP),
                                                ("prox_admm", N_BLOCK_LOOP)])
def test_spans_nest_under_the_solve(solver, loop_spans):
    prob, b, rng = _tv_problem()
    kw = dict(warm_start=True, rel_tol=1e-3, solver=solver)

    def fresh_then_warm():
        prob.solve(**kw)
        b.value = rng.standard_normal(b.size[0])
        prob.solve(**kw)

    spans = _profiled(fresh_then_warm)
    enclosing = _enclosing(spans)
    names = {s[0] for s in spans}
    assert ROOT_PARTS | loop_spans | {"epsilon.solve"} <= names
    assert sum(s[0] == "epsilon.solve" for s in spans) == 2
    for s in spans:
        if s[0] in ROOT_PARTS:
            assert _parent(enclosing, s, {"epsilon.solve"} | ROOT_PARTS) == "epsilon.solve", s
        elif s[0] in {"epsilon.x_update", "epsilon.z_update", "epsilon.residuals"}:
            holder = _parent(enclosing, s, {"epsilon.admm_loop"} | loop_spans)
            assert holder == "epsilon.admm_loop", s
        elif s[0].startswith("epsilon.prox."):
            holder = "epsilon.x_update" if solver == "prox_admm_two_block" else "epsilon.admm_loop"
            assert _parent(enclosing, s, {"epsilon.admm_loop", "epsilon.x_update"}) == holder, s
    # the set-up runs in the fresh solve, the rebuild in the warm one
    first, second = sorted((s for s in spans if s[0] == "epsilon.solve"), key=lambda s: s[1])
    setup = [s for s in spans if s[0] == "epsilon.solver_setup"]
    update = [s for s in spans if s[0] == "epsilon.update_problem"]
    assert len(setup) == 1 and first[1] <= setup[0][1] <= first[2]
    assert len(update) == 1 and second[1] <= update[0][1] <= second[2]


def test_no_profiler_opens_no_range_and_counts_nothing(monkeypatch):
    opened = []
    real = timing._open

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(timing, "_open", counting)
    prob, b, rng = _tv_problem()
    prob.solve(warm_start=True, rel_tol=1e-3)
    b.value = rng.standard_normal(b.size[0])
    prob.solve(warm_start=True, rel_tol=1e-3)
    timing.count("host.items", 3)
    timing.count("device.items", torch.tensor(4))
    assert opened == [] and timing.counters() == {}
    # the same solve under a profiler opens the ranges through the same door
    _profiled(lambda: prob.solve(warm_start=True, rel_tol=1e-3))
    assert "epsilon.solve" in opened and "epsilon.admm_loop" in opened


def test_warm_resolve_reports_its_own_parts():
    prob, b, rng = _tv_problem()
    prob.solve(warm_start=True, rel_tol=1e-3)
    t = prob.solver_status.timing
    assert t.init_usec > 0 and t.update_usec == 0 and t.compile_usec > 0
    assert t.solve_usec > 0 and t.writeback_usec > 0
    assert t.total_usec == (t.compile_usec + t.update_usec + t.init_usec + t.solve_usec
                            + t.writeback_usec)
    b.value = rng.standard_normal(b.size[0])
    prob.solve(warm_start=True, rel_tol=1e-3)
    t = prob.solver_status.timing
    # the cached solver built nothing: no stale set-up from the first solve
    assert t.init_usec == 0 and t.update_usec > 0 and t.compile_usec > 0
    assert t.solve_usec > 0 and t.writeback_usec > 0
    assert t.total_usec == (t.compile_usec + t.update_usec + t.init_usec + t.solve_usec
                            + t.writeback_usec)


@pytest.mark.parametrize("solver", ["prox_admm_two_block", "prox_admm"])
def test_rebuild_for_a_new_rho_reports_its_set_up(solver):
    prob, _, _ = _tv_problem()
    prob.solve(warm_start=True, rel_tol=1e-3, solver=solver)
    prob.solve(warm_start=True, rel_tol=1e-3, solver=solver)
    assert prob.solver_status.timing.init_usec == 0
    spans = _profiled(lambda: prob.solve(warm_start=True, rel_tol=1e-3, rho=2.0,
                                         solver=solver))
    assert prob.solver_status.timing.init_usec > 0
    assert [s[0] for s in spans].count("epsilon.solver_setup") == 1


def test_single_prox_solve_times_its_parts():
    n = 50
    x = et.Variable(n)
    prob = et.Problem(et.Minimize(et.sum_squares(x - np.arange(n, dtype=float))))
    spans = _profiled(lambda: prob.solve())
    np.testing.assert_allclose(np.ravel(x.value), np.arange(n), atol=1e-4)
    t = prob.solver_status.timing
    assert t.compile_usec > 0 and t.init_usec > 0 and t.solve_usec > 0 and t.writeback_usec > 0
    assert t.total_usec == t.compile_usec + t.init_usec + t.solve_usec + t.writeback_usec
    names = {s[0] for s in spans}
    assert {"epsilon.solve", "epsilon.compile", "epsilon.solver_setup",
            "epsilon.prox.sum_square", "epsilon.write_back"} <= names


def test_span_yields_its_host_time():
    with timing.span("epsilon.test") as t:
        time.sleep(0.002)
    assert t.ns >= 2_000_000 and t.usec == t.ns // 1000


def test_counters_add_host_ints_and_device_tensors():
    def counted():
        timing.count("host.items")
        timing.count("host.items", 2)
        timing.count("device.items", torch.tensor(3, dtype=torch.int32))
        timing.count("device.items", torch.tensor(4))

    _profiled(counted)
    assert timing.counters() == {"host.items": 3, "device.items": 7}
    # outside a profiler nothing more is counted
    counted()
    assert timing.counters() == {"host.items": 3, "device.items": 7}


def test_device_counts_fold_into_one_sum(monkeypatch):
    monkeypatch.setattr(timing, "_FOLD", 4)

    def counted():
        for k in range(10):
            timing.count("device.items", torch.tensor(k, dtype=torch.int32))

    _profiled(counted)
    assert len(timing._device_counts[("device.items", torch.device("cpu"))]) < 4
    assert timing.counters() == {"device.items": 45}


def test_tv_prox_counts_its_calls_and_rounds():
    prob, _, _ = _tv_problem()
    _profiled(lambda: prob.solve(rel_tol=1e-3))
    c = timing.counters()
    # one TV prox a sweep, and at least one PDAS round a call; the plain
    # version never runs K7's residue stage
    assert c["tv1d.calls"] == prob.solver_status.num_iterations
    assert c["tv1d.rounds"] >= c["tv1d.calls"]
    assert c["tv1d.residue"] == 0


def test_spectral_prox_runs_under_its_span():
    p = 8
    rng = np.random.default_rng(1)
    F = rng.standard_normal((p, 2 * p))
    S = F @ F.T / (2 * p)
    theta = et.Variable(p, p)
    prob = et.Problem(et.Minimize(et.sum_entries(et.mul_elemwise(S, theta))
                                  - et.log_det(theta) + 0.1 * et.norm1(theta)))
    spans = _profiled(lambda: prob.solve(rel_tol=1e-3))
    assert prob.status == "optimal"
    # one eigh-based prox a sweep, each under the span of its kind
    names = [s[0] for s in spans]
    iters = prob.solver_status.num_iterations
    assert names.count("epsilon.prox.neg_log_det") == iters
    # the loop counts its epochs, none of them replayed on the CPU
    assert timing.counters() == {"admm.epochs": iters // 10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tconfig.set_device("cuda")
    yield
    tconfig.set_device("cpu")


@pytest.mark.cuda
def test_k7_counters_on_the_card(cuda):
    """K7's rounds come back as a device tensor, added up on the card with
    no sync of their own, and its launches with the residue stage are
    counted; the spans' ranges appear on the host."""
    prob, _, _ = _tv_problem(n=100_000)
    prob.solve(rel_tol=1e-3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prob.solve(rel_tol=1e-3)
        torch.cuda.synchronize()
    c = timing.counters()
    assert c["tv1d.calls"] == prob.solver_status.num_iterations
    assert c["tv1d.rounds"] >= c["tv1d.calls"]
    # every launch's plan, with or without the residue stage, is counted
    from epsilon_tpu_torch.ops.kernels import tv1d_pdas
    v = torch.empty(100_000, dtype=torch.float32, device="cuda")
    assert c["tv1d.residue"] == c["tv1d.calls"] * int(tv1d_pdas.plan_for(v).residue)
    host = {e.name for e in prof.events() if e.device_type.name == "CPU"}
    assert {"epsilon.solve", "epsilon.admm_loop", "epsilon.prox.total_variation_1d"} <= host
