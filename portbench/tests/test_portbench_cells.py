"""Each cell end to end at a tiny size on the CPU: the result line's
shape, and ``correct`` false when the program's answers are broken."""

import math
import time

import pytest
import torch

from portbench import faults, spec
from portbench.tests.tiny import run_tiny

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_prints_the_result_line(workload, trace):
    line, err = run_tiny(workload, trace=trace)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.load_cell(workload)
    wanted = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert wanted[name] == m["unit"] and _finite(m["value"])
    # on the CPU the device readers find nothing to read and stay silent
    device_only = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    expected = set(wanted) - (device_only if trace else set())
    assert set(line["metrics"]) == expected
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    for name, c in line["checks"].items():
        assert _finite(c["value"]) and c["value"] <= c["limit"]
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in line["checks"]]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    line, _ = run_tiny(workload, seconds=0.5)
    assert line["correct"] is False


def test_lambda_path_starts_each_path_with_a_new_problem(monkeypatch):
    """``restart: new_problem``: each request for the path's first lambda
    builds and solves a new Problem; the others re-solve the cached one."""
    import epsilon_tpu_torch as ep

    from portbench import harness
    from portbench.problems import covsel
    from portbench.tests.tiny import tiny_cell

    ep.config.set_device("cpu")
    cell = tiny_cell("covsel_1000.lambda_path")
    cell.traffic["instances"]["count"] = 3
    built = []
    original = covsel.build

    def build(*args, **kwargs):
        built.append(kwargs["parametric"])
        return original(*args, **kwargs)

    monkeypatch.setattr(covsel, "build", build)
    result, checks = harness.run_cell(cell, 2**31 + 21, 1.5, False, time.perf_counter(),
                                      device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    # set-up builds the first path's problem; every later path builds its own
    paths = 1 + (result["attempted"] + 1) // 3
    assert built == [True] * paths and paths >= 2
