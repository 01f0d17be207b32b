"""The reader of the loop's CUDA-graph share on the program's counters: its
arithmetic, nothing read where the program does not count ``admm.epochs``
(a version of the port from before the counter) or there is no trace, and
0 in every cell on the CPU, where no epoch is replayed."""

import pytest
import torch

from portbench import spec, trace
from portbench.harness import Run
from portbench.tests.tiny import run_tiny

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


def _run(with_trace=True):
    return Run(cell=None, trace=trace.Trace((0.0, 1.0), [], []) if with_trace else None)


@pytest.mark.parametrize("totals,expected", [
    ({"admm.epochs": 40, "admm.graph_epochs": 39, "admm.graph_captures": 10}, 0.975),
    ({"admm.epochs": 40, "admm.graph_epochs": 10}, 0.25),
    ({"admm.epochs": 40}, 0.0)])
def test_loop_graph_share_reads_the_counters(monkeypatch, totals, expected):
    from epsilon_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counters", lambda: totals)
    assert spec.metric_reader("loop_graph_share")(_run()) == pytest.approx(expected)


@pytest.mark.parametrize("totals", [{}, {"tv1d.calls": 40, "tv1d.rounds": 300},
                                    {"admm.epochs": 0}])
def test_loop_graph_share_reads_nothing_without_its_counter(monkeypatch, totals):
    from epsilon_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counters", lambda: totals)
    read = spec.metric_reader("loop_graph_share")
    assert read(_run()) is None
    assert read(_run(with_trace=False)) is None


@pytest.mark.parametrize("workload", CELLS)
def test_loop_graph_share_is_zero_on_the_cpu(workload):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line, _ = run_tiny(workload, trace=True)
    finally:
        torch.set_num_threads(prev)
    assert line["metrics"]["loop_graph_share"] == {"value": 0.0, "unit": "share"}
