"""The readers of the program's spans and counters on a synthetic trace:
their arithmetic, and nothing read where the program has no such span or
counter (the parent commit's program, a run without a trace)."""

import pytest

from portbench import spec, trace
from portbench.harness import Run
from portbench.kinds._common import Request

E = trace.Event
SPAN_READERS = {"compile_ms": "epsilon.compile", "rebuild_ms": "epsilon.update_problem",
                "writeback_ms": "epsilon.write_back"}


def _run(host, device=(), iterations=(20, 20)):
    traced = [Request(i, 0, 0.0, iterations=n) for i, n in enumerate(iterations)]
    return Run(cell=None, requests=list(traced), traced=traced,
               trace=trace.Trace((0.0, 1000.0), list(device), list(host)))


def _program_trace():
    """Two requests: each a solve whose loop runs 100 us, the device busy
    60 us of the first loop and 30 of the second."""
    host = [E("epsilon.solve", 0, 400), E("epsilon.compile", 10, 60),
            E("epsilon.update_problem", 60, 90),
            E("epsilon.admm_loop", 100, 200), E("epsilon.write_back", 200, 230),
            E("cudaStreamSynchronize", 150, 160), E("cudaStreamSynchronize", 190, 200),
            E("cudaMemcpy", 210, 220),
            E("epsilon.solve", 500, 900), E("epsilon.compile", 510, 530),
            E("epsilon.admm_loop", 600, 700), E("epsilon.write_back", 700, 705),
            E("cudaStreamSynchronize", 650, 655)]
    device = [E("k", 110, 150), E("k", 140, 170), E("k", 605, 635), E("k", 700, 720)]
    return host, device


@pytest.mark.parametrize("name,expected", [("compile_ms", 0.035), ("rebuild_ms", 0.015),
                                           ("writeback_ms", 0.0175)])
def test_span_lengths_per_profiled_request(name, expected):
    host, device = _program_trace()
    assert spec.metric_reader(name)(_run(host, device)) == pytest.approx(expected)


def test_loop_idle_share_and_syncs():
    host, device = _program_trace()
    run = _run(host, device)
    # busy 60 + 30 of 200 us inside the loops
    assert spec.metric_reader("loop_idle_pct")(run) == pytest.approx(55.0)
    # three waits inside the loops (the one in the write-back is not), 40 iterations
    assert spec.metric_reader("loop_syncs_per_iter")(run) == pytest.approx(3 / 40)


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + ["loop_idle_pct", "loop_syncs_per_iter"])
def test_nothing_read_without_the_program_spans(name):
    # the parent's program: only the harness's own span
    host = [E("portbench.solve", 0, 400), E("cudaStreamSynchronize", 150, 160)]
    read = spec.metric_reader(name)
    assert read(_run(host, [E("k", 110, 150)])) is None
    run = _run(host)
    run.trace = None
    assert read(run) is None


@pytest.mark.parametrize("name", ["loop_idle_pct", "loop_syncs_per_iter"])
def test_device_readers_need_device_activity(name):
    host, _ = _program_trace()
    assert spec.metric_reader(name)(_run(host, device=[])) is None


def test_k7_rounds_per_call_reads_the_counters(monkeypatch):
    from epsilon_tpu_torch.utils import timing
    read = spec.metric_reader("k7_rounds_per_call")
    host, device = _program_trace()
    monkeypatch.setattr(timing, "counters", lambda: {"tv1d.calls": 40, "tv1d.rounds": 300})
    assert read(_run(host, device)) == pytest.approx(7.5)
    run = _run(host, device)
    run.trace = None
    assert read(run) is None
    monkeypatch.setattr(timing, "counters", lambda: {"other.calls": 12})
    assert read(_run(host, device)) is None
    # a program without counters
    monkeypatch.delattr(timing, "counters")
    assert read(_run(host, device)) is None
