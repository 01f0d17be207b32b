"""The reader of K7's residue-stage share on the program's counters: its
arithmetic, and nothing read where the program does not count
``tv1d.residue`` (a version of the port from before the counter) or there
is no trace."""

import pytest

from portbench import spec, trace
from portbench.harness import Run


def _run(with_trace=True):
    return Run(cell=None, trace=trace.Trace((0.0, 1.0), [], []) if with_trace else None)


@pytest.mark.parametrize("totals,expected", [
    ({"tv1d.calls": 40, "tv1d.rounds": 300, "tv1d.residue": 40}, 1.0),
    ({"tv1d.calls": 40, "tv1d.rounds": 300, "tv1d.residue": 10}, 0.25),
    ({"tv1d.calls": 40, "tv1d.rounds": 300, "tv1d.residue": 0}, 0.0)])
def test_k7_residue_share_reads_the_counters(monkeypatch, totals, expected):
    from epsilon_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counters", lambda: totals)
    assert spec.metric_reader("k7_residue_share")(_run()) == pytest.approx(expected)


@pytest.mark.parametrize("totals", [{"tv1d.calls": 40, "tv1d.rounds": 300}, {},
                                    {"tv1d.calls": 0, "tv1d.residue": 0}])
def test_k7_residue_share_reads_nothing_without_its_counter(monkeypatch, totals):
    from epsilon_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counters", lambda: totals)
    read = spec.metric_reader("k7_residue_share")
    assert read(_run()) is None
    assert read(_run(with_trace=False)) is None
