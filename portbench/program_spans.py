"""The program's own spans (``epsilon_tpu_torch/utils/timing.py``) as the
metric readers find them: host operations named ``epsilon.*`` on the
trace's clock.  A program without them reads as nothing."""

from __future__ import annotations

LOOP = "epsilon.admm_loop"


def spans(trace, name):
    """The window's host spans ``name``, in order of their start."""
    return sorted((e for e in trace.in_window(trace.host) if e.name == name),
                  key=lambda e: e.start)


def ms_per_request(run, name):
    """The summed length of the spans ``name``, ms a profiled request."""
    if run.trace is None or not run.traced:
        return None
    found = spans(run.trace, name)
    if not found:
        return None
    return sum(e.length for e in found) / 1e3 / len(run.traced)
