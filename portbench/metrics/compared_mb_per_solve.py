"""Data the program compares when a cached solver takes new Parameter
values, MB (10^6 bytes) a profiled re-solve: its ``update.compared_bytes``
counter (one side of each array that ``update_problem`` compares), which
counts only while the profiler records (``epsilon_tpu_torch.utils.timing``),
over the profiled requests' ``epsilon.update_problem`` spans (a request
that builds a new problem compares nothing).  A program without the
counter reads as nothing."""

from portbench.program_spans import spans


def read(run):
    try:
        from epsilon_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    if run.trace is None:
        return None
    resolves = len(spans(run.trace, "epsilon.update_problem"))
    total = counters().get("update.compared_bytes")
    return None if total is None or not resolves else total / 1e6 / resolves
