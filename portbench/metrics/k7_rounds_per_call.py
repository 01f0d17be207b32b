"""PDAS rounds a call of the TV-1D prox (K7 on the card), over the profiled
requests: the program's ``tv1d.rounds`` over its ``tv1d.calls``, counters that
count only while the profiler records (``epsilon_tpu_torch.utils.timing``;
a program without them reads as nothing)."""


def read(run):
    try:
        from epsilon_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    totals = counters() if run.trace is not None else {}
    if not totals.get("tv1d.calls"):
        return None
    return totals.get("tv1d.rounds", 0) / totals["tv1d.calls"]
