"""Constant data the program's compiler folds into operators, MB (10^6
bytes) a profiled request: its ``compile.folded_bytes`` counter, which
counts only while the profiler records (``epsilon_tpu_torch.utils.timing``),
over the profiled requests.  A program without the counter reads as
nothing."""


def read(run):
    try:
        from epsilon_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    if run.trace is None or not run.traced:
        return None
    total = counters().get("compile.folded_bytes")
    return None if total is None else total / 1e6 / len(run.traced)
