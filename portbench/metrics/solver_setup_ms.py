"""The solver's set-up, ms, mean over the window's requests: the program's
``SolverStatus.timing.init_usec``.  Only a request that builds a new
solver sets it anew (a cached re-solve keeps the first set-up's value)."""


def read(run):
    if not run.requests:
        return None
    return sum(r.init_usec for r in run.requests) / 1e3 / len(run.requests)
