"""Host time a request spends outside the solver's loop, ms, mean over the
window's requests: the request's latency less the program's own
``SolverStatus.timing.solve_usec`` (the frontend, the compiler, the
rebuild or the solver's set-up, and the write-back)."""


def read(run):
    if not run.requests:
        return None
    return 1e3 * sum(r.seconds - r.solve_usec / 1e6 for r in run.requests) / len(run.requests)
