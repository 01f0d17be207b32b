"""The ADMM loop's host time an iteration, ms: the window's summed
``SolverStatus.timing.solve_usec`` over its summed iterations."""


def read(run):
    iters = sum(r.iterations for r in run.requests)
    return sum(r.solve_usec for r in run.requests) / 1e3 / iters if iters else None
