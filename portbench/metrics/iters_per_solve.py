"""ADMM iterations a solve, mean over the window's requests (the program's
``SolverStatus.num_iterations``)."""


def read(run):
    if not run.requests:
        return None
    return sum(r.iterations for r in run.requests) / len(run.requests)
