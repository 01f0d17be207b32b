"""Host calls that wait for the device (stream, device or event
synchronize; a synchronous copy), an ADMM iteration of the profiled
requests."""

from portbench.trace import HOST_BLOCKING


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    iters = sum(r.iterations for r in run.traced)
    return run.trace.host_count(HOST_BLOCKING) / iters if iters else None
