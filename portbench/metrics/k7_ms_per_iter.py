"""Device time of K7, the TV-1D PDAS kernel (any of its builds), ms an ADMM
iteration of the profiled requests."""

from portbench.roofline import K7_KERNELS, is_kernel


def read(run):
    if run.trace is None:
        return None
    seconds, calls = run.trace.device_time_s(lambda name: is_kernel(name, K7_KERNELS))
    iters = sum(r.iterations for r in run.traced)
    return 1e3 * seconds / iters if calls and iters else None
