"""K7's share of its roofline, %: the least time the card could take for
the TV-1D prox's own inputs and outputs at the configuration's n
(:func:`portbench.roofline.tv1d_prox_work`), over K7's device time a call."""

from portbench.roofline import K7_KERNELS, bound_s, is_kernel, tv1d_prox_work


def read(run):
    if run.trace is None:
        return None
    seconds, calls = run.trace.device_time_s(lambda name: is_kernel(name, K7_KERNELS))
    if not calls:
        return None
    n_bytes, ops = tv1d_prox_work(int(run.cell.config["n"]), run.cell.config["dtype"])
    return 100.0 * bound_s(n_bytes, ops, run.cell.config["dtype"]) / (seconds / calls)
